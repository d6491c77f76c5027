"""The port's reference loss library and ``linear_decay_lr`` against the
JAX package, on the CPU in f32.

``gan_loss`` (both types), ``hinge_d_loss`` (all modes), ``triplet_loss``,
``feature_matching_loss``, ``weight_decay_loss`` (a module, a state dict,
a list), ``mi_loss_terms`` (an identity disc, and ``MIDisc`` with the
port's weights carried to the JAX module by the converter), ``zoom_loss``
(one small feature pyramid of average pools on both sides) and
``linear_decay_lr`` on inputs drawn from a numpy seed: within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from behavior_driven_video_synthesis_tpu.core import schedules as jsched
from behavior_driven_video_synthesis_tpu.models import discriminators as jd
from behavior_driven_video_synthesis_tpu.train import losses as jl

from behavior_driven_video_synthesis_tpu_torch.core import schedules as psched
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import (
    discriminators as pd)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.train import losses as pl

from torch_port_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("loss_type", ["mse", "vanilla"])
def test_gan_loss_matches_jax(loss_type):
    pred = _x((6, 1), 1) * 3
    target = (np.random.RandomState(2).rand(6, 1) > 0.5).astype(np.float32)
    _close(pl.gan_loss(torch.from_numpy(pred), torch.from_numpy(target),
                       loss_type),
           jl.gan_loss(jnp.asarray(pred), jnp.asarray(target), loss_type))


@pytest.mark.parametrize("mode", ["real", "fake", "gen"])
def test_hinge_d_loss_matches_jax(mode):
    logits = _x((7, 3), 3) * 2
    _close(pl.hinge_d_loss(torch.from_numpy(logits), mode),
           jl.hinge_d_loss(jnp.asarray(logits), mode))


@pytest.mark.parametrize("margin", [0.2, 5.0])
def test_triplet_loss_matches_jax(margin):
    a, p, n = (_x((5, 8), s) for s in (4, 5, 6))
    _close(pl.triplet_loss(*map(torch.from_numpy, (a, p, n)), margin=margin),
           jl.triplet_loss(*map(jnp.asarray, (a, p, n)), margin=margin))


def test_feature_matching_loss_matches_jax():
    shapes = [(2, 4), (2, 3, 5), (2, 6, 6, 2)]
    real = [_x(s, 10 + i) for i, s in enumerate(shapes)]
    fake = [_x(s, 20 + i) for i, s in enumerate(shapes)]
    _close(pl.feature_matching_loss([torch.from_numpy(a) for a in real],
                                    [torch.from_numpy(a) for a in fake]),
           jl.feature_matching_loss([jnp.asarray(a) for a in real],
                                    [jnp.asarray(a) for a in fake]))
    empty = pl.feature_matching_loss([], [])
    assert empty.shape == () and float(empty) == 0.0
    assert float(jl.feature_matching_loss([], [])) == 0.0


def _midisc(seed=5, n_in=10):
    module = pd.MIDisc(n_in, n_layers=2, hidden_dim=16)
    init_random_(module, np.random.RandomState(seed))
    return module.eval()


@pytest.mark.parametrize("form", ["module", "state_dict", "list"])
def test_weight_decay_loss_matches_jax(form):
    """A module's parameters against JAX's sum over the converted tree."""
    module = _midisc()
    tree = pconv.midisc_to_flax(module.state_dict())
    arg = {"module": module, "state_dict": module.state_dict(),
           "list": list(module.parameters())}[form]
    want = jl.weight_decay_loss(
        {k: jnp.asarray(v) for k, v in pconv.flatten_tree(tree).items()})
    _close(pl.weight_decay_loss(arg), want)


@pytest.mark.parametrize("seq_len", [1, 4])
def test_mi_loss_terms_identity_disc_matches_jax(seq_len):
    """An identity disc: the logits pass through, as the JAX package's
    reference test feeds them."""
    joint, marginal = _x((9,), 30) * 2, _x((9,), 31) * 2
    got = pl.mi_loss_terms(lambda t: t, torch.from_numpy(joint),
                           torch.from_numpy(marginal), seq_len=seq_len)
    want = jl.mi_loss_terms(lambda params, t: t, None, jnp.asarray(joint),
                            jnp.asarray(marginal), seq_len=seq_len)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seq_len", [1, 3])
def test_mi_loss_terms_midisc_matches_jax(seq_len):
    """The port's MIDisc and the JAX MIDisc holding the same weights (the
    converter carries them across); the gradient reaches the disc."""
    module = _midisc(seed=7)
    variables = {"params": pconv.midisc_to_flax(module.state_dict())}
    jm = jd.MIDisc(n_layers=2, hidden_dim=16)
    joint, marginal = _x((6, 10), 32), _x((6, 10), 33)
    got = pl.mi_loss_terms(module, torch.from_numpy(joint),
                           torch.from_numpy(marginal), seq_len=seq_len)
    want = jl.mi_loss_terms(jm.apply, variables, jnp.asarray(joint),
                            jnp.asarray(marginal), seq_len=seq_len)
    for g, w in zip(got, want):
        _close(g, w)
    got[0].backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in module.parameters())


def _pools_torch(x):
    """{input, pool2, pool4}: average pools of an NHWC batch."""
    nchw = x.permute(0, 3, 1, 2)
    return {"input": x,
            "pool2": F.avg_pool2d(nchw, 2).permute(0, 2, 3, 1),
            "pool4": F.avg_pool2d(nchw, 4).permute(0, 2, 3, 1)}


def _pools_jax(x):
    def pool(a, k):
        B, H, W, C = a.shape
        return a.reshape(B, H // k, k, W // k, k, C).mean(axis=(2, 4))
    return {"input": x, "pool2": pool(x, 2), "pool4": pool(x, 4)}


@pytest.mark.parametrize("out_size", [8, 16])
def test_zoom_loss_matches_jax(out_size):
    B, H, W, C = 2, 24, 20, 3
    rs = np.random.RandomState(40)
    target = _x((B, out_size, out_size, C), 41)
    pred = _x((B, H, W, C), 42)
    kps = np.stack([rs.uniform(2, W - 3, (B, 6)),
                    rs.uniform(2, H - 3, (B, 6))], -1).astype(np.float32)
    weights = [1.0, 0.5, 2.0]
    got = pl.zoom_loss(_pools_torch, torch.from_numpy(target),
                       torch.from_numpy(pred), torch.from_numpy(kps),
                       out_size, weights)
    want = jl.zoom_loss(_pools_jax, jnp.asarray(target), jnp.asarray(pred),
                        jnp.asarray(kps), out_size, weights)
    assert list(got) == list(want)
    for name in want:
        _close(got[name], want[name])


@pytest.mark.parametrize("step", [0, 100, 150, 200, 250])
def test_linear_decay_lr_matches_jax(step):
    """At 0, start_it, the midpoint, end_it and beyond."""
    got = psched.linear_decay_lr(2e-4, 100, 200)(step)
    want = jsched.linear_decay_lr(2e-4, 100, 200)(step)
    np.testing.assert_allclose(got, float(want), rtol=RTOL, atol=1e-12)


def test_linear_decay_lr_drives_lambda_lr():
    """LambdaLR over schedule / lr_init gives the schedule's rates."""
    lr_init = 1e-3
    schedule = psched.linear_decay_lr(lr_init, 2, 6)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=lr_init)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: schedule(s) / lr_init)
    rates = []
    for _ in range(8):
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(rates, [float(jsched.linear_decay_lr(
        lr_init, 2, 6)(s)) for s in range(8)], rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("case", ["gan_loss", "hinge_d_loss",
                                  "feature_matching_loss"])
def test_loss_library_rejects_what_jax_rejects(case):
    a = np.zeros((3,), np.float32)
    calls = {
        "gan_loss": lambda m, t: m.gan_loss(t(a), t(a), "wgan"),
        "hinge_d_loss": lambda m, t: m.hinge_d_loss(t(a), "both"),
        "feature_matching_loss": lambda m, t: m.feature_matching_loss(
            [t(a), t(a)], [t(a)]),
    }
    for module, to in ((pl, torch.from_numpy), (jl, jnp.asarray)):
        with pytest.raises(ValueError):
            calls[case](module, to)
