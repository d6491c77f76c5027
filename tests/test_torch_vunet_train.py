"""The port's VUNet training modules against the JAX package on the CPU.

Numpy-seeded weights go to both packages (the port's converters export
them as flax trees) and the posterior noise is handed to both.  In f32 at
dropout 0: the VunetRNB and the VUNet training forward
(``__call__(train=True)``: imgs, means, logstds), the latent regressor, the
Laplacian pyramid, the losses and the schedules agree within
1e-4 * (1 + max|ref|) (1e-5 for the single-layer modules).  With
``dropout_impl: pallas`` at rate 0 the training forward is the eval one.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.core import schedules as jsched
from behavior_driven_video_synthesis_tpu.models.perceptual import (
    LaplacianPyramidFeatures as JLaplacian)
from behavior_driven_video_synthesis_tpu.models.vunet import (
    VUNet as JVUNet, VunetRegressor as JRegressor)
from behavior_driven_video_synthesis_tpu.ops import nn as jnn
from behavior_driven_video_synthesis_tpu.train import losses as jlosses

from behavior_driven_video_synthesis_tpu_torch.core import schedules
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import (
    init_like_jax_, init_random_)
from behavior_driven_video_synthesis_tpu_torch.models.perceptual import (
    LaplacianPyramidFeatures, perceptual_from_config)
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
    VUNet, VunetRegressor, latent_widths)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.train import losses

from torch_port_slice import jax_noise

S, NF0, NF1, B = 32, 4, 8, 2
NOISE = [(B, 4, 4, NF1), (B, 8, 8, NF1)]


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * (1 + np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    net = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1)
    init_random_(net, rng)
    tree = pconv.vunet_alter_to_flax(net.state_dict())
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    c = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    noise = [rng.randn(*s).astype(np.float32) for s in NOISE]
    return net, tree, x, c, noise


@pytest.mark.parametrize("residual", [False, True])
def test_rnb_train_forward_matches_jax(residual):
    rng = np.random.RandomState(1)
    C = 6
    block = pnn.VunetRNB(C, residual=residual, aux_channels=4,
                         dropout_prob=0.0)
    init_random_(block, rng)
    sd = block.state_dict()
    if residual:
        tree = {"NormConv2d_0": pconv.to_flax(
                    sd, pconv._norm_conv("nin", ("NormConv2d_0",)))[
                    "NormConv2d_0"],
                "NormConv2d_1": pconv.to_flax(
                    sd, pconv._norm_conv("conv", ("NormConv2d_1",)))[
                    "NormConv2d_1"]}
    else:
        tree = pconv.to_flax(sd, pconv._norm_conv("conv", ("NormConv2d_0",)))
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    a = rng.randn(2, 8, 8, 4).astype(np.float32) if residual else None
    jblock = jnn.VunetRNB(channels=C, residual=residual, dropout_prob=0.0)
    ref = jblock.apply({"params": tree}, jnp.asarray(x),
                       None if a is None else jnp.asarray(a), True)
    out = block(_t(x), None if a is None else _t(a), train=True)
    _close(out, ref, 1e-5)


def test_vunet_train_forward_matches_jax(nets):
    net, tree, x, c, noise = nets
    jnet = JVUNet(spatial_size=S, nf_start=NF0, nf_max=NF1, variant="alter")
    fn = jax.jit(partial(jnet.apply, train=True))
    with jax_noise(noise):
        jimgs, jmeans, jlogstds, jps, jact = fn(
            {"params": tree}, jnp.asarray(x), jnp.asarray(c),
            rngs={"sample": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)})
    imgs, means, logstds, ps, act = net(_t(x), _t(c), train=True,
                                        eps=[_t(n) for n in noise])
    _close(imgs, jimgs)
    for a, b in zip(means + logstds, list(jmeans) + list(jlogstds)):
        _close(a, b)
    assert ps == [] and list(jps) == []
    for mine, theirs in zip(act, jact):
        assert len(mine) == len(theirs)
        _close(mine[-1], theirs[-1])


def test_pallas_at_rate_zero_is_the_eval_forward(nets):
    """dropout_impl "pallas" with dropout_prob 0 trains through the same
    function as eval (the kernel is not reached at rate 0)."""
    net, _, x, c, noise = nets
    pallas = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
                   dropout_prob=0.0, dropout_impl="pallas")
    pallas.load_state_dict(net.state_dict())
    eps = [_t(n) for n in noise]
    with torch.no_grad():
        train_imgs, means, _, _, _ = pallas(_t(x), _t(c), train=True,
                                            eps=eps)
        eval_means, _ = net.encode_means(_t(x), eps)
    for a, b in zip(means, eval_means):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert train_imgs.shape == (B, S, S, 3)


@pytest.mark.parametrize("impl", ["flax", "pallas"])
def test_dropout_is_live_in_training_only(nets, impl):
    net, _, x, c, noise = nets
    drop = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
                 dropout_prob=0.3, dropout_impl=impl)
    drop.load_state_dict(net.state_dict())
    eps = [_t(n) for n in noise]
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = drop(_t(x), _t(c), train=True, eps=eps, dropout_generator=g)[0]
        b = drop(_t(x), _t(c), train=True, eps=eps, dropout_generator=g)[0]
        ev = drop(_t(x), _t(c), train=False, eps=eps)[0]
        ref = net(_t(x), _t(c), train=True, eps=eps)[0]
    assert not torch.equal(a, b)
    torch.testing.assert_close(ev, ref, rtol=0, atol=0)


@pytest.mark.parametrize("impl,match", [
    ("packed", "TPU-only mask representations"),
    ("bits", "TPU-only mask representations"),
    ("pallas_sharded", None)])
def test_unported_dropout_impls_raise(nets, impl, match):
    """The TPU-only mask representations raise.  ``pallas_sharded``, ported
    with the multi-device training (A14b), is the ``pallas`` route on a
    rank's shard: without a process group a training step through it
    equals one through ``pallas``, forward and gradients."""
    with pytest.raises(ValueError, match="unknown dropout_impl"):
        pnn.VunetRNB(4, dropout_impl="nope")
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
                  dropout_prob=0.1, dropout_impl=impl)
        return
    net, _, x, c, noise = nets
    eps = [_t(n) for n in noise]
    outs = []
    for route in (impl, "pallas"):
        drop = VUNet(spatial_size=S, nf_start=NF0, nf_max=NF1,
                     dropout_prob=0.3, dropout_impl=route)
        drop.load_state_dict(net.state_dict())
        g = torch.Generator().manual_seed(0)
        imgs = drop(_t(x), _t(c), train=True, eps=eps,
                    dropout_generator=g)[0]
        imgs.float().square().mean().backward()
        outs.append((imgs.detach(), [p.grad for p in drop.parameters()]))
    (a, ga), (b, gb) = outs
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for u, v in zip(ga, gb):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_regressor_matches_jax_and_converts():
    """The JAX regressor pairs kernel latent_widths[i] with the i-th mean
    from the end, so at these sizes the 4x4 map meets the 8x8 kernel and
    adds no features; the port keeps that."""
    rng = np.random.RandomState(2)
    widths = latent_widths(S)
    assert widths == [4, 8]
    reg = VunetRegressor(36, widths, nf_max=NF1)
    init_random_(reg, rng)
    tree = pconv.vunet_regressor_to_flax(reg.state_dict())
    means = [rng.randn(B, w, w, NF1).astype(np.float32) for w in widths]
    jreg = JRegressor(n_out=36, latent_widths=widths, nf_max=NF1)
    jvars = jreg.init(jax.random.PRNGKey(0), [jnp.asarray(m) for m in means])
    assert (jax.tree_util.tree_map(np.shape, jvars["params"])
            == jax.tree_util.tree_map(np.shape, tree))
    ref = jreg.apply({"params": tree}, [jnp.asarray(m) for m in means])
    _close(reg([_t(m) for m in means]), ref, 1e-5)
    back = pconv.vunet_regressor_from_flax(tree)
    for k, v in reg.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_laplacian_pyramid_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    jfeat = JLaplacian()
    ref = jfeat.apply(jfeat.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      jnp.asarray(x))
    out = perceptual_from_config({"training": {"perceptual": "laplacian"}})(
        _t(x))
    assert list(out) == list(ref)
    for k in ref:
        _close(out[k], ref[k], 1e-5)
    # "vgg" is ported (held in tests/test_torch_perceptual_vgg.py)
    vgg = perceptual_from_config({"training": {"perceptual": "vgg"}})
    assert list(vgg(_t(x))) == list(ref)
    assert isinstance(perceptual_from_config(
        {"training": {"perceptual": "laplacian"}}), LaplacianPyramidFeatures)


def test_losses_match_jax():
    rng = np.random.RandomState(4)
    mus = [rng.randn(B, w, w, NF1).astype(np.float32) for w in (4, 8)]
    lss = [rng.rand(B, w, w, NF1).astype(np.float32) for w in (4, 8)]
    _close(losses.compute_kl_with_prior([_t(m) for m in mus],
                                        [_t(s) for s in lss]),
           jlosses.compute_kl_with_prior([jnp.asarray(m) for m in mus],
                                         [jnp.asarray(s) for s in lss]),
           1e-6)
    _close(losses.kl_loss(_t(mus[0][:, 0, 0]), _t(lss[0][:, 0, 0])),
           jlosses.kl_loss(jnp.asarray(mus[0][:, 0, 0]),
                           jnp.asarray(lss[0][:, 0, 0])), 1e-6)
    _close(losses.compute_kl_loss([_t(m) for m in mus],
                                  [_t(s) for s in lss]),
           jlosses.compute_kl_loss([jnp.asarray(m) for m in mus],
                                   [jnp.asarray(s) for s in lss]), 1e-6)
    ft = {k: rng.randn(B, 5, 5, 2).astype(np.float32) for k in "abc"}
    fp = {k: rng.randn(B, 5, 5, 2).astype(np.float32) for k in "abc"}
    got = losses.vgg_loss({k: _t(v) for k, v in ft.items()},
                          {k: _t(v) for k, v in fp.items()}, [1.0, 0.5, 2.0])
    ref = jlosses.vgg_loss({k: jnp.asarray(v) for k, v in ft.items()},
                           {k: jnp.asarray(v) for k, v in fp.items()},
                           [1.0, 0.5, 2.0])
    for k in ref:
        _close(got[k], ref[k], 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kl_with_prior_in_bf16_matches_jax(seed):
    """A bf16 VUNet's latents: the JAX step takes the KL in bf16, so the
    port's KL is bf16 and equal to it (an f32 KL differs by ~0.5 %)."""
    rng = np.random.RandomState(seed)
    mus = [rng.randn(3, w, w, 16).astype(np.float32) for w in (4, 8)]
    lss = [rng.rand(3, w, w, 16).astype(np.float32) for w in (4, 8)]
    got = losses.compute_kl_with_prior(
        [_t(m).bfloat16() for m in mus], [_t(s).bfloat16() for s in lss])
    ref = jlosses.compute_kl_with_prior(
        [jnp.asarray(m, jnp.bfloat16) for m in mus],
        [jnp.asarray(s, jnp.bfloat16) for s in lss])
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert float(got) == float(ref)


@pytest.mark.parametrize("mode", ["none", "ascend", "descend"])
def test_schedules_match_jax(mode):
    for step in (0, 3, 7, 10, 12):
        assert np.isclose(float(schedules.imax_schedule(step, 10, 50.0,
                                                        mode)),
                          float(jsched.imax_schedule(step, 10, 50.0, mode)))
    for gamma, kl in ((0.0, 80.0), (0.5, 10.0), (0.001, 20.0)):
        ref = float(jsched.update_gamma(gamma, kl, 50.0, 1e-3))
        assert np.isclose(schedules.update_gamma(gamma, kl, 50.0, 1e-3), ref)
        assert np.isclose(float(schedules.update_gamma(
            torch.tensor(gamma), torch.tensor(kl), 50.0, 1e-3)), ref)
    assert float(schedules.linear_var(5, 0, 10, 0.0, 1.0, 0.0, 0.3)) == 0.3


def test_init_like_jax_matches_flax_initializers():
    """he_normal v with g = |v| and unit gamma in the VUNet, lecun_normal
    in the regressor: the same distributions as the flax initializers
    (moments over all the VUNet's 3x3 kernels), with the weight norm
    making each initial kernel equal to v."""
    net = VUNet(spatial_size=64, nf_start=16, nf_max=32)
    init_like_jax_(net, torch.Generator().manual_seed(0))
    conv = net.dd.blocks[0].conv
    v = conv.conv.weight_v.detach()
    torch.testing.assert_close(conv.kernel().detach(), v, rtol=1e-6,
                               atol=1e-7)
    assert torch.all(conv.gamma == 1) and torch.all(conv.beta == 0)
    fan_in = v[0].numel()
    jv = jax.nn.initializers.he_normal(in_axis=(0, 1, 2), out_axis=3)(
        jax.random.PRNGKey(0), (3, 3, v.shape[1], v.shape[0]))
    assert abs(float(v.std()) / float(jnp.std(jv)) - 1) < 0.05
    assert abs(float(v.std()) * np.sqrt(fan_in / 2.0) - 1) < 0.05
    assert float(v.abs().max()) <= 2 * np.sqrt(2.0 / fan_in) / 0.8796 + 1e-6
    reg = VunetRegressor(36, [4, 8], nf_max=32)
    init_like_jax_(reg, torch.Generator().manual_seed(1))
    w = reg.linears[0].weight.detach()
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.05
    assert torch.all(reg.linears[0].bias == 0)
