"""The port's MT-VAE modules against the JAX package's, on the CPU.

``LSTM(static_steps=T)`` (one (B, D) input fed at each of T steps, the
MT-VAE decoder) against the JAX LSTM: outputs and the gradients of every
input and parameter, to 1e-5; ``FCResnet``; the MTVAE forward in its
posterior, ``transfer`` and ``sample_prior`` modes on the same draws
(``tests/torch_port_mtvae.py``: 9 keypoints, dim 32, z 16, n_cond 3, T=8,
B=4, f32), to 1e-5; the converter both ways and the reference's key set;
and the port's MTVAE at the reference's widths (1024/512), loaded from
``tests/ref_sd_synth.py:mtvae_state_dict`` without ``make_mu``/``cov``,
against the reference's outputs in ``tests/golden/reference_parity.npz``
with every draw zero, to 1e-4 (as ``tests/test_reference_parity.py``
holds the JAX package).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.models.convert import convert_mtvae
from behavior_driven_video_synthesis_tpu.models.probes import (
    FCResnet as JFCResnet)
from behavior_driven_video_synthesis_tpu.ops.recurrent import LSTM as JLSTM

from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models import convert
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.mtvae import MTVAE
from behavior_driven_video_synthesis_tpu_torch.models.probes import FCResnet
from behavior_driven_video_synthesis_tpu_torch.ops.recurrent import LSTM

import torch_port_mtvae as TM
from ref_sd_synth import mtvae_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "reference_parity.npz")


def _close(mine, ref, **tol):
    np.testing.assert_allclose(np.asarray(mine.detach() if isinstance(
        mine, torch.Tensor) else mine), np.asarray(ref), **(tol or TOL))


def _lstm_tree(lstm):
    return {"w_ih": lstm.weight_ih_l0.detach().numpy().T,
            "w_hh": lstm.weight_hh_l0.detach().numpy().T,
            "b_ih": lstm.bias_ih_l0.detach().numpy(),
            "b_hh": lstm.bias_hh_l0.detach().numpy()}


def test_static_steps_lstm_matches_jax_with_gradients():
    B, D, H, T = 4, 16, 32, 8
    rng = np.random.RandomState(0)
    lstm = init_random_(LSTM(D, H), rng)
    x, h0, c0 = (rng.randn(B, n).astype(np.float32) for n in (D, H, H))
    w_out = rng.randn(B, T, H).astype(np.float32)
    w_h, w_c = (rng.randn(B, H).astype(np.float32) for _ in range(2))

    def jloss(params, x, h0, c0):
        hs, (h, c) = JLSTM(H).apply({"params": params}, x,
                                    initial_carry=(h0, c0), static_steps=T)
        return (jnp.sum(hs * w_out) + jnp.sum(h * w_h) + jnp.sum(c * w_c),
                hs)
    (jl, jhs), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        _lstm_tree(lstm), x, h0, c0)

    tx, th0, tc0 = (torch.tensor(a, requires_grad=True) for a in (x, h0, c0))
    hs, (h, c) = lstm(tx, initial_carry=(th0, tc0), static_steps=T)
    loss = (torch.sum(hs * torch.from_numpy(w_out))
            + torch.sum(h * torch.from_numpy(w_h))
            + torch.sum(c * torch.from_numpy(w_c)))
    loss.backward()
    _close(hs, jhs)
    _close(loss, jl)
    jp, jx, jh0, jc0 = jgrads
    for mine, ref in ((tx.grad, jx), (th0.grad, jh0), (tc0.grad, jc0)):
        _close(mine, ref)
    grads = {"w_ih": lstm.weight_ih_l0.grad.T,
             "w_hh": lstm.weight_hh_l0.grad.T,
             "b_ih": lstm.bias_ih_l0.grad, "b_hh": lstm.bias_hh_l0.grad}
    for k, g in grads.items():
        _close(g, jp[k])


def test_static_steps_equals_the_tiled_sequence():
    """Projecting the shared input once is the tiled sequence's LSTM."""
    rng = np.random.RandomState(1)
    lstm = init_random_(LSTM(16, 32), rng)
    x = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    hs, (h, c) = lstm(x, static_steps=5)
    hs_t, (h_t, c_t) = lstm(x[:, None].expand(3, 5, 16))
    torch.testing.assert_close(hs, hs_t, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c, c_t, rtol=1e-6, atol=1e-6)


def test_fc_resnet_matches_jax():
    rng = np.random.RandomState(2)
    net = init_random_(FCResnet(48, 32), rng)
    x = rng.randn(5, 48).astype(np.float32)
    tree = {f"Dense_{i}": {"kernel": getattr(net, n).weight.detach().numpy().T,
                           "bias": getattr(net, n).bias.detach().numpy()}
            for i, n in enumerate(("shortcut", "fc1", "fc2", "fc3"))}
    ref = JFCResnet(out_dim=32).apply({"params": tree}, x)
    _close(net(torch.from_numpy(x)), ref)
    assert set(net.state_dict()) == {f"{n}.{w}" for n in (
        "shortcut", "fc1", "fc2", "fc3") for w in ("weight", "bias")}


@pytest.fixture(scope="module")
def small():
    tree, batch, noise = TM.make_inputs(0)
    model = TM.port_model()
    model.load_state_dict(convert.mtvae_from_flax(tree))
    return tree, batch, noise[0], model


@pytest.mark.parametrize("mode", ["posterior", "transfer", "sample_prior"])
def test_forward_matches_jax(small, mode):
    from torch_port_mtvae import jax_noise_in_order

    tree, batch, draws, model = small
    kw = {"transfer": mode == "transfer",
          "sample_prior": mode == "sample_prior"}
    src, tgt = batch["keypoints"], batch["paired_keypoints"]
    with jax_noise_in_order([draws[k] for k in ("h0", "c0", "z", "cycle")]):
        ref = TM.jax_model().apply({"params": tree}, src, tgt,
                                   rngs={"sample": jax.random.PRNGKey(0)},
                                   **kw)
    with torch.no_grad():
        mine = model(torch.from_numpy(src), torch.from_numpy(tgt),
                     noise={k: torch.from_numpy(v) for k, v in draws.items()},
                     **kw)
    assert mine[0].shape == (TM.B, TM.T - TM.N_COND, TM.K)
    for m, r in zip(mine, ref):
        _close(m, r)


def test_converter_round_trip_and_reference_keys(small):
    tree, _, _, model = small
    sd = convert.mtvae_from_flax(tree)
    assert flatten_tree(convert.mtvae_to_flax(sd)).keys() == \
        flatten_tree(tree).keys()
    for k, v in flatten_tree(convert.mtvae_to_flax(sd)).items():
        np.testing.assert_array_equal(v, flatten_tree(tree)[k], err_msg=k)
    # the reference's keys but its two unused heads, in the JAX layout
    ref_sd = mtvae_state_dict(TM.K)
    kept = {k: v for k, v in ref_sd.items()
            if not k.startswith(("make_mu.", "cov."))}
    assert set(kept) == set(model.state_dict())
    jtree = jax.tree_util.tree_map(np.asarray, convert_mtvae(ref_sd))
    mine = convert.mtvae_to_flax({k: torch.from_numpy(v)
                                  for k, v in kept.items()})
    assert flatten_tree(mine).keys() == flatten_tree(jtree["params"]).keys()
    for k, v in flatten_tree(jtree["params"]).items():
        np.testing.assert_array_equal(flatten_tree(mine)[k], v, err_msg=k)


def test_reference_golden_with_zero_draws():
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files if k.startswith("mtvae/")}
    K = golden["mtvae/in/src"].shape[-1]
    sd = mtvae_state_dict(K, seed=int(golden["mtvae/meta/sd_seed"]))
    model = MTVAE(K, int(golden["mtvae/meta/n_cond"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if not k.startswith(("make_mu.", "cov."))})
    src, tgt = (torch.from_numpy(golden[f"mtvae/in/{k}"])
                for k in ("src", "tgt"))
    zeros = {k: torch.zeros(s) for k, s in
             model.noise_shapes(src.shape[0]).items()}
    with torch.no_grad():
        out_kp, mu, logstd, cycle = model(src, tgt, noise=zeros)
        out_tr, mu_tr, _, cycle_tr = model(src, tgt, transfer=True,
                                           noise=zeros)
    for mine, key in ((mu, "mu"), (logstd, "logstd"), (cycle, "out_cycle"),
                      (out_kp, "out_kp"), (mu_tr, "mu_tr"),
                      (cycle_tr, "cycle_tr"), (out_tr, "out_tr")):
        _close(mine, golden[f"mtvae/out/{key}"], rtol=0, atol=1e-4)
