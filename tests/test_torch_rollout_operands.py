"""The rollout kernel's prepared operands against the JAX package.

The kernel runs only on the card; what surrounds it runs here: packing the
decoder's weights into the kernel's layout and back, the plain version on
packed operands, and the decoder's own operands.  Weights and inputs come from
numpy and cross to JAX through the port's converter.  Tolerances are those
of ``tests/test_torch_behavior.py``: the packed plain version rounds its
operands to bf16, as the interpret-mode Pallas kernel does, so it meets that
kernel at atol 1e-2 / rtol 1e-2 and the JAX f32 scan at the JAX kernel
test's atol 5e-2 / rtol 1e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import behavior as jbeh

from behavior_driven_video_synthesis_tpu_torch.models import behavior as pbeh
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout as R


def _decoder(K, H, seed=0):
    net = init_random_(pbeh.ResidualBehaviorNet(K, H),
                       np.random.RandomState(seed))
    return net, net.decoder


@pytest.mark.parametrize("H,K", [(8, 5), (16, 51), (64, 48)])
def test_pack_unpack_round_trip(H, K):
    _, d = _decoder(K, H)
    w_ih, w_hh, b_ih, b_hh, w_out, b_out = d.rollout_params()
    ops = R.pack_operands(*d.rollout_params())
    w, bias, wo, bo = ops
    Hp, Kp = R.padded(H), R.padded(K)
    assert w.shape == (4 * H, Hp + Kp) and w.dtype == torch.bfloat16
    assert w.is_contiguous() and bias.dtype == torch.float32
    # padding is zero: columns [H, Hp) and past Hp + K
    assert not w[:, H:Hp].any() and not w[:, Hp + K:].any()
    # row 4u + g is gate g of unit u
    u, g = H - 1, 2
    assert torch.equal(w[4 * u + g, :H], w_hh[g * H + u].bfloat16())
    assert torch.equal(w[4 * u + g, Hp:Hp + K], w_ih[g * H + u].bfloat16())
    assert bias[4 * u + g] == (b_ih + b_hh)[g * H + u]
    back = R.unpack_operands(ops)
    for got, want in zip(back, (w_ih.bfloat16(), w_hh.bfloat16(),
                                (b_ih + b_hh).detach(), w_out.bfloat16(),
                                b_out.detach())):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="H % 8"):
        R.pack_operands(*[torch.zeros(s) for s in (
            (48, 5), (48, 12), (48,), (48,), (5, 12), (5,))])


@pytest.mark.parametrize("Bc,Kc,Hc,Tc", [(3, 5, 8, 6), (2, 51, 16, 3),
                                         (4, 48, 64, 9)])
def test_plain_on_packed_operands_matches_jax(Bc, Kc, Hc, Tc):
    net, d = _decoder(Kc, Hc, seed=1)
    dec = pconv.behavior_net_to_flax(net.state_dict())["decoder"]
    rng = np.random.RandomState(2)
    b = rng.randn(Bc, Hc).astype(np.float32) * 0.5
    x0 = rng.randn(Bc, Kc).astype(np.float32)
    scan = jbeh.decoder_rollout_kernel(dec, jnp.asarray(b), jnp.asarray(x0),
                                       Tc, use_pallas=False)
    pallas = jbeh.decoder_rollout_kernel(dec, jnp.asarray(b),
                                         jnp.asarray(x0), Tc,
                                         use_pallas=True, interpret=True)
    with torch.no_grad():
        out = R.residual_lstm_rollout_prepared_plain(
            torch.from_numpy(b), torch.from_numpy(x0),
            d.rollout_operands(), Tc)
    assert out.shape == (Bc, Tc, Kc) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(out.numpy(), np.asarray(scan), atol=5e-2,
                               rtol=1e-2)


def test_rollout_operands_unpack_to_the_decoders_weights():
    """A decoder's operands hold its weights, the updated ones after an
    in-place update."""
    _, d = _decoder(5, 16)
    with torch.no_grad():
        d.rnn.weight_hh.add_(0.5)
    back = R.unpack_operands(d.rollout_operands())
    r = d.rnn
    for got, want in zip(back, (r.weight_ih.bfloat16(),
                                r.weight_hh.bfloat16(),
                                r.bias_ih + r.bias_hh,
                                d.n_out.weight.bfloat16(), d.n_out.bias)):
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


def test_decoder_rollout_on_cpu_is_the_f32_loop():
    net, d = _decoder(6, 16)
    rng = np.random.RandomState(4)
    b = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    x0 = torch.from_numpy(rng.randn(3, 6).astype(np.float32))
    launches = R.rollout_launches
    builds = pnn.prepared_builds["rollout"]
    with torch.no_grad():
        out = pbeh.decoder_rollout_kernel(d, b, x0, 5)
        ref = R.residual_lstm_rollout_plain(b, x0, *d.rollout_params(), 5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (R.rollout_launches, pnn.prepared_builds["rollout"]) == (
        launches, builds)
    with pytest.raises(ValueError, match="no rollout for device"):
        R.residual_lstm_rollout_prepared(b, x0, d.rollout_operands(), 5)
