"""The PyTorch port's behavior net, LSTM and rollout against the JAX package.

Weights and inputs come from numpy; each JAX parameter tree goes through
the port's converter.  Tolerances: 1e-5 where both run the same f32 math;
the Pallas kernel in interpret mode rounds its operands to bf16, so the
port's f32 loop meets it at the JAX test's own atol 5e-2 / rtol 1e-2, and
the port's bf16-operand loop, which rounds the same operands, at 1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.models import behavior as jbeh
from behavior_driven_video_synthesis_tpu.models import convert as jconv
from behavior_driven_video_synthesis_tpu.ops.recurrent import LSTM as JLSTM

from behavior_driven_video_synthesis_tpu_torch.models import behavior as pbeh
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout as R
from behavior_driven_video_synthesis_tpu_torch.ops.recurrent import LSTM

B, T, K, H = 3, 7, 10, 16


def _net(arch="lstm", nin=False, ib=True, seed=0):
    """A numpy-seeded port net and its flax params."""
    net = pbeh.ResidualBehaviorNet(K, H, decoder_arch=arch, use_nin_dec=nin,
                                   information_bottleneck=ib)
    init_random_(net, np.random.RandomState(seed))
    return net, pconv.behavior_net_to_flax(net.state_dict())


def _jax_net(arch="lstm", nin=False, ib=True):
    return jbeh.ResidualBehaviorNet(n_kps=K, dim_hidden_b=H,
                                    decoder_arch=arch, use_nin_dec=nin,
                                    information_bottleneck=ib)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_encoder_matches_jax(rng, with_lengths):
    net, tree = _net()
    x = rng.randn(B, T, K).astype(np.float32)
    lengths = np.array([T, 3, 5]) if with_lengths else None
    jb, jmu, jls, jpre = _jax_net().apply(
        {"params": tree}, jnp.asarray(x), sample=False,
        lengths=None if lengths is None else jnp.asarray(lengths),
        rngs={"sample": jax.random.PRNGKey(0)}, method="infer_b")
    with torch.no_grad():
        _, mu, ls, pre = net.infer_b(
            torch.from_numpy(x),
            lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(mu, jmu, 1e-5)
    _close(ls, jls, 1e-5)
    _close(pre, jpre, 1e-5)


def test_encoder_without_bottleneck(rng):
    net, tree = _net(ib=False)
    x = rng.randn(B, T, K).astype(np.float32)
    jpre = _jax_net(ib=False).apply({"params": tree}, jnp.asarray(x),
                                    method="infer_b")
    with torch.no_grad():
        pre = net.infer_b(torch.from_numpy(x))
    _close(pre, jpre, 1e-5)


def test_lstm_sequences_match_jax(rng):
    lstm = LSTM(K, H)
    init_random_(lstm, rng)
    params = {"w_ih": lstm.weight_ih_l0.detach().numpy().T,
              "w_hh": lstm.weight_hh_l0.detach().numpy().T,
              "b_ih": lstm.bias_ih_l0.detach().numpy(),
              "b_hh": lstm.bias_hh_l0.detach().numpy()}
    x = rng.randn(B, T, K).astype(np.float32)
    h0 = rng.randn(B, H).astype(np.float32)
    c0 = rng.randn(B, H).astype(np.float32)
    jhs, (jh, jc) = JLSTM(H).apply({"params": params}, jnp.asarray(x),
                                   initial_carry=(jnp.asarray(h0),
                                                  jnp.asarray(c0)))
    with torch.no_grad():
        hs, (h, c) = lstm(torch.from_numpy(x), initial_carry=(
            torch.from_numpy(h0), torch.from_numpy(c0)))
    _close(hs, jhs, 1e-5)
    _close(h, jh, 1e-5)
    _close(c, jc, 1e-5)


@pytest.mark.parametrize("arch,nin", [("lstm", False), ("lstm", True),
                                      ("gru", False), ("gru", True)])
def test_decoder_scan_matches_jax(rng, arch, nin):
    net, tree = _net(arch, nin)
    b = rng.randn(B, H).astype(np.float32) * 0.5
    x2 = rng.randn(B, T, K).astype(np.float32)
    jxs, jcs = _jax_net(arch, nin).apply(
        {"params": tree}, jnp.asarray(b), jnp.asarray(x2), 9, start_frame=2,
        method="generate_seq")
    with torch.no_grad():
        xs, cs = net.generate_seq(torch.from_numpy(b), torch.from_numpy(x2),
                                  9, start_frame=2)
    _close(xs, jxs, 1e-5)
    _close(cs, jcs, 1e-5)


def test_full_forward_matches_jax(rng):
    net, tree = _net()
    x1 = rng.randn(B, T, K).astype(np.float32)
    x2 = rng.randn(B, T, K).astype(np.float32)
    jout = _jax_net().apply({"params": tree}, jnp.asarray(x1),
                            jnp.asarray(x2), 5,
                            rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = net(torch.from_numpy(x1), torch.from_numpy(x2), 5)
    # xs/cs depend on the reparametrized sample; compare the deterministic
    # heads and a rollout from the JAX b
    for i in (3, 4, 5):
        _close(out[i], jout[i], 1e-5)
    with torch.no_grad():
        xs, _ = net.generate_seq(torch.from_numpy(np.array(jout[2])),
                                 torch.from_numpy(x2), 5)
    _close(xs, jout[0], 1e-5)


def _rollout_case(rng, H_=H, K_=K, B_=B):
    net = pbeh.ResidualBehaviorNet(K_, H_)
    init_random_(net, rng)
    tree = pconv.behavior_net_to_flax(net.state_dict())
    b = rng.randn(B_, H_).astype(np.float32) * 0.5
    x0 = rng.randn(B_, K_).astype(np.float32)
    return net, tree, b, x0


@pytest.mark.parametrize("Bc,Kc,Hc,Tc", [(3, 10, 16, 7), (1, 51, 32, 1),
                                         (5, 48, 64, 12)])
def test_rollout_plain_matches_jax_scan_and_pallas(rng, Bc, Kc, Hc, Tc):
    net, tree, b, x0 = _rollout_case(rng, Hc, Kc, Bc)
    dec = tree["decoder"]
    scan = jbeh.decoder_rollout_kernel(dec, jnp.asarray(b), jnp.asarray(x0),
                                       Tc, use_pallas=False)
    pallas = jbeh.decoder_rollout_kernel(dec, jnp.asarray(b),
                                         jnp.asarray(x0), Tc,
                                         use_pallas=True, interpret=True)
    d = net.decoder
    args = (torch.from_numpy(b), torch.from_numpy(x0), d.rnn.weight_ih,
            d.rnn.weight_hh, d.rnn.bias_ih, d.rnn.bias_hh, d.n_out.weight,
            d.n_out.bias)
    with torch.no_grad():
        plain = R.residual_lstm_rollout_plain(*args, Tc)
        plain_bf16 = R.residual_lstm_rollout_plain(
            *args, Tc, operand_dtype=torch.bfloat16)
        via_model = pbeh.decoder_rollout_kernel(d, *args[:2], Tc)
    assert plain.shape == (Bc, Tc, Kc)
    _close(plain, scan, 1e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas),
                               atol=5e-2, rtol=1e-2)
    np.testing.assert_allclose(plain_bf16.numpy(), np.asarray(pallas),
                               atol=1e-2, rtol=1e-2)
    # on CPU tensors the wrapper is the f32 loop and launches nothing
    launches = R.rollout_launches
    _close(via_model, plain, 0.0)
    assert R.rollout_launches == launches


def test_rollout_wrapper_rejects_other_devices(rng):
    net, _, b, x0 = _rollout_case(rng)
    d = net.decoder
    meta = [torch.empty(t.shape, device="meta") for t in (
        torch.from_numpy(b), torch.from_numpy(x0), d.rnn.weight_ih,
        d.rnn.weight_hh, d.rnn.bias_ih, d.rnn.bias_hh, d.n_out.weight,
        d.n_out.bias)]
    with pytest.raises(ValueError, match="no rollout for device"):
        R.residual_lstm_rollout(*meta, 3)
    with pytest.raises(ValueError, match="H % 8"):
        R._check(*[torch.zeros(s) for s in (
            (2, 12), (2, 5), (48, 5), (48, 12), (48,), (48,), (5, 12),
            (5,))], 3)
    with pytest.raises(ValueError, match="weight_out"):
        R._check(*[torch.zeros(s) for s in (
            (2, 16), (2, 5), (64, 5), (64, 16), (64,), (64,), (16, 5),
            (5,))], 3)


def test_decoder_rollout_kernel_rejects_gru_and_nin(rng):
    for arch, nin in (("gru", False), ("lstm", True)):
        net, _ = _net(arch, nin)
        with pytest.raises(ValueError, match="LSTM decoders without nin"):
            pbeh.decoder_rollout_kernel(net.decoder, torch.zeros(1, H),
                                        torch.zeros(1, K), 2)


@pytest.mark.parametrize("nin", [False, True])
def test_converter_round_trips_through_jax_converter(nin):
    """The JAX package's torch->flax converter is the oracle: fed the
    port's state dict it must give back the flax tree."""
    net, tree = _net(nin=nin)
    back = jconv.convert_behavior_net(
        {k: v.numpy() for k, v in
         pconv.behavior_net_from_flax(tree).items()})["params"]
    flat_a = pconv.flatten_tree(tree)
    flat_b = pconv.flatten_tree(jax.tree_util.tree_map(np.asarray, back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    net2 = pbeh.ResidualBehaviorNet(K, H, use_nin_dec=nin)
    net2.load_state_dict(pconv.behavior_net_from_flax({"params": tree}),
                         strict=True)
