"""The port's dormant discriminators, layers and helpers against the JAX
package, on the CPU in f32.

``SequenceDisc`` (each input type), ``SequenceDiscConv``, ``MIDisc``,
``MIDiscConv`` (LeakyReLU ``VunetRNB`` blocks of ``L2NormConv2d``),
``ResnetBlock2D``, ``SelfAttention2D`` (with ``beta`` set away from its
initial 0), ``BasicUnConnectedNet`` and ``utils/misc.py``.  Parameters are
drawn from a numpy seed for the port and exported through its converters
(``tests/torch_port_dormant.py``): outputs within a relative L2 of 1e-5,
and every converter round-trips its flax tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.models import discriminators as jd
from behavior_driven_video_synthesis_tpu.ops import nn as jnn
from behavior_driven_video_synthesis_tpu.utils import misc as jmisc

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import (
    discriminators as pd)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.utils import misc as pmisc

from torch_port_dormant import (assert_plan_round_trip, assert_rel,
                                port_variables, t)
from torch_port_threads import one_torch_thread  # noqa: F401


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _check(jm, pm, from_flax, to_flax, seed, *inputs, prepare=None,
           outputs=lambda o: o):
    """The port's outputs on inputs against JAX's, and the converter's
    round trip; returns (port output, JAX output)."""
    jargs = [jnp.asarray(a) for a in inputs]
    variables = port_variables(pm, to_flax, seed, jm, *jargs,
                               prepare=prepare)
    want = jax.jit(jm.apply)(variables, *jargs)
    with torch.no_grad():
        got = pm(*[t(a) for a in inputs])
    for a, b in zip(jax.tree_util.tree_leaves(outputs(got)),
                    jax.tree_util.tree_leaves(outputs(want))):
        assert a.shape == b.shape
        assert_rel(a, b)
    assert_plan_round_trip(variables, from_flax, to_flax, params_only=True)
    return got, want


@pytest.mark.parametrize("input_type", ["poses", "changes", "combined"])
def test_sequence_disc_matches_jax(input_type):
    jm = jd.SequenceDisc(dim_hidden_rnn=16, n_layers_class=2,
                         dim_hidden_class=8, input_type=input_type)
    pm = pd.SequenceDisc(6, dim_hidden_rnn=16, n_layers_class=2,
                         dim_hidden_class=8, input_type=input_type)
    (logit, feats), _ = _check(jm, pm, pconv.sequence_disc_from_flax,
                               pconv.sequence_disc_to_flax, 1,
                               _x((3, 7, 6), 2))
    assert logit.shape == (3, 1) and len(feats) == 3


@pytest.mark.parametrize("use_sigmoid", [True, False])
def test_sequence_disc_conv_matches_jax(use_sigmoid):
    """Stage 1 spans all 6 keypoints x 10 frames at stride 5 (3 positions
    of 20 frames), stage 2 all 3 positions x 3 filters."""
    kw = dict(temp_window=10, temp_stride=5, n_filter=8, n_layers_class=2,
              dim_hidden_class=12, use_sigmoid=use_sigmoid)
    jm = jd.SequenceDiscConv(n_kps=6, seq_len=20, **kw)
    pm = pd.SequenceDiscConv(6, 20, **kw)
    out, _ = _check(jm, pm, pconv.sequence_disc_conv_from_flax,
                    pconv.sequence_disc_conv_to_flax, 3, _x((4, 20, 6), 4))
    assert out.shape == (4, 1)
    assert pm.conv2.weight.shape == (8, 1, 3, 3)
    assert pm.fc[0].in_features == 6 * 8


def test_midisc_matches_jax():
    jm, pm = jd.MIDisc(n_layers=2, hidden_dim=16), pd.MIDisc(10, 2, 16)
    out, _ = _check(jm, pm, pconv.midisc_from_flax, pconv.midisc_to_flax, 5,
                    _x((4, 10), 6))
    assert out.shape == (4, 1)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_midisc_conv_matches_jax(n_layers):
    """LeakyReLU (0.01) through L2NormConv2d blocks; the logit sums the
    (B, 1, 1, C) map over H, W and C."""
    jm = jd.MIDiscConv(n_layers=n_layers, hidden_dim=16)
    pm = pd.MIDiscConv(10, n_layers, 16)
    out, _ = _check(jm, pm, pconv.midisc_conv_from_flax,
                    pconv.midisc_conv_to_flax, 7, _x((4, 10), 8))
    assert out.shape == (4, 1)
    block = pm.blocks[0]
    assert block.act_fn is not None and not block.fused
    v = torch.tensor([-2.0, 3.0])
    np.testing.assert_allclose(block._act(v).numpy(), [-0.02, 3.0])


def test_leaky_rnb_does_not_take_the_elu_kernels(monkeypatch):
    """A VunetRNB with an act_fn under dropout_impl "pallas" drops out
    after its own activation: the ELU+dropout kernel computes an ELU."""
    def no_kernel(*a, **k):
        raise AssertionError("the ELU+dropout kernel was called")
    monkeypatch.setattr(pnn, "elu_dropout", no_kernel)
    block = pnn.VunetRNB(8, kernel_size=1, dropout_prob=0.5,
                         dropout_impl="pallas", conv_layer=pnn.L2NormConv2d,
                         act_fn=lambda v: torch.nn.functional.leaky_relu(
                             v, 0.01))
    torch.nn.init.normal_(block.conv.weight)
    g = torch.Generator().manual_seed(0)
    out = block(torch.randn(2, 1, 1, 8), train=True, generator=g)
    assert out.shape == (2, 1, 1, 8)
    with pytest.raises(AssertionError):
        pnn.VunetRNB(8, dropout_prob=0.5, dropout_impl="pallas")(
            torch.randn(2, 4, 4, 8), train=True, generator=g)


@pytest.mark.parametrize("n_in,n_out,stride", [(16, 24, 2), (16, 16, 1)])
def test_resnet_block_2d_matches_jax(n_in, n_out, stride):
    jm = jd.ResnetBlock2D(n_out=n_out, stride=stride)
    pm = pd.ResnetBlock2D(n_in, n_out, stride=stride)
    out, _ = _check(jm, pm, pconv.resnet_block_2d_from_flax,
                    pconv.resnet_block_2d_to_flax, 9, _x((2, 8, 8, n_in), 10))
    assert out.shape == (2, 8 // stride, 8 // stride, n_out)
    assert (pm.shortcut is None) == (n_in == n_out and stride == 1)
    assert pm.norm1.num_groups == max(1, n_in // 8)
    assert pm.norm2.num_groups == max(1, n_out // 8)
    assert pm.norm1.eps == 1e-5


def test_self_attention_2d_matches_jax():
    """beta set to 0.7 (it starts at 0, where the block is the identity
    whatever it attends to), on a non-square 8 x 6 map: the positions
    flatten row-major and the keys and values are 2x2 max-pooled."""
    jm, pm = jd.SelfAttention2D(down_factor=4), pd.SelfAttention2D(16, 4)
    x = _x((2, 8, 6, 16), 11)

    def beta(m):
        m.beta.fill_(0.7)
    out, want = _check(jm, pm, pconv.self_attention_2d_from_flax,
                       pconv.self_attention_2d_to_flax, 12, x, prepare=beta)
    assert float(np.abs(out.numpy() - x).max()) > 1e-2
    with torch.no_grad():
        pm.beta.zero_()
        np.testing.assert_array_equal(pm(t(x)).numpy(), x)


def test_basic_unconnected_net_matches_jax():
    """Factor-major output: out[b, f * dim + d] depends on x[b, d] alone."""
    jm = jnn.BasicUnConnectedNet(dim=6, depth=2, hidden_dim=16, out_dim=12)
    pm = pnn.BasicUnConnectedNet(6, 2, 16, out_dim=12)
    x = _x((3, 6), 13)
    out, _ = _check(jm, pm, pconv.basic_unconnected_net_from_flax,
                    pconv.basic_unconnected_net_to_flax, 14, x)
    x2 = x.copy()
    x2[:, 2] += 1.0
    with torch.no_grad():
        moved = (pm(t(x2)) != out).any(0).numpy()
    assert np.nonzero(moved)[0].tolist() == [2, 8]
    tanh = pnn.BasicUnConnectedNet(6, 1, 8, use_tanh=True)
    with torch.no_grad():
        assert float(tanh(t(x) * 100).abs().max()) <= 1.0
    with pytest.raises(ValueError):
        pnn.BasicUnConnectedNet(6, 1, 8, out_dim=9)


def test_misc_helpers_match_jax():
    x = _x((2, 5, 3), 15)
    a, b = pmisc.prepare_input(t(x))
    ja, jb = jmisc.prepare_input(jnp.asarray(x))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    img = 1.5 * x
    np.testing.assert_array_equal(pmisc.scale_img(t(img)).numpy(),
                                  np.asarray(jmisc.scale_img(
                                      jnp.asarray(img))))
    for joints in ([np.array([1.0, 2.0]), np.array([0.0, 3.0])],
                   [np.array([1.0, -2.0])]):
        assert pmisc.valid_joints(*joints) == jmisc.valid_joints(*joints)
