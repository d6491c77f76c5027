"""The PyTorch port's NN primitives (ops/nn.py) against the JAX package.

Each case draws its weights into the port's module with numpy, exports
them as the flax subtree the JAX module reads, and compares both on the
same NHWC input in f32: max abs diff <= 1e-5 * (1 + max|ref|).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * (1 + np.abs(ref).max()))


def _tree(module, plan):
    """Random weights for ``module`` as the flax subtree that ``plan``
    (whose state-dict keys start with "x.") maps them to."""
    init_random_(module, np.random.RandomState(3))
    return pconv.to_flax(torch.nn.ModuleDict({"x": module}).state_dict(),
                         plan)


def test_space_depth_round_trip_and_order(rng):
    x = rng.randn(2, 4, 6, 8).astype(np.float32)
    s2d = pnn.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(s2d.numpy(),
                                  np.asarray(jnn.space_to_depth(x)))
    np.testing.assert_array_equal(pnn.depth_to_space(s2d).numpy(), x)
    np.testing.assert_array_equal(
        pnn.depth_to_space(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.depth_to_space(x)))
    # channels factor as (i, j, C'), not PixelShuffle's (C', i, j)
    shuffled = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not np.allclose(shuffled.numpy(),
                           pnn.depth_to_space(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("k,stride,pad,aux", [(3, 1, 1, False),
                                              (1, 1, 0, False),
                                              (3, 2, 1, False),
                                              (3, 1, 1, True)])
def test_norm_conv_matches_jax(rng, k, stride, pad, aux):
    cx, ca, cout = 5, 3, 7
    conv = pnn.NormConv2d(cx + (ca if aux else 0), cout, k, stride, pad)
    tree = _tree(conv, pconv._norm_conv("x", ()))
    x = rng.randn(2, 9, 9, cx).astype(np.float32)
    a = rng.randn(2, 9, 9, ca).astype(np.float32) if aux else None
    ref = jnn.NormConv2d(cout, kernel_size=k, stride=stride,
                         padding=pad).apply(
        {"params": tree}, jnp.asarray(x),
        None if a is None else jnp.asarray(a))
    out = conv(torch.from_numpy(x), None if a is None else torch.from_numpy(a))
    assert out.shape == ref.shape
    _close(out, ref)


def test_norm_conv_unported_options_raise():
    with pytest.raises(NotImplementedError):
        pnn.NormConv2d(3, 4, quant="int8_static")
    with pytest.raises(NotImplementedError):
        pnn.NormConv2d(3, 4, d2s_transpose=True)
    with pytest.raises(NotImplementedError):
        pnn.Upsample(3, 4, subpixel=False)


def test_norm_dense_matches_jax(rng):
    dense = pnn.NormDense(6, 4)
    tree = _tree(dense, pconv._norm_conv("x", (), "dense_v"))
    x = rng.randn(3, 6).astype(np.float32)
    ref = jnn.NormDense(4).apply({"params": tree}, jnp.asarray(x))
    _close(dense(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("residual", [False, True])
def test_vunet_rnb_matches_jax(rng, residual):
    c, ca = 6, 10
    rnb = pnn.VunetRNB(c, residual=residual, aux_channels=ca)
    tree = _tree(rnb, pconv._rnb("x", (), residual))
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    a = rng.randn(2, 8, 8, ca).astype(np.float32) if residual else None
    ref = jnn.VunetRNB(c, residual=residual).apply(
        {"params": tree}, jnp.asarray(x),
        None if a is None else jnp.asarray(a))
    _close(rnb(torch.from_numpy(x), None if a is None
               else torch.from_numpy(a)), ref)


def test_down_and_upsample_match_jax(rng):
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    down = pnn.Downsample(6, 5)
    tree = _tree(down, pconv._norm_conv("x.down", ("NormConv2d_0",)))
    ref = jnn.Downsample(5).apply({"params": tree}, jnp.asarray(x))
    out = down(torch.from_numpy(x))
    assert out.shape == (2, 4, 4, 5)
    _close(out, ref)
    up = pnn.Upsample(6, 5)
    tree = _tree(up, pconv._norm_conv("x.up", ("NormConv2d_0",)))
    ref = jnn.Upsample(5).apply({"params": tree}, jnp.asarray(x))
    out = up(torch.from_numpy(x))
    assert out.shape == (2, 16, 16, 5)
    _close(out, ref)


@pytest.mark.parametrize("use_tanh,depth", [(True, 2), (False, 1)])
def test_fully_connected_net_matches_jax(rng, use_tanh, depth):
    net = pnn.FullyConnectedNet(5, depth, hidden_dim=12, use_tanh=use_tanh,
                                out_dim=4)
    init_random_(net, rng)
    tree = {f"Dense_{k}": {
        "kernel": net.main[2 * k].weight.detach().numpy().T,
        "bias": net.main[2 * k].bias.detach().numpy()}
        for k in range(depth + 2)}
    x = rng.randn(3, 5).astype(np.float32)
    ref = jnn.FullyConnectedNet(5, depth, hidden_dim=12, use_tanh=use_tanh,
                                out_dim=4).apply({"params": tree},
                                                 jnp.asarray(x))
    _close(net(torch.from_numpy(x)), ref)
