"""The fused RNB kernel's function (``ops/cuda/fused_rnb.py``) on the CPU.

Its plain version is held against the JAX package's retired Pallas kernel
(``attic/pallas_rnb.py``, imported by path and run in interpret mode), that
kernel's pure-JAX oracle ``rnb_reference`` and the flax ``VunetRNB``, with
the attic test's own bounds (``attic/test_pallas_rnb.py``): atol 0.02
against the kernel and the oracle (both round elu(x) and W to bf16 and
accumulate in f32, as the plain version does), 0.05 against the flax block
(whose bf16 conv output is rounded before the affine).  In f32 the plain
version is the port's default ``VunetRNB`` eval forward within 1e-5.
Weights and inputs come from a numpy seed.  The kernel itself runs only on
the card (``tests/test_torch_kernels_gpu.py``).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.ops.nn import VunetRNB as JVunetRNB

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import fused_rnb as R

ATTIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "attic", "pallas_rnb.py")
SHAPES = [(2, 32, 32, 32), (1, 16, 32, 64), (2, 16, 16, 128)]


@pytest.fixture(scope="module")
def attic():
    spec = importlib.util.spec_from_file_location("pallas_rnb", ATTIC)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _block(C, seed, dtype=torch.bfloat16, **kw):
    """A port VunetRNB from a numpy seed and its conv's flax params."""
    block = init_random_(pnn.VunetRNB(C, dtype=dtype, **kw),
                         np.random.RandomState(seed))
    params = pconv.to_flax(block.state_dict(), pconv._norm_conv("conv", ()))
    return block, params


def _x(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.5
    return torch.from_numpy(x).bfloat16()


def _np(v):
    return np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                      np.float32)


def _jx(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_attic_kernel_and_oracle(attic, shape):
    C = shape[-1]
    block, params = _block(C, C)
    x = _x(shape, 1)
    with torch.no_grad():
        out = _np(R.fused_rnb_plain(x, *block.fused_weights()))
    ref = _np(attic.rnb_reference(_jx(x), params))
    kernel = _np(attic.fused_rnb(_jx(x), params, interpret=True,
                                 block_rows=8))
    assert np.abs(out - ref).max() < 0.02
    assert np.abs(out - kernel).max() < 0.02


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_flax_block(shape):
    C = shape[-1]
    block, params = _block(C, C + 1)
    x = _x(shape, 2)
    ref = JVunetRNB(channels=C, dtype=jnp.bfloat16).apply(
        {"params": {"NormConv2d_0": params}}, _jx(x))
    with torch.no_grad():
        out = _np(block._forward_fused(x))
    assert out.dtype == np.float32 and np.abs(out - _np(ref)).max() < 0.05


def test_zero_padding_at_image_edges(attic):
    """SAME zero padding: a bright pixel at the image border must not wrap
    around to the opposite edge (the attic kernel's border case)."""
    C, H, W = 32, 16, 16
    x = torch.zeros(1, H, W, C, dtype=torch.bfloat16)
    x[0, 0, 0, :] = 4.0
    x[0, H - 1, W - 1, :] = 4.0
    block, params = _block(C, 0)
    with torch.no_grad():
        out = _np(R.fused_rnb_plain(x, *block.fused_weights()))
    np.testing.assert_allclose(out, _np(attic.rnb_reference(_jx(x), params)),
                               atol=0.02)
    np.testing.assert_allclose(out, _np(attic.fused_rnb(
        _jx(x), params, interpret=True, block_rows=8)), atol=0.02)
    # away from the two corners the conv sees only zeros
    with torch.no_grad():
        shift = _np(block.fused_weights()[2].bfloat16())
    np.testing.assert_allclose(out[0, 4:12, 4:12],
                               np.broadcast_to(shift, (8, 8, C)), atol=0)


@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (1, 16, 16, 32),
                                   (2, 8, 8, 24)])
def test_plain_in_f32_is_the_default_block(shape):
    C = shape[-1]
    block, _ = _block(C, 3, dtype=torch.float32)
    x = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(
        np.float32))
    with torch.no_grad():
        out = R.fused_rnb_plain(x, *block.fused_weights())
        ref = block(x)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_route_on_the_cpu_and_under_autograd():
    """rnb_impl "fused" runs the plain version for a CPU tensor, only for
    blocks without auxiliary input at inference, and raises when autograd
    would need its missing backward."""
    block, _ = _block(16, 5, rnb_impl="fused")
    residual = pnn.VunetRNB(16, residual=True, rnb_impl="fused")
    assert block.fused and not residual.fused
    default = pnn.VunetRNB(16, dtype=torch.bfloat16)
    default.load_state_dict(block.state_dict())
    x = _x((2, 8, 8, 16), 6)
    with torch.no_grad():
        torch.testing.assert_close(
            block(x), R.fused_rnb_plain(x, *block.fused_weights()), atol=0,
            rtol=0)
        # train=True keeps the default path
        torch.testing.assert_close(block(x, train=True), default(x),
                                   atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="no backward"):
        block(x)
    with pytest.raises(RuntimeError, match="no backward"):
        block.requires_grad_(False)(x.float().requires_grad_(True))
    with torch.inference_mode():
        assert block(x).shape == x.shape


@pytest.mark.parametrize("C", [8, 24, 32, 64, 120, 128])
def test_packed_weights_round_trip_to_oihw(C):
    """The kernel's layouts, (9, CP, CP + 8) [tap = 3*dh + dw][out][in]
    for mma.sync and (9, CP/8, CP/8, 8, 8) core matrices for wgmma, unpack
    to the bf16 OIHW kernel exactly, with zeros in every pad."""
    w = torch.from_numpy(np.random.RandomState(C).randn(C, C, 3, 3).astype(
        np.float32))
    packed = R.pack_weights(w)
    CP = R.padded_channels(C)
    assert CP % 16 == 0 and C <= CP < C + 16
    assert packed.shape == R.packed_shape(C)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(R.unpack_weights(packed, C), w.bfloat16())
    if CP in R.WGMMA_CHANNELS:
        assert packed.shape == (9, CP // 8, CP // 8, 8, 8)
        # tap 5 = (dh 1, dw 2), out 10 = 8 + 2, in 23 = 16 + 7
        assert torch.equal(packed[5, 1, 2, 2, 7], w[10, 23, 1, 2].bfloat16())
        taps = packed.permute(0, 1, 3, 2, 4).reshape(9, CP, CP)
    else:
        assert packed.shape == (9, CP, CP + 8)
        assert torch.equal(packed[5, 2, 7], w[2, 7, 1, 2].bfloat16())
        taps = packed
    pad = taps.float().clone()
    pad[:, :C, :C] = 0
    assert not pad.any()
    affine = R.pack_affine(torch.arange(1.0, C + 1), -torch.arange(C) * 1.0)
    assert affine.shape == (2, CP) and affine.dtype == torch.float32
    assert torch.equal(affine[0, :C], torch.arange(1.0, C + 1))
    assert torch.equal(affine[1, :C], -torch.arange(C) * 1.0)
    assert not affine[:, C:].any()


@pytest.mark.parametrize("C", [16, 64])
def test_fused_operands_unpack_to_the_blocks_weights(C):
    """A block's packed operands hold its conv's W rounded to bf16, gamma
    as the scale and gamma * bias + beta as the shift, in f32."""
    block, _ = _block(C, 7, rnb_impl="fused")
    w_packed, affine = block.fused_operands()
    w, scale, shift = block.fused_weights()
    assert torch.equal(R.unpack_weights(w_packed, C), w.bfloat16())
    assert torch.equal(affine[0, :C], scale)
    assert torch.equal(affine[1, :C], shift)
    with torch.no_grad():
        torch.testing.assert_close(scale, block.conv.gamma.reshape(-1))
        torch.testing.assert_close(shift, block.conv.gamma.reshape(-1)
                                   * block.conv.conv.bias
                                   + block.conv.beta.reshape(-1))
