"""Fused VunetRNB (no auxiliary input, pre-activation ELU): the CUDA kernel's
wrapper, its operand layout and its plain PyTorch version.

Counterpart of ``attic/pallas_rnb.py`` (``_rnb_kernel`` :86, entered through
``fused_rnb`` :208).  One call computes what ``VunetRNB(activate=True)``
computes for ``a=None``::

    out = x + gamma * (conv3x3_SAME(elu(x), W) + bias) + beta

with W = g * v / ||v|| the weight-norm kernel (the norm over cin, kh, kw),
folded as the attic's ``_prep_operands`` folds it: W rounded to bf16, and
``scale = gamma``, ``shift = gamma * bias + beta`` in f32.  The kernel
(``csrc/fused_rnb.cu``) stages bf16(elu(x)) in shared memory, accumulates
the 9*C products in f32 on the tensor cores, and adds the affine and the
residual in f32 before one rounding to bf16.  It has no backward: like the
TPU kernel, it serves the inference path only.

The kernel's operands (W packed in its shared-memory layout by
:func:`pack_weights`, scale and shift by :func:`pack_affine`) are a block's
own: ``VunetRNB.fused_operands`` (``ops/nn.py``) builds them once and
keeps them while its parameters are unchanged, and the block launches
:func:`fused_rnb_prepared` on them on the card and calls
:func:`fused_rnb_plain` on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import launch, load_library

# Launches of the kernel since import (or since a caller last reset it).
fused_rnb_launches = 0


def fused_rnb_plain(x, w, scale, shift):
    """The kernel's function in PyTorch on NHWC x and the f32 (W (C, C, 3,
    3) OIHW, scale, shift) of ``VunetRNB.fused_weights``, in x's dtype: ELU
    output and W rounded to it, the conv accumulated in f32, the affine and
    the residual added in f32, one rounding at the end.  In f32 this is
    exactly ``x + NormConv2d(elu(x))``."""
    dt = x.dtype
    h = F.elu(x.float()).to(dt).float()
    acc = F.conv2d(h.permute(0, 3, 1, 2), w.to(dt).float(), None, 1, 1)
    return (x.float() + (scale * acc.permute(0, 2, 3, 1) + shift)).to(dt)


def padded_channels(C):
    """C rounded up to 16: the kernel's K and N."""
    return -(-C // 16) * 16


# C rounded up to 16 at which the kernel multiplies with wgmma, reading W
# from shared memory in 8x8 core matrices (csrc/fused_rnb.cu Plan::kWgmma)
WGMMA_CHANNELS = (64, 128)


def packed_shape(C):
    """The shape of :func:`pack_weights`'s output at C."""
    CP = padded_channels(C)
    if CP in WGMMA_CHANNELS:
        return (9, CP // 8, CP // 8, 8, 8)
    return (9, CP, CP + 8)


def pack_weights(w):
    """W (C, C, 3, 3) OIHW to the kernel's layout, bf16, zero past C: for
    mma.sync (9, CP, CP + 8), [tap = 3*dh + dw][out][in] with each row's
    last 8 elements the shared-memory row pad; for wgmma (9, CP/8, CP/8, 8,
    8), [tap][out/8][in/8][out%8][in%8], the 8x8 core matrices its
    descriptor reads.  A block copies either as it is."""
    C = w.shape[0]
    CP = padded_channels(C)
    taps = torch.zeros(9, CP, CP, dtype=torch.bfloat16, device=w.device)
    taps[:, :C, :C] = w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(
        9, C, C)
    if CP in WGMMA_CHANNELS:
        return taps.reshape(9, CP // 8, 8, CP // 8, 8).permute(
            0, 1, 3, 2, 4).contiguous()
    return F.pad(taps, (0, 8))


def unpack_weights(packed, C):
    """The inverse of :func:`pack_weights`: (C, C, 3, 3) OIHW, bf16."""
    CP = padded_channels(C)
    if packed.dim() == 5:
        taps = packed.permute(0, 1, 3, 2, 4).reshape(9, CP, CP)
    else:
        taps = packed[..., :CP]
    return taps[:, :C, :C].reshape(3, 3, C, C).permute(2, 3, 0, 1)


def pack_affine(scale, shift):
    """(2, CP) f32: scale then shift, zero past C."""
    C = scale.shape[0]
    affine = torch.zeros(2, padded_channels(C), dtype=torch.float32,
                         device=scale.device)
    affine[0, :C] = scale
    affine[1, :C] = shift
    return affine


def _check_x(x):
    if x.device.type != "cuda":
        raise ValueError(f"no fused RNB for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused RNB kernel takes bfloat16, got {x.dtype}")
    C = x.shape[-1]
    if C % 8 != 0 or C > 128:
        raise ValueError(f"the fused RNB kernel needs C % 8 == 0 and "
                         f"C <= 128, got C={C}")


@functools.cache
def _lib():
    lib = load_library("fused_rnb")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_fused_rnb.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.bdvs_fused_rnb.restype = i
    lib.bdvs_fused_rnb_plan.argtypes = [i, p]
    lib.bdvs_fused_rnb_plan.restype = i
    return lib


def kernel_plan(C, device):
    """The kernel's launch plan at C on a CUDA device: dynamic shared memory
    a block, tap slots (9: the weights resident, 2: a ring), halo buffers,
    m16 rows and output channels a warp, the grid's cap (blocks the device
    holds at once), blocks an SM, threads a block, and whether the
    products run on wgmma (the layout :func:`pack_weights` picks)."""
    info = (ctypes.c_int * 9)()
    launch(_lib().bdvs_fused_rnb_plan, "fused RNB kernel plan", device, C,
           ctypes.addressof(info), stream=False)
    keys = ("smem_bytes", "tap_slots", "halo_buffers", "warp_rows",
            "warp_channels", "grid_cap", "blocks_per_sm", "threads")
    return dict(zip(keys, info), wgmma=bool(info[8]))


def _aligned(t):
    t = t.contiguous()
    if t.data_ptr() % 16:       # the kernel loads 16-byte vectors
        t = t.clone()
    return t


def fused_rnb_prepared(x, operands):
    """One launch of the kernel on a CUDA bf16 NHWC x and operands (W
    packed, affine) of :func:`pack_weights` and :func:`pack_affine` on x's
    device, with nothing prepared on the way: x's shape and type."""
    global fused_rnb_launches
    _check_x(x)
    w, affine = operands
    B, H, W, C = x.shape
    CP = padded_channels(C)
    if tuple(w.shape) != packed_shape(C) or tuple(affine.shape) != (2, CP):
        raise ValueError(f"operands of shapes {tuple(w.shape)}, "
                         f"{tuple(affine.shape)} do not fit C={C}")
    if w.device != x.device or affine.device != x.device:
        raise ValueError(f"the operands are on {w.device}, x on {x.device}")
    x = _aligned(x)
    out = torch.empty_like(x)
    launch(_lib().bdvs_fused_rnb, "fused RNB kernel launch", x.device,
           x.data_ptr(), w.data_ptr(), affine.data_ptr(), out.data_ptr(),
           B, H, W, C)
    fused_rnb_launches += 1
    return out
