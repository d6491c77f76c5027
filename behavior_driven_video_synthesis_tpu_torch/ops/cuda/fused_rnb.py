"""Fused VunetRNB (no auxiliary input, pre-activation ELU): the CUDA kernel's
wrapper, its operand preparation and its plain PyTorch version.

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

CUDA tensors launch the kernel (bf16, C a multiple of 8 up to 128) or
raise; CPU tensors take the plain version, in the tensor's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

# Launches of the kernel since import (or since a caller last reset it).
fused_rnb_launches = 0


def rnb_operands(rnb):
    """(W, scale, shift) of a VunetRNB's conv in f32: W (C, C, 3, 3) OIHW,
    scale = gamma and shift = gamma * bias + beta, each (C,)."""
    conv = rnb.conv
    scale = conv.gamma.reshape(-1).float()
    shift = scale * conv.conv.bias.float() + conv.beta.reshape(-1).float()
    return conv.kernel().float(), scale, shift


def fused_rnb_plain(x, rnb):
    """The kernel's function in PyTorch, in x's dtype: ELU output and W
    rounded to it, the conv accumulated in f32, the affine and the residual
    added in f32, one rounding at the end.  In f32 this is exactly
    ``x + NormConv2d(elu(x))``."""
    dt = x.dtype
    w, scale, shift = rnb_operands(rnb)
    h = F.elu(x.float()).to(dt).float()
    acc = F.conv2d(h.permute(0, 3, 1, 2), w.to(dt).float(), None, 1, 1)
    return (x.float() + (scale * acc.permute(0, 2, 3, 1) + shift)).to(dt)


def _check(x, rnb):
    conv = rnb.conv
    v = conv.conv.weight_v
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if tuple(v.shape) != (C, C, 3, 3) or conv.stride != 1 \
            or conv.padding != 1:
        raise ValueError(f"the fused RNB kernel takes a 3x3, stride-1, "
                         f"SAME conv from C={C} to C channels; got weight "
                         f"{tuple(v.shape)}, stride {conv.stride}, padding "
                         f"{conv.padding}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused RNB kernel takes bfloat16, got {x.dtype}")
    if C % 8 != 0 or C > 128:
        raise ValueError(f"the fused RNB kernel needs C % 8 == 0 and "
                         f"C <= 128, got C={C}")
    if x.shape[0] > 65535:
        raise ValueError(f"the fused RNB kernel takes B <= 65535, got "
                         f"{x.shape[0]}")
    if v.device != x.device:
        raise ValueError(f"the RNB's parameters are on {v.device}, x on "
                         f"{x.device}")


def _check_no_grad(x, rnb):
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in rnb.conv.parameters())):
        raise RuntimeError("the fused RNB kernel has no backward; call it "
                           "under torch.no_grad() or inference_mode()")


@functools.cache
def _lib():
    lib = load_library("fused_rnb")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_fused_rnb.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.bdvs_fused_rnb.restype = i
    return lib


def _aligned(t):
    t = t.contiguous()
    if t.data_ptr() % 16:       # the kernel loads 16-byte vectors
        t = t.clone()
    return t


def _launch(x, rnb):
    global fused_rnb_launches
    _check(x, rnb)
    B, H, W, C = x.shape
    w, scale, shift = rnb_operands(rnb)
    # [tap = 3*dh + dw][out][in]: the kernel's B operand, k contiguous
    w9 = _aligned(w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, C, C))
    x, scale, shift = _aligned(x), scale.contiguous(), shift.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().bdvs_fused_rnb(
            x.data_ptr(), w9.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), B, H, W, C, stream)
    if err:
        raise RuntimeError(f"fused RNB kernel launch failed: cudaError {err}")
    fused_rnb_launches += 1
    return out


def fused_rnb(x, rnb):
    """``rnb(x)`` for a VunetRNB without auxiliary input (activate=True,
    3x3 conv): the kernel for a CUDA tensor, the plain version for a CPU
    tensor.  x is NHWC; the result has x's shape and dtype."""
    _check_no_grad(x, rnb)
    if x.device.type == "cpu":
        return fused_rnb_plain(x, rnb)
    if x.device.type != "cuda":
        raise ValueError(f"no fused RNB for device {x.device}")
    return _launch(x, rnb)
