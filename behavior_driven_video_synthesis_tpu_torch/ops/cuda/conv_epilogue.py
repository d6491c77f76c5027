"""The conv epilogue kernel: bias and residual added to a conv's output in
one pass, in place, or, activated, stored as ELU into a channel slice of
another buffer; its wrappers and its plain PyTorch versions.

``NormConv2d`` at inference on the card (``ops/nn.py``) folds its affine
into the conv (W' = gamma * W, b' = gamma * bias + beta), runs the conv
without bias, and hands the NHWC output y here::

    y <- y + b'            or, in a residual block,   y <- x + y + b'

summed in f32 as (y + b') + x and rounded once to y's type.  The kernel
(``csrc/conv_epilogue.cu``) moves each byte once in 16-byte vectors; it
replaces eager PyTorch's three broadcast passes (bias, gamma, beta) and the
residual add.  It has no backward: it serves the inference route only.

The activated store (:func:`conv_epilogue_act`) writes ELU of the rounded
sum, ``F.elu(round(y [+ b'] [+ r]))``, into a channel slice of a contiguous
NHWC buffer: a residual block with auxiliary input assembles its 2C conv
input so, ELU(x) in the lower half (no bias) and the ``nin`` conv's
epilogue in the upper half, with no ``torch.cat`` and no separate ELU pass
(``ops/nn.py``, ``VunetRNB``).

CUDA tensors launch the kernel (bf16 or f16) or raise; CPU tensors take the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import launch, load_library

# Launches since import (or since a caller last reset them): those that
# finish a conv (add its bias; one a full-precision NormConv2d call at
# inference on the card), and the activated stores, with or without a bias
# (two a residual block call with auxiliary input on that route).
conv_epilogue_launches = 0
conv_epilogue_act_launches = 0

DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def conv_epilogue_plain(y, bias, residual=None):
    """The kernel's function, out of place: (y + bias) + residual in f32,
    bias broadcast over y's last (channel) dimension, rounded once to y's
    type."""
    out = y.float() + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(y.dtype)


def conv_epilogue_act_plain(y, bias=None, residual=None):
    """The activated store's function, out of place: F.elu of
    (y [+ bias]) [+ residual] summed in f32 and rounded once to y's type
    (y itself, unrounded, when there is nothing to add)."""
    v = y
    if bias is not None or residual is not None:
        s = y.float()
        if bias is not None:
            s = s + bias.float()
        if residual is not None:
            s = s + residual.float()
        v = s.to(y.dtype)
    return F.elu(v)


@functools.cache
def _lib():
    lib = load_library("conv_epilogue")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bdvs_conv_epilogue.argtypes = [p, p, p, ll, i, i, p]
    lib.bdvs_conv_epilogue.restype = i
    lib.bdvs_conv_epilogue_act.argtypes = [p, p, p, p, ll, i, ll, i, p]
    lib.bdvs_conv_epilogue_act.restype = i
    return lib


def _check(y, bias, residual, bias_optional=False):
    if y.dtype not in DTYPES:
        raise TypeError(f"the conv epilogue kernel takes bfloat16 or float16, "
                        f"got {y.dtype}")
    if y.dim() < 1 or not y.is_contiguous():
        raise ValueError("the conv epilogue kernel needs y contiguous "
                         "(NHWC)")
    C = y.shape[-1]
    if bias is None and not bias_optional:
        raise ValueError("the in-place epilogue needs a bias")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (C,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous float32 ({C},), got "
                         f"{bias.dtype}{list(bias.shape)}")
    tensors = ([] if bias is None else [bias]) \
        + ([] if residual is None else [residual])
    if any(t.device != y.device for t in tensors):
        raise ValueError(f"bias and residual must be on y's device "
                         f"{y.device}")
    if residual is not None and (residual.dtype != y.dtype
                                 or residual.shape != y.shape):
        raise ValueError(f"residual must have y's type and shape "
                         f"{y.dtype}{list(y.shape)}, got "
                         f"{residual.dtype}{list(residual.shape)}")


def conv_epilogue(y, bias, residual=None):
    """``y + bias [+ residual]`` written into y, which is returned: the
    kernel for CUDA tensors, the plain version for CPU tensors.  y is a
    contiguous NHWC tensor, bias float32 of y's channels, residual y's
    shape and type (a strided one is copied first)."""
    global conv_epilogue_launches
    _check(y, bias, residual)
    if y.device.type == "cpu":
        return y.copy_(conv_epilogue_plain(y, bias, residual))
    if y.device.type != "cuda":
        raise ValueError(f"no conv epilogue for device {y.device}")
    if residual is not None:
        residual = residual.contiguous()
    launch(_lib().bdvs_conv_epilogue, "conv epilogue kernel launch",
           y.device, y.data_ptr(),
           None if residual is None else residual.data_ptr(),
           bias.data_ptr(), y.numel(), y.shape[-1], DTYPES[y.dtype])
    conv_epilogue_launches += 1
    return y


def _row_stride(out, y):
    """The channels of the contiguous NHWC buffer that ``out`` is a channel
    slice of (out's pixel stride), checked: out has y's shape and dtype,
    its channels are adjacent and its pixels evenly strided, and it does
    not overlap y."""
    if out.dtype != y.dtype or out.shape != y.shape \
            or out.device != y.device:
        raise ValueError(f"out must have y's type, shape and device "
                         f"{y.dtype}{list(y.shape)} {y.device}, got "
                         f"{out.dtype}{list(out.shape)} {out.device}")
    C = y.shape[-1]
    ldo = out.stride(-2) if out.dim() > 1 else C
    expect, step = [1], ldo
    for size in reversed(out.shape[:-1]):
        expect.insert(0, step)
        step *= size
    if ldo < C or list(out.stride()) != expect:
        raise ValueError(f"out must be a channel slice of a contiguous NHWC "
                         f"buffer, got strides {list(out.stride())} for "
                         f"shape {list(out.shape)}")
    es = y.element_size()
    lo, hi = out.data_ptr(), out.data_ptr() + \
        ((y.numel() // C - 1) * ldo + C) * es
    if lo < y.data_ptr() + y.numel() * es and y.data_ptr() < hi:
        raise ValueError("out overlaps y: the activated store is out of "
                         "place")
    return ldo


def conv_epilogue_act(y, out, bias=None, residual=None):
    """``F.elu(round(y [+ bias] [+ residual]))`` written into ``out``,
    which is returned: the kernel for CUDA tensors, the plain version for
    CPU tensors.  y is a contiguous NHWC tensor (read only), bias float32 of
    y's channels or None, residual y's shape and type (a strided one is
    copied first); out has y's shape and type and is a channel slice of a
    contiguous NHWC buffer, such as ``buf[..., C:]`` of a 2C buffer, apart
    from y."""
    global conv_epilogue_launches, conv_epilogue_act_launches
    _check(y, bias, residual, bias_optional=True)
    ldo = _row_stride(out, y)
    if y.device.type == "cpu":
        return out.copy_(conv_epilogue_act_plain(y, bias, residual))
    if y.device.type != "cuda":
        raise ValueError(f"no conv epilogue for device {y.device}")
    if residual is not None:
        residual = residual.contiguous()
    launch(_lib().bdvs_conv_epilogue_act, "conv epilogue kernel launch",
           y.device, out.data_ptr(), y.data_ptr(),
           None if residual is None else residual.data_ptr(),
           None if bias is None else bias.data_ptr(), y.numel(),
           y.shape[-1], ldo, DTYPES[y.dtype])
    conv_epilogue_act_launches += 1
    if bias is not None:
        conv_epilogue_launches += 1
    return out
