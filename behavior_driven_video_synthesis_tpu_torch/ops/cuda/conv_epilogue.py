"""The conv epilogue kernel: bias and residual added to a conv's output in
one pass, in place; its wrapper and its plain PyTorch version.

``NormConv2d`` at inference on the card (``ops/nn.py``) folds its affine
into the conv (W' = gamma * W, b' = gamma * bias + beta), runs the conv
without bias, and hands the NHWC output y here::

    y <- y + b'            or, in a residual block,   y <- x + y + b'

summed in f32 as (y + b') + x and rounded once to y's type.  The kernel
(``csrc/conv_epilogue.cu``) moves each byte once in 16-byte vectors; it
replaces eager PyTorch's three broadcast passes (bias, gamma, beta) and the
residual add.  It has no backward: it serves the inference route only.

CUDA tensors launch the kernel (bf16 or f16) or raise; CPU tensors take the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

# Launches of the kernel since import (or since a caller last reset it).
conv_epilogue_launches = 0

DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def conv_epilogue_plain(y, bias, residual=None):
    """The kernel's function, out of place: (y + bias) + residual in f32,
    bias broadcast over y's last (channel) dimension, rounded once to y's
    type."""
    out = y.float() + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(y.dtype)


@functools.cache
def _lib():
    lib = load_library("conv_epilogue")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bdvs_conv_epilogue.argtypes = [p, p, p, ll, i, i, p]
    lib.bdvs_conv_epilogue.restype = i
    return lib


def _check(y, bias, residual):
    if y.dtype not in DTYPES:
        raise TypeError(f"the conv epilogue kernel takes bfloat16 or float16, "
                        f"got {y.dtype}")
    if y.dim() < 1 or not y.is_contiguous():
        raise ValueError("the conv epilogue kernel writes y in place and "
                         "needs it contiguous (NHWC)")
    C = y.shape[-1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (C,) \
            or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous float32 ({C},), got "
                         f"{bias.dtype}{list(bias.shape)}")
    tensors = [bias] + ([] if residual is None else [residual])
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
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().bdvs_conv_epilogue(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            bias.data_ptr(), y.numel(), y.shape[-1], DTYPES[y.dtype], stream)
    if err:
        raise RuntimeError(f"conv epilogue kernel launch failed: "
                           f"cudaError {err}")
    conv_epilogue_launches += 1
    return y
