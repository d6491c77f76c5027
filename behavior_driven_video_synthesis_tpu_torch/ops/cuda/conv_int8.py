"""int8 3x3 convolution (padding 1, stride 1 or 2): the CUDA kernel's
wrapper, the weight preparation and the plain PyTorch version.

Counterpart of the JAX package's ``ops/nn.py:_conv_int8`` (:111), which XLA
lowers (no Pallas kernel).  For NHWC x in bf16 or f32 and a float kernel W
(OIHW here), with ``ax`` the activation scale (a 0-d f32 tensor)::

    x_q  = clip(round_half_even(x * (127 / ax).to(x.dtype)), -127, 127)
    aw   = max|W| over (cin, kh, kw) + 1e-12          (per output channel)
    W_q  = round_half_even(W * (127 / aw))
    y    = (f32(conv(x_q, W_q)) * ((ax * aw) / 16129) + bias).to(dtype)

with the product ``x * inv`` rounded to x's dtype before the round.  The
kernel (``csrc/conv_int8.cu``) quantizes x as it loads it and multiplies on
the tensor cores (int8 x int8 -> int32); :func:`conv_int8_plain` quantizes
the same way and convolves the int8 values in float64, which is exact
(|acc| <= 127^2 * 9 * Cin < 2^53).  W_q and aw are prepared once per set of
weights (:func:`quantize_weight`, :func:`pack_weights`; ``NormConv2d``
caches them).

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .build import load_library

# Launches of the kernel since import (or since a caller last reset it).
conv_int8_launches = 0

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _true_div(a, b):
    """a / b rounded once, as the JAX package divides.  torch computes
    ``scalar / tensor`` as a reciprocal times the scalar, and CUDA divides
    a tensor by a scalar as a multiply by its reciprocal: both round
    twice, so the scalar becomes a tensor beside the other operand."""
    t = b if isinstance(b, torch.Tensor) else a
    a = a if isinstance(a, torch.Tensor) else torch.full_like(t, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(t, b)
    return a / b


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """max|x| + 1e-12 as a 0-d f32 tensor on x's device (the max is exact
    in x's dtype, so no f32 copy of x is made)."""
    return torch.linalg.vector_norm(x, float("inf")).float() + 1e-12


def quantize_act(x: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """x's int8 values (as x's dtype): the product with bf16(127 / ax)
    rounded to x's dtype, rounded half to even, clipped to +-127."""
    inv = _true_div(127.0, ax.float()).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127)


def quantize_weight(w: torch.Tensor):
    """(W_q int8 OIHW, aw (N,) f32) of a float OIHW kernel, quantized per
    output channel."""
    kf = w.float()
    aw = kf.abs().amax(dim=(1, 2, 3)) + 1e-12
    w_q = torch.round(kf * _true_div(127.0, aw).reshape(-1, 1, 1, 1))
    return w_q.to(torch.int8), aw


def dequant_scale(ax: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """(ax * aw) / 16129 in f32."""
    return _true_div(ax.float() * aw, 127.0 * 127.0)


def conv_int8_plain(x, w_q, aw, ax, bias=None, stride: int = 1,
                    dtype=None, accumulators: bool = False):
    """The kernel's function in PyTorch.  x NHWC (bf16 or f32), w_q int8
    OIHW (N, Cin, 3, 3), aw (N,) f32, ax a 0-d f32 tensor, bias (N,) f32 or
    None.  Returns NHWC in ``dtype`` (default x's), or with
    ``accumulators`` the int32 sums."""
    xq = quantize_act(x, ax).double().permute(0, 3, 1, 2)
    acc = F.conv2d(xq, w_q.double(), None, stride, 1).permute(0, 2, 3, 1)
    if accumulators:
        return acc.to(torch.int32)
    y = acc.float() * dequant_scale(ax, aw)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype or x.dtype)


class PackedWeights(NamedTuple):
    """W_q in the kernel's layout (Npad, 9, CinP) int8, zero past N and Cin
    (Npad a multiple of 64, CinP of 32), aw zero-padded to (Npad,), and
    the true N and Cin."""
    w: torch.Tensor
    aw: torch.Tensor
    n: int
    cin: int


def pack_weights(w_q: torch.Tensor, aw: torch.Tensor) -> PackedWeights:
    N, Cin = w_q.shape[:2]
    npad, cinp = -(-N // 64) * 64, -(-Cin // 32) * 32
    w = torch.zeros(npad, 9, cinp, dtype=torch.int8, device=w_q.device)
    w[:N, :, :Cin] = w_q.permute(0, 2, 3, 1).reshape(N, 9, Cin)
    awp = torch.zeros(npad, dtype=torch.float32, device=aw.device)
    awp[:N] = aw
    return PackedWeights(w, awp, N, Cin)


@functools.cache
def _lib():
    lib = load_library("conv_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_conv_int8.argtypes = [p, i] + [p] * 5 + [i] * 9 + [p]
    lib.bdvs_conv_int8.restype = i
    return lib


def conv_int8_packed(x: torch.Tensor, packed: PackedWeights,
                     ax: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: int = 1, dtype=None,
                     accumulators: bool = False) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: x NHWC bf16 or f32,
    ``packed`` from :func:`pack_weights`, ax a 0-d f32 tensor, bias (N,)
    f32 or None.  Returns NHWC in ``dtype`` (bf16 or f32, default x's), or
    with ``accumulators`` the int32 sums."""
    global conv_int8_launches
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be NHWC bf16 or f32, got {x.dtype} of "
                        f"shape {tuple(x.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"the int8 conv kernel takes stride 1 or 2, got "
                         f"{stride}")
    B, H, W, Cin = x.shape
    if Cin != packed.cin:
        raise ValueError(f"x has {Cin} channels, the weights {packed.cin}")
    out_dtype = torch.int32 if accumulators else (dtype or x.dtype)
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"the int8 conv kernel writes bf16, f32 or int32, "
                        f"not {out_dtype}")
    tensors = [x, packed.w, packed.aw, ax] + (
        [bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, the weights, ax and bias must share a device")
    if ax.numel() != 1 or ax.dtype != torch.float32:
        raise TypeError("ax must be one f32 value")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.numel() != packed.n):
        raise TypeError(f"bias must be ({packed.n},) f32")
    x = x.contiguous()
    if x.data_ptr() % 16:       # the kernel loads 16-byte vectors
        x = x.clone()
    bias = bias.contiguous() if bias is not None else None
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, Ho, Wo, packed.n, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().bdvs_conv_int8(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            packed.w.data_ptr(), packed.aw.data_ptr(),
            ax.contiguous().data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), _OUT_KIND[out_dtype], B, H, W, Cin,
            packed.w.shape[2], packed.n, packed.w.shape[0], stride, stream)
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: cudaError {err}")
    conv_int8_launches += 1
    return out


def conv_int8(x, w_q, aw, ax, bias=None, stride: int = 1, dtype=None,
              packed: Optional[PackedWeights] = None):
    """The int8 conv of NHWC x with prepared weights (w_q, aw): the kernel
    for a CUDA tensor, which needs ``packed`` (:func:`pack_weights` of
    them, made once by the caller), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv_int8_plain(x, w_q, aw, ax, bias, stride, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {x.device}")
    if packed is None:
        raise ValueError("a CUDA int8 conv needs its packed weights "
                         "(pack_weights, made once per set of weights)")
    return conv_int8_packed(x, packed, ax, bias, stride, dtype)
