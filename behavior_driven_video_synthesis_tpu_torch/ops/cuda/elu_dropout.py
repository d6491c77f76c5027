"""Fused ELU + dropout: CUDA kernels, their plain PyTorch version, autograd.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/pallas/elu_dropout.py``
(``_fwd_kernel`` :83 and ``_bwd_kernel`` :95).  ``dropout(elu(x))`` in one
pass: an element is kept iff its 32 random bits are below
``thresh = min(2**32 - 1, round((1 - rate) * 2**32))``, and survivors are
scaled by ``2**32 / thresh``, the inverse of the realized keep probability,
so E[out] = E[elu(x)].  The backward pass regenerates the same bits from the
saved seed words and returns ``ct * scale * elu'(x)`` where kept: no mask is
stored.

The bits are Philox4x32-10 keyed by the site's two int32 seed words (a
device tensor, drawn from the caller's ``torch.Generator``, so a site never
syncs with the host); element ``4g + j`` takes word ``j`` of the block for
counter ``(g mod 2**32, g div 2**32, 0, 0)``.  :func:`philox4x32_10` computes
the same stream in torch integer arithmetic, so the plain version and the
kernel (``csrc/elu_dropout.cu``) make identical keep decisions.  Every
function takes an element ``offset`` (any int >= 0): element i of x then
takes the bits of element offset + i of the stream, so that a
data-parallel rank holding rows of a global batch draws its slice of the
global batch's mask (``dropout_impl: pallas_sharded``).

CUDA tensors launch the kernels (f32 or bf16) or raise; CPU tensors take the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .build import launch, load_library

# Launches of each kernel since import (or since a caller last reset them).
elu_dropout_fwd_launches = 0
elu_dropout_bwd_launches = 0

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def keep_params(rate: float):
    """(thresh, scale) of ``elu_dropout.py:_keep_params``."""
    thresh = int(min(2 ** 32 - 1, round((1.0 - rate) * 2 ** 32)))
    return thresh, 2 ** 32 / thresh


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a holding u32
    values; m is split into 16-bit halves so no product exceeds 2**48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding u32 values (broadcasting);
    returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """The kernels' 32 random bits for elements offset..offset+n-1 of the
    stream, as int64 in [0, 2**32), computed on ``seed``'s device."""
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    g = torch.arange(offset // 4, (offset + n + 3) // 4, dtype=torch.int64,
                     device=seed.device)
    k = seed.to(torch.int64) & _MASK32
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK32, g >> 32, zero, zero, k[0], k[1])
    start = offset % 4
    return torch.stack(words, dim=1).reshape(-1)[start:start + n]


def _keep_mask(x, seed, rate, offset):
    thresh, _ = keep_params(rate)
    return (dropout_bits(seed, x.numel(), offset) < thresh).reshape(x.shape)


def _compute_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def elu_dropout_plain(x, seed, rate: float, offset: int = 0):
    """The forward kernel's function: ELU in f32 (f64 for f64 input), times
    scale where kept, rounded once to x's type."""
    xf = x.to(_compute_dtype(x))
    e = torch.where(xf > 0, xf, torch.expm1(xf))
    out = torch.where(_keep_mask(x, seed, rate, offset),
                      e * keep_params(rate)[1],
                      torch.zeros((), dtype=xf.dtype, device=x.device))
    return out.to(x.dtype)


def elu_dropout_backward_plain(x, ct, seed, rate: float, offset: int = 0):
    """The backward kernel's function: ct * scale * elu'(x) where kept."""
    xf = x.to(_compute_dtype(x))
    de = torch.where(xf > 0, torch.ones_like(xf), torch.exp(xf))
    dx = torch.where(_keep_mask(x, seed, rate, offset),
                     ct.to(xf.dtype) * keep_params(rate)[1] * de,
                     torch.zeros((), dtype=xf.dtype, device=x.device))
    return dx.to(x.dtype)


@functools.cache
def _lib():
    lib = load_library("elu_dropout")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    u, f = ctypes.c_uint, ctypes.c_float
    lib.bdvs_elu_dropout_fwd.argtypes = [p, p, p, ll, ll, i, u, f, p]
    lib.bdvs_elu_dropout_fwd.restype = i
    lib.bdvs_elu_dropout_bwd.argtypes = [p, p, p, p, ll, ll, i, u, f, p]
    lib.bdvs_elu_dropout_bwd.restype = i
    return lib


def _kernel_operand(t, x):
    if t.device != x.device:
        raise ValueError(f"tensor on {t.device}, x on {x.device}")
    if t.dtype != x.dtype:
        raise TypeError(f"dtype {t.dtype} differs from x's {x.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 16:       # the kernel loads 16-byte vectors
        t = t.clone()
    return t


def _check_kernel_args(x, seed, offset):
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the ELU+dropout kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if seed.device != x.device or seed.dtype != torch.int32 \
            or seed.shape != (2,):
        raise ValueError(f"seed must be int32[2] on {x.device}, got "
                         f"{seed.dtype}{list(seed.shape)} on {seed.device}")


def _launch_fwd(x, seed, rate, offset=0):
    global elu_dropout_fwd_launches
    _check_kernel_args(x, seed, offset)
    x = _kernel_operand(x, x)
    out = torch.empty_like(x)
    thresh, scale = keep_params(rate)
    launch(_lib().bdvs_elu_dropout_fwd, "ELU+dropout forward launch",
           x.device, x.data_ptr(), out.data_ptr(),
           seed.contiguous().data_ptr(), x.numel(), offset,
           _DTYPES[x.dtype], thresh, scale)
    elu_dropout_fwd_launches += 1
    return out


def _launch_bwd(x, ct, seed, rate, offset=0):
    global elu_dropout_bwd_launches
    _check_kernel_args(x, seed, offset)
    x = _kernel_operand(x, x)
    ct = _kernel_operand(ct, x)
    dx = torch.empty_like(x)
    thresh, scale = keep_params(rate)
    launch(_lib().bdvs_elu_dropout_bwd, "ELU+dropout backward launch",
           x.device, x.data_ptr(), ct.data_ptr(), dx.data_ptr(),
           seed.contiguous().data_ptr(), x.numel(), offset,
           _DTYPES[x.dtype], thresh, scale)
    elu_dropout_bwd_launches += 1
    return dx


def elu_dropout_forward(x, seed, rate: float, offset: int = 0):
    """Forward pass without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return elu_dropout_plain(x, seed, rate, offset)
    if x.device.type != "cuda":
        raise ValueError(f"no ELU+dropout for device {x.device}")
    return _launch_fwd(x, seed, rate, offset)


def elu_dropout_backward(x, ct, seed, rate: float, offset: int = 0):
    """Backward pass without autograd, dispatched as the forward."""
    if x.device.type == "cpu":
        return elu_dropout_backward_plain(x, ct, seed, rate, offset)
    if x.device.type != "cuda":
        raise ValueError(f"no ELU+dropout for device {x.device}")
    return _launch_bwd(x, ct, seed, rate, offset)


class EluDropout(torch.autograd.Function):
    """dropout(elu(x)) whose backward regenerates the mask from the seed;
    saves x and the seed words, never a mask.  ``apply(x, seed, rate[,
    offset])``."""

    @staticmethod
    def forward(ctx, x, seed, rate, *offset):
        ctx.save_for_backward(x, seed)
        ctx.rate, ctx.offset = rate, (offset[0] if offset else 0)
        ctx.n_inputs = 3 + len(offset)
        return elu_dropout_forward(x, seed, rate, ctx.offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, seed = ctx.saved_tensors
        dx = elu_dropout_backward(x, ct, seed, ctx.rate, ctx.offset)
        return (dx,) + (None,) * (ctx.n_inputs - 1)


def draw_seed(device, generator=None) -> torch.Tensor:
    """Two int32 seed words drawn on ``device`` from ``generator`` (the
    counterpart of ``jax.random.bits(key, (2,))``); no host sync."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         device=device, generator=generator)


def elu_dropout(x, rate: float, generator=None, offset: int = 0):
    """dropout(elu(x)) at dropout rate ``rate``, with seed words drawn from
    ``generator``, x's elements at stream index ``offset`` on."""
    if rate <= 0.0:
        return F.elu(x)
    if rate >= 1.0:
        return torch.zeros_like(x)
    return EluDropout.apply(x, draw_seed(x.device, generator), float(rate),
                            int(offset))
