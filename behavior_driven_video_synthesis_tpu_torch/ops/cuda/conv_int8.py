"""int8 convolution: the CUDA kernel's wrapper (3x3, padding 1, stride 1
or 2), the library route for every other kernel size, padding and stride,
the weight preparation and the plain PyTorch version.

Counterpart of the JAX package's ``ops/nn.py:_conv_int8`` (:111), which XLA
lowers (no Pallas kernel).  For NHWC x in bf16 or f32 and a float kernel W
(OIHW here), with ``ax`` the activation scale (a 0-d f32 tensor)::

    x_q  = clip(round_half_even(x * (127 / ax).to(x.dtype)), -127, 127)
    aw   = max|W| over (cin, kh, kw) + 1e-12          (per output channel)
    W_q  = round_half_even(W * (127 / aw))
    y    = (f32(conv(x_q, W_q)) * ((ax * aw) / 16129) + bias).to(dtype)

with the product ``x * inv`` rounded to x's dtype before the round.  One
call computes a whole int8 ``NormConv2d`` call: optionally a second input
``aux`` with its own weights and scale, whose output (without bias) is
added in ``dtype``, then ``gamma * y + beta``, each op rounded to
``dtype`` (JAX ``ops/nn.py:262-282``).  The kernel (``csrc/conv_int8.cu``)
does that in one launch: it quantizes x as it loads it and multiplies on
the tensor cores (int8 x int8 -> int32); :func:`conv_int8_plain`
quantizes the same way and convolves the int8 values in float64, which is
exact (|acc| <= 127^2 * 9 * Cin < 2^53).  W_q and aw are prepared once per
set of weights (:func:`quantize_weight`, :func:`pack_weights`;
``NormConv2d`` caches them).

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version.  Shapes the kernel does not take (any kernel size, padding or
stride but 3x3, padding 1, stride 1 or 2) go on the card through
:func:`conv_int8_unfold`: ``F.unfold`` and one cuBLASLt int8 GEMM
(``torch._int_mm``) for the same int32 sums, then the same epilogue.  JAX
leaves every int8 conv to XLA; the kernel covers the shapes the VUNet
quantizes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .build import launch, load_library

# Launches of the kernel since import (or since a caller last reset it).
conv_int8_launches = 0
# Calls of the library route (conv_int8_unfold) on the card since import.
conv_int8_unfold_calls = 0

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


def _sums_plain(x, w_q, ax, stride, padding):
    """The int32 sums of the quantized conv, as a float64 conv of the int8
    values (exact)."""
    xq = quantize_act(x, ax).double().permute(0, 3, 1, 2)
    acc = F.conv2d(xq, w_q.double(), None, stride, padding)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _sums_unfold(x, w_q, ax, stride, padding):
    """The same int32 sums through the library: the quantized x unfolded
    (in x's dtype, which holds int8 values exactly; unfold takes no int8),
    the patches to int8, then one ``torch._int_mm``, whose operands are
    zero-padded to what cuBLASLt takes (more than 16 rows, a depth and a
    width that are multiples of 8)."""
    B, H, W, Cin = x.shape
    N, _, kh, kw = w_q.shape
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    xq = quantize_act(x, ax).permute(0, 3, 1, 2)
    cols = F.unfold(xq, (kh, kw), padding=padding, stride=stride)
    a = cols.transpose(1, 2).reshape(-1, Cin * kh * kw).to(torch.int8)
    M, Kd = a.shape
    a = F.pad(a, (0, _round8(Kd) - Kd, 0, max(17, _round8(M)) - M))
    w = F.pad(w_q.reshape(N, Kd), (0, _round8(Kd) - Kd, 0,
                                   _round8(N) - N))
    acc = torch._int_mm(a, w.t())[:M, :N]
    return acc.reshape(B, Ho, Wo, N)


def _int8_call(sums, x, w_q, aw, ax, bias, stride, padding, dtype,
               accumulators, aux, aux_w_q, aux_aw, ax_aux, gamma, beta):
    """A NormConv2d's int8 call around ``sums`` (one of the functions
    above): dequantize, bias, aux's conv added in ``dtype``, the affine."""
    acc = sums(x, w_q, ax, stride, padding)
    if accumulators:
        if aux is None:
            return acc
        return acc, sums(aux, aux_w_q, ax_aux, stride, padding)
    dtype = dtype or x.dtype
    y = acc.float() * dequant_scale(ax, aw)
    if bias is not None:
        y = y + bias.float()
    y = y.to(dtype)
    if aux is not None:
        y = y + (sums(aux, aux_w_q, ax_aux, stride, padding).float()
                 * dequant_scale(ax_aux, aux_aw)).to(dtype)
    if gamma is not None:
        y = (gamma.reshape(-1).to(dtype) * y) + beta.reshape(-1).to(dtype)
    return y


def conv_int8_plain(x, w_q, aw, ax, bias=None, stride: int = 1,
                    dtype=None, accumulators: bool = False, *,
                    padding: int = 1, aux=None, aux_w_q=None, aux_aw=None,
                    ax_aux=None, gamma=None, beta=None):
    """The kernel's function in PyTorch.  x NHWC (bf16 or f32), w_q int8
    OIHW (N, Cin, kh, kw), aw (N,) f32, ax a 0-d f32 tensor, bias (N,) f32
    or None.  Returns NHWC in ``dtype`` (default x's), or with
    ``accumulators`` the int32 sums.

    With ``aux`` (NHWC, its own int8 weights ``aux_w_q``, ``aux_aw`` and
    scale ``ax_aux``) the two convs' outputs are added in ``dtype``, and
    with ``gamma`` and ``beta`` ((N,), rounded to ``dtype``) the result is
    ``gamma * y + beta``, each op rounded to ``dtype``: a NormConv2d's int8
    call.  With ``accumulators`` and ``aux`` it returns (acc_x, acc_aux).
    """
    return _int8_call(_sums_plain, x, w_q, aw, ax, bias, stride, padding,
                      dtype, accumulators, aux, aux_w_q, aux_aw, ax_aux,
                      gamma, beta)


def conv_int8_unfold(x, w_q, aw, ax, bias=None, stride: int = 1,
                     dtype=None, accumulators: bool = False, *,
                     padding: int = 1, aux=None, aux_w_q=None, aux_aw=None,
                     ax_aux=None, gamma=None, beta=None):
    """:func:`conv_int8_plain`'s function with the int32 sums from
    ``F.unfold`` + ``torch._int_mm``: the route on the card for the shapes
    the kernel does not take.  Equal to the plain version, sums and
    outputs."""
    global conv_int8_unfold_calls
    out = _int8_call(_sums_unfold, x, w_q, aw, ax, bias, stride, padding,
                     dtype, accumulators, aux, aux_w_q, aux_aw, ax_aux,
                     gamma, beta)
    if x.device.type == "cuda":
        conv_int8_unfold_calls += 1
    return out


def kernel_takes(kernel_size: int, padding: int, stride: int) -> bool:
    """Whether the int8 conv kernel computes a conv of this shape."""
    return (kernel_size, padding) == (3, 1) and stride in (1, 2)


# Output channels of one pass of the kernel (csrc/conv_int8.cu:
# pass_channels): every channel up to 128.
def _pass_channels(n: int) -> int:
    return 32 if n <= 32 else (64 if n <= 64 else 128)


class PackedWeights(NamedTuple):
    """W_q in the kernel's layout (ceil(Cin / 32), 9, Npad, 32) int8: K
    chunks of 32 input channels, each tap's Npad rows of 32 bytes, zero
    past N and Cin (Npad: N rounded up to 32, 64 or a multiple of 128),
    the rows of each block of 32 in :data:`ROW_ORDER`; aw zero-padded to
    (Npad,) in channel order; and the true N and Cin."""
    w: torch.Tensor
    aw: torch.Tensor
    n: int
    cin: int


# Row r = 8 nt + k of each block of 32 packed rows holds output channel
# 8 (k // 2) + 2 nt + k % 2: the mma accumulators of n8 block nt that lane
# (gid, tig) holds, columns 2 tig and 2 tig + 1, are then channels
# 8 tig + 2 nt and 8 tig + 2 nt + 1, so each lane's 8 outputs of a pixel are
# adjacent (csrc/conv_int8.cu: epilogue).
ROW_ORDER = tuple(8 * (k // 2) + 2 * nt + k % 2
                  for nt in range(4) for k in range(8))


def _npad(n: int) -> int:
    return -(-n // 128) * 128 if n > 64 else _pass_channels(n)


def pack_weights(w_q: torch.Tensor, aw: torch.Tensor) -> PackedWeights:
    N, Cin = w_q.shape[:2]
    npad = _npad(N)
    chunks = -(-Cin // 32)
    w = torch.zeros(npad, 9, chunks * 32, dtype=torch.int8,
                    device=w_q.device)
    w[:N, :, :Cin] = w_q.permute(0, 2, 3, 1).reshape(N, 9, Cin)
    order = torch.tensor(ROW_ORDER, device=w.device)
    rows = (torch.arange(0, npad, 32, device=w.device)[:, None]
            + order[None, :]).reshape(-1)
    w = w[rows].reshape(npad, 9, chunks, 32).permute(2, 1, 0, 3).contiguous()
    awp = torch.zeros(npad, dtype=torch.float32, device=aw.device)
    awp[:N] = aw
    return PackedWeights(w, awp, N, Cin)


def unpack_weights(packed: PackedWeights):
    """(W_q int8 OIHW, aw (N,)) back from :func:`pack_weights`."""
    chunks, _, npad, _ = packed.w.shape
    w = packed.w.permute(2, 1, 0, 3).reshape(npad, 9, chunks * 32)
    order = torch.tensor(ROW_ORDER, device=w.device)
    rows = (torch.arange(0, npad, 32, device=w.device)[:, None]
            + order[None, :]).reshape(-1)
    w = torch.empty_like(w).index_copy_(0, rows, w)
    w = w[:packed.n, :, :packed.cin].reshape(packed.n, 3, 3, packed.cin)
    return w.permute(0, 3, 1, 2).contiguous(), packed.aw[:packed.n].clone()


@functools.cache
def _lib():
    lib = load_library("conv_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_conv_int8.argtypes = ([p, p, i] + [p] * 11 + [i] * 9 + [p])
    lib.bdvs_conv_int8.restype = i
    lib.bdvs_conv_int8_plan.argtypes = [i] * 11 + [p]
    lib.bdvs_conv_int8_plan.restype = i
    return lib


def _check_packed(packed: PackedWeights, what: str) -> None:
    chunks = -(-packed.cin // 32)
    if (packed.w.dtype != torch.int8 or packed.w.dim() != 4
            or tuple(packed.w.shape[:2]) != (chunks, 9)
            or packed.w.shape[3] != 32 or not packed.w.is_contiguous()
            or packed.aw.dtype != torch.float32
            or packed.aw.numel() != packed.w.shape[2]):
        raise TypeError(f"{what} are not pack_weights' layout")


def conv_int8_packed(x: torch.Tensor, packed: PackedWeights,
                     ax: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: int = 1, dtype=None,
                     accumulators: bool = False, *,
                     aux: Optional[torch.Tensor] = None,
                     aux_packed: Optional[PackedWeights] = None,
                     ax_aux: Optional[torch.Tensor] = None,
                     gamma: Optional[torch.Tensor] = None,
                     beta: Optional[torch.Tensor] = None):
    """One launch of the kernel on CUDA tensors: x NHWC bf16 or f32,
    ``packed`` from :func:`pack_weights`, ax a 0-d f32 tensor, bias (N,)
    f32 or None; optionally aux (NHWC, x's dtype, its own ``aux_packed``
    and ``ax_aux``) and gamma and beta ((N,), rounded to ``dtype``).  Returns
    NHWC in ``dtype`` (bf16 or f32, default x's), or with ``accumulators``
    the int32 sums ((acc_x, acc_aux) with aux)."""
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
    _check_packed(packed, "the weights")
    N = packed.n
    out_dtype = torch.int32 if accumulators else (dtype or x.dtype)
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"the int8 conv kernel writes bf16, f32 or int32, "
                        f"not {out_dtype}")
    tensors = [x, packed.w, packed.aw, ax] + (
        [bias] if bias is not None else [])
    if aux is not None:
        if aux_packed is None or ax_aux is None:
            raise ValueError("aux needs its packed weights and its scale "
                             "ax_aux")
        if aux.dtype != x.dtype or aux.shape[:3] != x.shape[:3]:
            raise TypeError(f"aux must be NHWC like x ({x.dtype}, "
                            f"{tuple(x.shape[:3])}), got {aux.dtype} of "
                            f"shape {tuple(aux.shape)}")
        if aux.shape[3] != aux_packed.cin:
            raise ValueError(f"aux has {aux.shape[3]} channels, its weights "
                             f"{aux_packed.cin}")
        _check_packed(aux_packed, "aux's weights")
        if aux_packed.n != N or aux_packed.w.shape[2] != packed.w.shape[2]:
            raise ValueError(f"aux's weights have {aux_packed.n} output "
                             f"channels, x's {N}")
        if ax_aux.numel() != 1 or ax_aux.dtype != torch.float32:
            raise TypeError("ax_aux must be one f32 value")
        tensors += [aux, aux_packed.w, aux_packed.aw, ax_aux]
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta come together")
    if gamma is not None and not accumulators:
        if gamma.numel() != N or beta.numel() != N:
            raise ValueError(f"gamma and beta must have {N} values, got "
                             f"{gamma.numel()} and {beta.numel()}")
        # f32 here; the kernel rounds them to the output dtype
        gamma = gamma.reshape(-1).float().contiguous()
        beta = beta.reshape(-1).float().contiguous()
        tensors += [gamma, beta]
    else:
        gamma = beta = None
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, aux, the weights, the scales, bias, gamma and "
                         "beta must share a device")
    if ax.numel() != 1 or ax.dtype != torch.float32:
        raise TypeError("ax must be one f32 value")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.numel() != N):
        raise TypeError(f"bias must be ({N},) f32")

    def aligned(t):             # the kernel loads 16-byte vectors
        t = t.contiguous()
        return t.clone() if t.data_ptr() % 16 else t
    x = aligned(x)
    aux = aligned(aux) if aux is not None else None
    bias = bias.contiguous() if bias is not None else None
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, Ho, Wo, N, dtype=out_dtype, device=x.device)
    out_aux = (torch.empty_like(out) if accumulators and aux is not None
               else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    launch(_lib().bdvs_conv_int8, "int8 conv kernel launch", x.device,
           x.data_ptr(), ptr(aux), int(x.dtype == torch.bfloat16),
           packed.w.data_ptr(), ptr(aux_packed.w if aux is not None
                                    else None),
           packed.aw.data_ptr(), ptr(aux_packed.aw if aux is not None
                                     else None),
           ax.contiguous().data_ptr(),
           ptr(ax_aux.contiguous() if aux is not None else None),
           ptr(bias), ptr(gamma), ptr(beta), out.data_ptr(), ptr(out_aux),
           _OUT_KIND[out_dtype], B, H, W, Cin,
           aux.shape[3] if aux is not None else 0, N, packed.w.shape[2],
           stride)
    conv_int8_launches += 1
    return (out, out_aux) if out_aux is not None else out


def conv_int8_plan(B, H, W, cin, n, *, stride=1, aux_cin=0,
                   dtype=torch.bfloat16, out_dtype=None, device=None):
    """The launch the kernel makes for these shapes, without launching:
    {grid, blocks_per_sm, ring, w_resident, smem_bytes, tiles,
    piece_bytes, threads, tile_rows}."""
    info = (ctypes.c_int * 9)()
    launch(_lib().bdvs_conv_int8_plan, "int8 conv kernel plan", device,
           int(dtype == torch.bfloat16), int(aux_cin > 0),
           _OUT_KIND[out_dtype or dtype], B, H, W, cin, aux_cin, n, _npad(n),
           stride, ctypes.addressof(info), stream=False)
    return dict(zip(("grid", "blocks_per_sm", "ring", "w_resident",
                     "smem_bytes", "tiles", "piece_bytes", "threads",
                     "tile_rows"), list(info)))


def conv_int8(x, w_q, aw, ax, bias=None, stride: int = 1, dtype=None,
              packed: Optional[PackedWeights] = None, *, padding: int = 1,
              aux=None, aux_w_q=None, aux_aw=None, ax_aux=None,
              aux_packed: Optional[PackedWeights] = None, gamma=None,
              beta=None):
    """The int8 conv of NHWC x with prepared weights (w_q, aw), with the
    optional aux input and affine of :func:`conv_int8_plain`: for a CUDA
    tensor the kernel where it takes the shape (:func:`kernel_takes`),
    which needs ``packed`` (and ``aux_packed``; :func:`pack_weights` of
    them, made once by the caller), else :func:`conv_int8_unfold`; the
    plain version for a CPU tensor."""
    kw = dict(padding=padding, aux=aux, aux_w_q=aux_w_q, aux_aw=aux_aw,
              ax_aux=ax_aux, gamma=gamma, beta=beta)
    if x.device.type == "cpu":
        return conv_int8_plain(x, w_q, aw, ax, bias, stride, dtype, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {x.device}")
    if not kernel_takes(w_q.shape[-1], padding, stride) \
            or w_q.shape[-2] != w_q.shape[-1]:
        return conv_int8_unfold(x, w_q, aw, ax, bias, stride, dtype, **kw)
    if packed is None or (aux is not None and aux_packed is None):
        raise ValueError("a CUDA int8 conv needs its packed weights "
                         "(pack_weights, made once per set of weights)")
    return conv_int8_packed(x, packed, ax, bias, stride, dtype, aux=aux,
                            aux_packed=aux_packed, ax_aux=ax_aux,
                            gamma=gamma, beta=beta)
