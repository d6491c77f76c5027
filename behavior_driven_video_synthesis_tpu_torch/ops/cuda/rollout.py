"""The residual-LSTM decoder rollout: CUDA kernel wrapper, its operand
preparation and its plain version.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/pallas/rollout.py``.
The kernel (``csrc/rollout.cu``) runs all T steps in one launch with bf16
weights and f32 state, and sums in a fixed order, so that two launches on
the same operands give equal bits; :func:`residual_lstm_rollout_plain` is
the same function as a loop of torch ops.  Weights come in torch layouts:
``weight_ih`` (4H, K), ``weight_hh`` (4H, H), ``weight_out`` (K, H).

The kernel takes its weights prepared (:func:`pack_operands`): bf16, padded
and interleaved as its blocks copy them.  A decoder keeps its own
(``ResidualDecoder.rollout_operands``, ``models/behavior.py``), built once
and kept while its parameters are unchanged;
:func:`residual_lstm_rollout_prepared` launches on them with nothing cast
on the way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import launch, load_library

# Launches of the kernel since import (or since a caller last reset it).
rollout_launches = 0


def residual_lstm_rollout_plain(b, x0, weight_ih, weight_hh, bias_ih,
                                bias_hh, weight_out, bias_out, length: int,
                                operand_dtype=torch.float32):
    """The rollout as a Python loop of torch ops; returns (B, length, K).

    ``operand_dtype=torch.float32`` is the JAX package's scan fallback
    (``use_pallas=False``); ``torch.bfloat16`` rounds x, h, h' and the
    weights to bf16 before each product, as the kernel does, and still
    accumulates in f32.
    """
    def operand(v):
        return v.to(operand_dtype).float()

    w_ih, w_hh = operand(weight_ih).t(), operand(weight_hh).t()
    w_out = operand(weight_out).t()
    bias = (bias_ih + bias_hh).float()
    b_out = bias_out.float()
    h = c = b.float()
    x = x0.float()
    xs = []
    for _ in range(length):
        gates = operand(x) @ w_ih + operand(h) @ w_hh + bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        x = x + (operand(h) @ w_out + b_out)
        xs.append(x)
    return torch.stack(xs, dim=1)


def padded(n: int) -> int:
    """n rounded up to 16: the depth of one mma.sync k-step."""
    return -(-n // 16) * 16


def _check_hidden(H):
    if H % 8 != 0:
        raise ValueError(f"the rollout kernel needs H % 8 == 0, got H={H}")


def pack_operands(weight_ih, weight_hh, bias_ih, bias_hh, weight_out,
                  bias_out):
    """The kernel's operands (w, bias, w_out, b_out) from torch-layout
    weights, on their device:

    - w (4H, Hp + Kp) bf16: [W_hh | W_ih], H and K each zero-padded to a
      multiple of 16, rows interleaved so that row 4u + g is gate g (i, f,
      g, o) of unit u: a block's units are one contiguous run of rows;
    - bias (4H,) f32: b_ih + b_hh in the same row order;
    - w_out (H, K) bf16: W_out transposed;
    - b_out (K,) f32.
    """
    H, K = weight_hh.shape[1], weight_ih.shape[1]
    _check_hidden(H)
    Hp = padded(H)
    with torch.no_grad():
        w = torch.zeros(H, 4, Hp + padded(K), dtype=torch.bfloat16,
                        device=weight_hh.device)
        w[:, :, :H] = weight_hh.reshape(4, H, H).transpose(0, 1)
        w[:, :, Hp:Hp + K] = weight_ih.reshape(4, H, K).transpose(0, 1)
        bias = (bias_ih + bias_hh).float().reshape(4, H).t()
        return (w.reshape(4 * H, -1), bias.reshape(-1).contiguous(),
                weight_out.t().to(torch.bfloat16).contiguous(),
                bias_out.float().contiguous())


def unpack_operands(operands):
    """The inverse of :func:`pack_operands`: (weight_ih (4H, K), weight_hh
    (4H, H), bias (4H,) = b_ih + b_hh, weight_out (K, H), bias_out (K,)) in
    torch layouts, the weights in bf16."""
    w, bias, w_out, b_out = operands
    H, K = w_out.shape
    Hp = padded(H)
    w = w.reshape(H, 4, -1).transpose(0, 1)
    return (w[:, :, Hp:Hp + K].reshape(4 * H, K),
            w[:, :, :H].reshape(4 * H, H), bias.reshape(H, 4).t().reshape(-1),
            w_out.t(), b_out)


def residual_lstm_rollout_prepared_plain(b, x0, operands, length: int):
    """The kernel's function on prepared operands, as a loop of torch ops:
    bf16 operands, f32 accumulation and state."""
    w_ih, w_hh, bias, w_out, b_out = unpack_operands(operands)
    return residual_lstm_rollout_plain(
        b, x0, w_ih, w_hh, bias, torch.zeros_like(bias), w_out, b_out,
        length, operand_dtype=torch.bfloat16)


def _check(b, x0, weight_ih, weight_hh, bias_ih, bias_hh, weight_out,
           bias_out, length):
    tensors = dict(b=b, x0=x0, weight_ih=weight_ih, weight_hh=weight_hh,
                   bias_ih=bias_ih, bias_hh=bias_hh, weight_out=weight_out,
                   bias_out=bias_out)
    for name, v in tensors.items():
        if v.device != b.device:
            raise ValueError(f"{name} is on {v.device}, b on {b.device}")
        if not v.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {v.dtype}")
    check_no_grad(tensors.values())
    if b.dim() != 2 or x0.dim() != 2 or x0.shape[0] != b.shape[0]:
        raise ValueError(f"b must be (B, H) and x0 (B, K); got "
                         f"{tuple(b.shape)} and {tuple(x0.shape)}")
    (B, H), K = b.shape, x0.shape[1]
    expected = dict(weight_ih=(4 * H, K), weight_hh=(4 * H, H),
                    bias_ih=(4 * H,), bias_hh=(4 * H,), weight_out=(K, H),
                    bias_out=(K,))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    _check_hidden(H)
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")


def check_no_grad(tensors):
    if torch.is_grad_enabled() and any(v.requires_grad for v in tensors):
        raise RuntimeError("the rollout kernel has no backward; call it "
                           "under torch.no_grad() or inference_mode()")


@functools.cache
def _lib():
    lib = load_library("rollout")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_residual_lstm_rollout.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.bdvs_residual_lstm_rollout.restype = i
    lib.bdvs_rollout_config.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.bdvs_rollout_config.restype = i
    lib.bdvs_rollout_barrier_floor.argtypes = [i] * 4 + [p]
    lib.bdvs_rollout_barrier_floor.restype = i
    return lib


@functools.cache
def _blocks(B: int, K: int, H: int, device_index: int) -> int:
    with torch.cuda.device(device_index):
        return rollout_config(B, K, H)["blocks"]


def rollout_config(B: int, K: int, H: int) -> dict:
    """The kernel's launch configuration on the current CUDA device."""
    out = (ctypes.c_int * 4)()
    launch(_lib().bdvs_rollout_config, "rollout config", None, B, K, H, out,
           stream=False)
    return dict(blocks=out[0], units_per_block=out[1], smem_bytes=out[2],
                weights_in_smem=bool(out[3]))


def barrier_floor(B: int, K: int, H: int, length: int, device) -> None:
    """Launch ``length`` grid barriers and nothing else on the grid the
    kernel takes at (B, K, H): timed, the least time a rollout of that many
    serial steps can take.  Not a rollout; counts no launch."""
    launch(_lib().bdvs_rollout_barrier_floor, "barrier kernel launch",
           device, B, K, H, length)


def residual_lstm_rollout_prepared(b, x0, operands, length: int):
    """One launch of the kernel from h = c = b and pose x0 on CUDA tensors
    and operands from :func:`pack_operands`: (B, length, K) f32."""
    global rollout_launches
    w, bias, w_out, b_out = operands
    H, K = w_out.shape
    if b.device.type != "cuda":
        raise ValueError(f"no rollout for device {b.device}")
    for name, v in dict(x0=x0, w=w, bias=bias, w_out=w_out,
                        b_out=b_out).items():
        if v.device != b.device:
            raise ValueError(f"{name} is on {v.device}, b on {b.device}")
    check_no_grad((b, x0))
    B = b.shape[0]
    if tuple(b.shape) != (B, H) or tuple(x0.shape) != (B, K):
        raise ValueError(f"b must be (B, {H}) and x0 (B, {K}); got "
                         f"{tuple(b.shape)} and {tuple(x0.shape)}")
    if tuple(w.shape) != (4 * H, padded(H) + padded(K)) \
            or w.dtype != torch.bfloat16 or not w.is_contiguous():
        raise ValueError(f"w of shape {tuple(w.shape)} ({w.dtype}) is not "
                         f"the packed weight of H={H}, K={K}")
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")
    x0 = x0.detach().float().contiguous()
    c = b.detach().float().clone(memory_format=torch.contiguous_format)
    h = torch.empty(2, B, H, dtype=torch.bfloat16, device=b.device)
    h[0] = b.detach()
    # each block's share of h' W_out, summed into delta in a fixed order:
    # the kernel's result does not vary from launch to launch
    blocks = _blocks(B, K, H, b.device.index)
    partial = torch.empty(blocks, B, K, dtype=torch.float32, device=b.device)
    delta = torch.empty(length, B, K, dtype=torch.float32, device=b.device)
    out = torch.empty(B, length, K, dtype=torch.float32, device=b.device)
    launch(_lib().bdvs_residual_lstm_rollout, "rollout kernel launch",
           b.device, x0.data_ptr(), c.data_ptr(), w.data_ptr(),
           bias.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), h.data_ptr(),
           partial.data_ptr(), delta.data_ptr(), out.data_ptr(), B, K, H,
           length)
    rollout_launches += 1
    return out


def residual_lstm_rollout(b, x0, weight_ih, weight_hh, bias_ih, bias_hh,
                          weight_out, bias_out, length: int):
    """Roll out ``length`` steps from h = c = b and pose x0: (B, length, K).

    CUDA tensors pack the operands and launch the kernel (or raise); CPU
    tensors run the plain version in f32, as the JAX package runs its scan
    off the TPU.
    """
    args = (b, x0, weight_ih, weight_hh, bias_ih, bias_hh, weight_out,
            bias_out)
    if b.device.type == "cpu":
        return residual_lstm_rollout_plain(*args, length)
    if b.device.type != "cuda":
        raise ValueError(f"no rollout for device {b.device}")
    _check(*args, length)
    return residual_lstm_rollout_prepared(
        b, x0, pack_operands(*args[2:]), length)
