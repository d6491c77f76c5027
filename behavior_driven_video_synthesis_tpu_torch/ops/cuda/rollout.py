"""The residual-LSTM decoder rollout: CUDA kernel wrapper and plain version.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/pallas/rollout.py``.
The kernel (``csrc/rollout.cu``) runs all T steps in one launch with bf16
weights and f32 state; :func:`residual_lstm_rollout_plain` is the same
function as a loop of torch ops.  Weights come in torch layouts:
``weight_ih`` (4H, K), ``weight_hh`` (4H, H), ``weight_out`` (K, H).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

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
        if v.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the rollout kernel has no backward; call it "
                               "under torch.no_grad() or inference_mode()")
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
    if H % 8 != 0:
        raise ValueError(f"the rollout kernel needs H % 8 == 0, got H={H}")
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")


@functools.cache
def _lib():
    lib = load_library("rollout")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdvs_residual_lstm_rollout.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.bdvs_residual_lstm_rollout.restype = i
    lib.bdvs_rollout_config.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.bdvs_rollout_config.restype = i
    return lib


def rollout_config(B: int, K: int, H: int) -> dict:
    """The kernel's launch configuration on the current CUDA device."""
    out = (ctypes.c_int * 4)()
    err = _lib().bdvs_rollout_config(B, K, H, out)
    if err:
        raise RuntimeError(f"rollout config failed: cudaError {err}")
    return dict(blocks=out[0], units_per_block=out[1], smem_bytes=out[2],
                w_hh_in_smem=bool(out[3]))


def residual_lstm_rollout(b, x0, weight_ih, weight_hh, bias_ih, bias_hh,
                          weight_out, bias_out, length: int):
    """Roll out ``length`` steps from h = c = b and pose x0: (B, length, K).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version in f32, as the JAX package runs its scan off the TPU.
    """
    global rollout_launches
    args = (b, x0, weight_ih, weight_hh, bias_ih, bias_hh, weight_out,
            bias_out)
    if b.device.type == "cpu":
        return residual_lstm_rollout_plain(*args, length)
    if b.device.type != "cuda":
        raise ValueError(f"no rollout for device {b.device}")
    _check(*args, length)
    (B, H), K = b.shape, x0.shape[1]
    dev = b.device
    bf16 = torch.bfloat16
    w_ih = weight_ih.detach().to(bf16).contiguous()
    w_hh = weight_hh.detach().to(bf16).contiguous()
    w_out = weight_out.detach().t().to(bf16).contiguous()      # (H, K)
    bias = (bias_ih + bias_hh).detach().float().contiguous()
    b_out = bias_out.detach().float().contiguous()
    x0_f = x0.detach().float().contiguous()
    c = b.detach().float().clone(memory_format=torch.contiguous_format)
    h = torch.empty(2, B, H, dtype=bf16, device=dev)
    h[0] = b.detach()
    delta = torch.zeros(length, B, K, dtype=torch.float32, device=dev)
    out = torch.empty(B, length, K, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().bdvs_residual_lstm_rollout(
            x0_f.data_ptr(), c.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
            bias.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            h.data_ptr(), delta.data_ptr(), out.data_ptr(),
            B, K, H, length, stream)
    if err:
        raise RuntimeError(f"rollout kernel launch failed: cudaError {err}")
    rollout_launches += 1
    return out
