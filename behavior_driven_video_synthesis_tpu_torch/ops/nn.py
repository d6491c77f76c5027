"""NN primitives of the serving path, NHWC at every public function.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/nn.py``.  Images
stay NHWC as in the JAX package; a conv views its NHWC input as an NCHW
tensor in ``torch.channels_last`` memory format (a free permute), so cuDNN
runs its NHWC kernels and the result permutes back to NHWC without a copy.

Parameters are float32 and keep the reference's state-dict names
(``conv.weight_v``, ``conv.weight_g``, ``conv.bias``, ``gamma``, ``beta``;
``main.{2k}.weight``); ``dtype`` is the compute dtype, as in the JAX
modules.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def space_to_depth(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """NHWC space->depth; channel (i*bs + j)*C + c <- pixel (h*bs+i, w*bs+j)."""
    n, h, w, c = x.shape
    bs = block_size
    x = x.reshape(n, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // bs, w // bs, bs * bs * c)


def depth_to_space(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """NHWC depth->space, inverse of :func:`space_to_depth`.

    Channels factor as (i, j, C') in C order.  ``torch.nn.PixelShuffle``
    factors them as (C', i, j) and would scramble converted weights.
    """
    n, h, w, c = x.shape
    bs = block_size
    cc = c // (bs * bs)
    x = x.reshape(n, h, w, bs, bs, cc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * bs, w * bs, cc)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int,
                padding: int) -> torch.Tensor:
    """conv2d of an NHWC tensor with an OIHW kernel, returning NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1)


class _WeightNormParams(nn.Module):
    """The reference's ``weight_norm(nn.Conv2d)`` parameters: v (OIHW),
    g (O, 1, 1, 1) and the conv bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 device=None):
        super().__init__()
        k = kernel_size
        self.weight_v = nn.Parameter(
            torch.empty(features, in_channels, k, k, device=device))
        self.weight_g = nn.Parameter(
            torch.ones(features, 1, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


class NormConv2d(nn.Module):
    """Weight-normalized conv with learned per-channel scale and shift.

    W = g * v / sqrt(sum(v^2) + 1e-12), the norm running over (cin, kh, kw)
    per output channel; y = gamma * (conv(x, W) + bias) + beta, with bias,
    gamma and beta cast to the compute dtype.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, quant: str = "none",
                 d2s_transpose: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        if quant != "none":
            raise NotImplementedError(
                f"NormConv2d quant={quant!r} is not ported yet")
        if d2s_transpose:
            raise NotImplementedError(
                "NormConv2d d2s_transpose is not ported yet")
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.conv = _WeightNormParams(in_channels, features, kernel_size,
                                      device)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, 1,
                                             device=device))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, 1,
                                             device=device))

    def kernel(self) -> torch.Tensor:
        v = self.conv.weight_v
        v_norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True)
                            + 1e-12)
        return v * (self.conv.weight_g / v_norm)

    def forward(self, x: torch.Tensor,
                aux: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: NHWC.  aux: optional second input whose channels follow x's
        in the kernel's fan-in (the JAX package's split-kernel form)."""
        dt = self.dtype
        if aux is not None:
            x = torch.cat([x.to(dt), aux.to(dt)], dim=-1)
        y = conv2d_nhwc(x.to(dt), self.kernel().to(dt),
                        self.conv.bias.to(dt), self.stride, self.padding)
        return (self.gamma.to(dt).reshape(-1) * y
                + self.beta.to(dt).reshape(-1))


class NormDense(nn.Module):
    """Weight-normalized linear with per-feature gamma/beta, stored as the
    reference's 1x1 NormConv2d over (B, C, 1, 1)."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = _WeightNormParams(in_features, features, 1, device)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, 1,
                                             device=device))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, 1,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        v = self.conv.weight_v[:, :, 0, 0]                    # (out, in)
        v_norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True) + 1e-12)
        w = v * (self.conv.weight_g.reshape(-1, 1) / v_norm)
        y = F.linear(x.to(dt), w.to(dt), self.conv.bias.to(dt))
        return (self.gamma.to(dt).reshape(-1) * y
                + self.beta.to(dt).reshape(-1))


class Downsample(nn.Module):
    """Stride-2 3x3 NormConv2d."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.down = NormConv2d(in_channels, features, 3, stride=2,
                               padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.down(x)


class Upsample(nn.Module):
    """2x subpixel upsample: 3x3 NormConv2d to 4*features, depth_to_space."""

    def __init__(self, in_channels: int, features: int,
                 subpixel: bool = True, transpose: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if not subpixel:
            raise NotImplementedError(
                "bilinear Upsample (subpixel=False) is not ported yet")
        if transpose:
            raise NotImplementedError(
                "Upsample transpose=True is not ported yet")
        self.up = NormConv2d(in_channels, 4 * features, 3, padding=1,
                             dtype=dtype, device=device)

    def forward(self, x):
        return depth_to_space(self.up(x), 2)


class VunetRNB(nn.Module):
    """Pre-activation residual block in eval mode (no dropout):
    out = x + conv(elu([x] or [x, nin(elu(a))])).

    A residual block (``residual=True``) takes an auxiliary input of
    ``aux_channels`` channels through the 1x1 ``nin`` conv; its main conv
    then sees 2*channels.
    """

    def __init__(self, channels: int, residual: bool = False,
                 aux_channels: Optional[int] = None, kernel_size: int = 3,
                 activate: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.residual, self.activate = residual, activate
        if residual:
            self.nin = NormConv2d(aux_channels or channels, channels, 1,
                                  dtype=dtype, device=device)
        self.conv = NormConv2d((2 if residual else 1) * channels, channels,
                               kernel_size, padding=kernel_size // 2,
                               dtype=dtype, device=device)

    def _act(self, v):
        return F.elu(v) if self.activate else v

    def forward(self, x: torch.Tensor,
                a: Optional[torch.Tensor] = None) -> torch.Tensor:
        if a is not None:
            if not self.residual:
                raise ValueError("auxiliary input to a non-residual VunetRNB")
            a = self.nin(self._act(a))
            return x + self.conv(self._act(x), aux=self._act(a))
        return x + self.conv(self._act(x))


class FullyConnectedNet(nn.Module):
    """LeakyReLU MLP dim -> hidden x (depth+1) -> out_dim, optional tanh;
    ``main`` holds the reference's Sequential (Linear at even indices)."""

    def __init__(self, dim: int, depth: int, hidden_dim: int = 256,
                 use_tanh: bool = False, out_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        layers = [nn.Linear(dim, hidden_dim, device=device), nn.LeakyReLU()]
        for _ in range(depth):
            layers += [nn.Linear(hidden_dim, hidden_dim, device=device),
                       nn.LeakyReLU()]
        layers.append(nn.Linear(hidden_dim, dim if out_dim is None
                                else out_dim, device=device))
        if use_tanh:
            layers.append(nn.Tanh())
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        h = x.to(self.dtype)
        for layer in self.main:
            if isinstance(layer, nn.Linear):
                h = F.linear(h, layer.weight.to(self.dtype),
                             layer.bias.to(self.dtype))
            else:
                h = layer(h)
        return h
