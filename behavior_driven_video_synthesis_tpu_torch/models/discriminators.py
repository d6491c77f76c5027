"""The velocity action classifier of the behavior experiment: a 1D-conv
ResNet with GroupNorm.

Counterpart of ``_BasicBlock1D`` and ``SequenceDiscMichael`` in
``behavior_driven_video_synthesis_tpu/models/discriminators.py``.  It runs
``Conv1d`` over (B, C, T) as the reference does, keeps the reference's
state-dict names (``conv1``, ``bn1``, ``layer{1,2}.{i}.{conv1,bn1,conv2,
bn2,downsample.{0,1}}``, ``fc``) and flattens the final (B, 32, T') map
C-major into ``fc``, as the reference does (the flax module flattens
T-major; ``models/convert.py`` permutes between the two).  Convolutions
run in ``dtype`` with float32 parameters; GroupNorm takes its statistics
in float32 and returns ``dtype``, as flax's ``GroupNorm(dtype=...)``
does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import L2NormConv2d, VunetRNB, conv2d_nhwc
from ..ops.recurrent import LSTM


def _conv3(cin: int, cout: int, stride: int = 1, device=None) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, 3, stride=stride, padding=1, bias=False,
                     device=device)


def _conv(conv: nn.Conv1d, x, dtype):
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


def _norm(gn: nn.GroupNorm, x, dtype):
    return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).to(dtype)


def _out_length(length: int) -> int:
    """Length after a kernel-3, stride-2, padding-1 convolution."""
    return (length - 1) // 2 + 1


class BasicBlock1D(nn.Module):
    """(Conv1d, GroupNorm(4)) x2 with ReLU between, plus a strided
    (Conv1d, GroupNorm(16)) shortcut when the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3(cin, planes, stride, device)
        self.bn1 = nn.GroupNorm(4, planes, eps=1e-5, device=device)
        self.conv2 = _conv3(planes, planes, 1, device)
        self.bn2 = nn.GroupNorm(4, planes, eps=1e-5, device=device)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                _conv3(cin, planes, stride, device),
                nn.GroupNorm(16, planes, eps=1e-5, device=device))

    def forward(self, x):
        dt = self.dtype
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x, dt), dt))
        y = _norm(self.bn2, _conv(self.conv2, y, dt), dt)
        residual = x if self.downsample is None else _norm(
            self.downsample[1], _conv(self.downsample[0], x, dt), dt)
        return F.relu(y + residual)


class SequenceDiscMichael(nn.Module):
    """(B, T, n_in) sequences (frame differences in the behavior
    experiment) -> (logits (B, out_dim), features (B, 32, T'))."""

    def __init__(self, n_in: int, seq_len: int,
                 layers: Sequence[int] = (2, 1, 1, 1), out_dim: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3(n_in, 64, 1, device)
        self.bn1 = nn.GroupNorm(4, 64, eps=1e-5, device=device)
        cin, length = 64, seq_len
        for i, planes in enumerate((64, 32)):
            blocks = [BasicBlock1D(cin, planes, 2, dtype, device)]
            blocks += [BasicBlock1D(planes, planes, 1, dtype, device)
                       for _ in range(1, layers[i])]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin, length = planes, _out_length(length)
        self.fc = nn.Linear(32 * length, out_dim, bias=False, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.relu(_norm(self.bn1, _conv(self.conv1, x.transpose(1, 2), dt),
                         dt))
        feat = self.layer2(self.layer1(h))
        return F.linear(feat.reshape(feat.shape[0], -1),
                        self.fc.weight.to(dt)), feat


# -- the dormant discriminators and helpers (JAX discriminators.py:81-252) --

def _linear(layer: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class SequenceDisc(nn.Module):
    """Recurrent real/fake discriminator over (B, T, n_in): an LSTM's last
    h, ``n_layers_class`` ReLU Linears ``fc.{i}``, a Linear ``out`` to one
    logit.  Returns (logit, [h, each fc output]).  ``input_type``:
    "poses" feeds the poses, "changes" the frame differences, "combined"
    the differences and the poses concatenated on features."""

    def __init__(self, n_in: int, dim_hidden_rnn: int = 256,
                 n_layers_class: int = 2, dim_hidden_class: int = 128,
                 input_type: str = "poses", dtype=torch.float32,
                 device=None):
        super().__init__()
        if input_type not in ("poses", "changes", "combined"):
            raise ValueError(f"unknown input_type {input_type!r}")
        self.input_type, self.dtype = input_type, dtype
        self.rnn = LSTM(2 * n_in if input_type == "combined" else n_in,
                        dim_hidden_rnn, dtype=dtype, device=device)
        widths = [dim_hidden_rnn] + [dim_hidden_class] * n_layers_class
        self.fc = nn.ModuleList(nn.Linear(i, o, device=device)
                                for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1, device=device)

    def forward(self, x):
        if self.input_type == "changes":
            x = x[:, 1:] - x[:, :-1]
        elif self.input_type == "combined":
            x = torch.cat([x[:, 1:] - x[:, :-1], x[:, 1:]], dim=-1)
        _, (h, _) = self.rnn(x, return_sequences=False)
        feats = [h]
        for layer in self.fc:
            h = F.relu(_linear(layer, h, self.dtype))
            feats.append(h)
        return _linear(self.out, h, self.dtype), feats


class SequenceDiscConv(nn.Module):
    """Two-stage temporal-conv discriminator over (B, T, n_kps): ``conv1``
    spans all keypoints x ``temp_window`` frames at stride
    ``temp_stride`` (n_out positions), ``conv2`` all n_out positions x 3
    of the filters; both VALID, as in JAX's NHWC layout (its stage-2 map
    has H = n_out, W = n_filter and one channel).  The (W', C) map flattens
    W'-major into ReLU Linears ``fc.{i}`` and a Linear ``out``, with an
    optional sigmoid."""

    def __init__(self, n_kps: int, seq_len: int, temp_window: int = 10,
                 temp_stride: int = 5, n_filter: int = 16,
                 n_layers_class: int = 2, dim_hidden_class: int = 128,
                 use_sigmoid: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.use_sigmoid, self.dtype = use_sigmoid, dtype
        self.temp_stride = temp_stride
        n_out = (seq_len - temp_window) // temp_stride + 1
        self.conv1 = nn.Conv2d(1, n_filter, (n_kps, temp_window),
                               device=device)
        self.conv2 = nn.Conv2d(1, n_filter, (n_out, 3), device=device)
        widths = [(n_filter - 2) * n_filter] + [dim_hidden_class] \
            * n_layers_class
        self.fc = nn.ModuleList(nn.Linear(i, o, device=device)
                                for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1, device=device)

    def forward(self, x):
        dt = self.dtype

        def conv(layer, v, stride=1):
            return F.conv2d(v.to(dt), layer.weight.to(dt),
                            layer.bias.to(dt), (1, stride))
        # (B, 1, n_kps, T) -> (B, n_filter, 1, n_out)
        h = F.relu(conv(self.conv1, x.transpose(1, 2)[:, None],
                        self.temp_stride))
        # (B, 1, n_out, n_filter) -> (B, n_filter, 1, n_filter - 2)
        h = conv(self.conv2, h[:, :, 0].transpose(1, 2)[:, None])
        h = h[:, :, 0].transpose(1, 2).reshape(h.shape[0], -1)
        for layer in self.fc:
            h = F.relu(_linear(layer, h, dt))
        h = _linear(self.out, h, dt)
        return torch.sigmoid(h) if self.use_sigmoid else h


class MIDisc(nn.Module):
    """LeakyReLU(0.2) MLP discriminator (a mutual-information estimator's
    head): ``net.{i}`` Linears, then ``out`` to one logit."""

    def __init__(self, n_in: int, n_layers: int = 2, hidden_dim: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        widths = [n_in] + [hidden_dim] * n_layers
        self.net = nn.ModuleList(nn.Linear(i, o, device=device)
                                 for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1, device=device)

    def forward(self, x):
        for layer in self.net:
            x = F.leaky_relu(_linear(layer, x, self.dtype), 0.2)
        return _linear(self.out, x, self.dtype)


class MIDiscConv(nn.Module):
    """1x1-conv MI discriminator over flat latents (reference
    ``MIDiscConv1``): an L2NormConv2d ``conv_in``, ``n_layers`` VunetRNBs
    of 1x1 L2NormConv2d convs with LeakyReLU (slope 0.01), a LeakyReLU
    and an L2NormConv2d ``conv_out``, summed over H, W and C into a
    (B, 1) logit.  Its dropout is the plain one (the ELU+dropout kernel
    computes an ELU)."""

    def __init__(self, n_in: int, n_layers: int = 2, hidden_dim: int = 256,
                 dropout_prob: float = 0.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv_in = L2NormConv2d(n_in, hidden_dim, 1, dtype=dtype,
                                    device=device)
        self.blocks = nn.ModuleList(
            VunetRNB(hidden_dim, kernel_size=1, dropout_prob=dropout_prob,
                     conv_layer=L2NormConv2d, act_fn=self._leaky,
                     dtype=dtype, device=device)
            for _ in range(n_layers))
        self.conv_out = L2NormConv2d(hidden_dim, hidden_dim, 1, dtype=dtype,
                                     device=device)

    @staticmethod
    def _leaky(v):
        return F.leaky_relu(v, 0.01)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if x.dim() != 4:
            x = x.reshape(x.shape[0], 1, 1, -1)
        h = self.conv_in(x)
        for block in self.blocks:
            h = block(h, train=train, generator=generator)
        h = self.conv_out(self._leaky(h))
        return torch.sum(h, dim=(1, 2, 3))[:, None]


def _group_norm_nhwc(norm: nn.GroupNorm, x):
    return F.group_norm(x.permute(0, 3, 1, 2), norm.num_groups, norm.weight,
                        norm.bias, norm.eps).permute(0, 2, 3, 1)


class ResnetBlock2D(nn.Module):
    """Pre-activated GroupNorm conv residual block over NHWC (reference
    pose_discriminator.py:414-470): x + conv2(relu(norm2(conv1(relu(
    norm1(x)))))), with a ``shortcut`` conv when the width or the stride
    changes.  GroupNorm has max(1, C // 8) groups and eps 1e-5."""

    def __init__(self, n_in: int, n_out: int, n_hidden: int = 0,
                 kernel_size: int = 3, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        n_hidden = n_hidden or n_out
        pad = kernel_size // 2
        self.shortcut = (nn.Conv2d(n_in, n_out, kernel_size, stride, pad,
                                   device=device)
                         if n_in != n_out or stride > 1 else None)
        self.norm1 = nn.GroupNorm(max(1, n_in // 8), n_in, eps=1e-5,
                                  device=device)
        self.conv1 = nn.Conv2d(n_in, n_hidden, kernel_size, stride, pad,
                               device=device)
        self.norm2 = nn.GroupNorm(max(1, n_hidden // 8), n_hidden, eps=1e-5,
                                  device=device)
        self.conv2 = nn.Conv2d(n_hidden, n_out, kernel_size, 1, pad,
                               device=device)

    def _conv(self, layer, x):
        dt = self.dtype
        return conv2d_nhwc(x.to(dt), layer.weight.to(dt), layer.bias.to(dt),
                           layer.stride[0], layer.padding[0])

    def forward(self, x):
        res = x if self.shortcut is None else self._conv(self.shortcut, x)
        h = self._conv(self.conv1, F.relu(_group_norm_nhwc(self.norm1, x)))
        h = self._conv(self.conv2, F.relu(_group_norm_nhwc(self.norm2, h)))
        return h + res


class SelfAttention2D(nn.Module):
    """SAGAN-style self-attention over NHWC with 2x2 max-pooled keys and
    values (reference pose_discriminator.py:473-533): queries ``Wf``,
    keys ``Wg`` and values ``Wh`` are 1x1 convs without bias (C / down,
    C / down and C / 2 channels), the H * W positions flatten row-major,
    and the attended values go through ``Wv`` back to C channels, scaled
    by ``beta`` (1, 1, 1, 1), which starts at 0."""

    def __init__(self, channels: int, down_factor: int = 8,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        inter = channels // down_factor

        def conv(cin, cout):
            return nn.Conv2d(cin, cout, 1, bias=False, device=device)
        self.Wf, self.Wg = conv(channels, inter), conv(channels, inter)
        self.Wh = conv(channels, channels // 2)
        self.Wv = conv(channels // 2, channels)
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, 1, device=device))

    def _proj(self, layer, x):
        return F.linear(x, layer.weight[:, :, 0, 0].to(self.dtype))

    @staticmethod
    def _pool(x):          # NHWC, 2x2 windows at stride 2
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    def forward(self, x):
        B, H, W, C = x.shape
        h = x.to(self.dtype)
        f = self._proj(self.Wf, h).reshape(B, H * W, -1)
        g = self._pool(self._proj(self.Wg, h)).reshape(B, -1, f.shape[-1])
        v = self._pool(self._proj(self.Wh, h)).reshape(B, -1, C // 2)
        attn = torch.softmax(f @ g.transpose(1, 2), dim=-1)
        out = self._proj(self.Wv, (attn @ v).reshape(B, H, W, C // 2))
        return x + self.beta.to(self.dtype) * out
