"""The velocity action classifier of the behavior experiment: a 1D-conv
ResNet with GroupNorm.

Counterpart of ``_BasicBlock1D`` and ``SequenceDiscMichael`` in
``behavior_driven_video_synthesis_tpu/models/discriminators.py``.  It runs
``Conv1d`` over (B, C, T) as the reference does, keeps the reference's
state-dict names (``conv1``, ``bn1``, ``layer{1,2}.{i}.{conv1,bn1,conv2,
bn2,downsample.{0,1}}``, ``fc``) and flattens the final (B, 32, T') map
C-major into ``fc``, as the reference does (the flax module flattens
T-major; ``models/convert.py`` permutes between the two).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn


def _conv3(cin: int, cout: int, stride: int = 1, device=None) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, 3, stride=stride, padding=1, bias=False,
                     device=device)


def _out_length(length: int) -> int:
    """Length after a kernel-3, stride-2, padding-1 convolution."""
    return (length - 1) // 2 + 1


class BasicBlock1D(nn.Module):
    """(Conv1d, GroupNorm(4)) x2 with ReLU between, plus a strided
    (Conv1d, GroupNorm(16)) shortcut when the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
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
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class SequenceDiscMichael(nn.Module):
    """(B, T, n_in) sequences (frame differences in the behavior
    experiment) -> (logits (B, out_dim), features (B, 32, T'))."""

    def __init__(self, n_in: int, seq_len: int,
                 layers: Sequence[int] = (2, 1, 1, 1), out_dim: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = _conv3(n_in, 64, 1, device)
        self.bn1 = nn.GroupNorm(4, 64, eps=1e-5, device=device)
        cin, length = 64, seq_len
        for i, planes in enumerate((64, 32)):
            blocks = [BasicBlock1D(cin, planes, 2, device)]
            blocks += [BasicBlock1D(planes, planes, 1, device)
                       for _ in range(1, layers[i])]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin, length = planes, _out_length(length)
        self.fc = nn.Linear(32 * length, out_dim, bias=False, device=device)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x.transpose(1, 2))))
        feat = self.layer2(self.layer1(h))
        return self.fc(feat.reshape(feat.shape[0], -1)), feat
