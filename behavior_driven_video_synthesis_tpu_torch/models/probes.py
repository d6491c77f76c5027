"""Probe heads of the behavior experiment: the action classifiers and the
adversarial regressor trained beside the cVAE, and the post-hoc real/fake
classifier and start-pose regressor of the inference protocol; and the
MT-VAE's linear residual block.

Counterpart of ``Classifier``, ``ClassifierAction``,
``ClassifierActionBeta``, ``Regressor``, ``RegressorFly`` and ``FCResnet``
in ``behavior_driven_video_synthesis_tpu/models/probes.py:25-138``, with the
reference's state-dict names (``RNN.weight_ih_l0``, ``fc1``, ``fc3``;
``fc1``..``fc5``), which the JAX package's ``convert_*`` functions read,
and the same names for the two heads that have no reference converter
(``Classifier``: ``RNN``, a GRU, and ``fc``; ``Regressor``: ``fc1``..
``fc3``; ``FCResnet``: the reference's ``shortcut`` and ``fc1``..``fc3``).  Products run in ``dtype`` while the parameters stay float32,
as the flax modules' ``param_dtype=float32`` has it.  Unlike flax, torch
needs each input width up front.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.recurrent import GRU, LSTM


def linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Classifier(nn.Module):
    """A GRU over (B, T, n_in), classified from its final hidden state."""

    def __init__(self, n_in: int, n_classes: int, dim: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.RNN = GRU(n_in, dim, dtype=dtype, device=device)
        self.fc = nn.Linear(dim, n_classes, device=device)

    def forward(self, x):
        return linear(self.fc, self.RNN(x), self.dtype)


class ClassifierAction(nn.Module):
    """LSTM over (B, T, n_in), then fc1 (128, ReLU) and fc3; returns
    (logits, the 128 features)."""

    def __init__(self, n_in: int, n_classes: int, dim: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.RNN = LSTM(n_in, dim, dtype=dtype, device=device)
        self.fc1 = nn.Linear(dim, 128, device=device)
        self.fc3 = nn.Linear(128, n_classes, device=device)

    def forward(self, x):
        _, (h_last, _) = self.RNN(x, return_sequences=False)
        feat = F.relu(linear(self.fc1, h_last, self.dtype))
        return linear(self.fc3, feat, self.dtype), feat


class ClassifierActionBeta(nn.Module):
    """A linear probe over the behavior latent."""

    def __init__(self, n_in: int, n_classes: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(n_in, n_classes, device=device)

    def forward(self, b):
        return linear(self.fc1, b, self.dtype)


class Regressor(nn.Module):
    """A bottleneck MLP: n_in -> n_in/2 -> n_in/4 -> n_out."""

    def __init__(self, n_in: int, n_out: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(n_in, n_in // 2, device=device)
        self.fc2 = nn.Linear(n_in // 2, n_in // 4, device=device)
        self.fc3 = nn.Linear(n_in // 4, n_out, device=device)

    def forward(self, x):
        h = F.relu(linear(self.fc1, x, self.dtype))
        h = F.relu(linear(self.fc2, h, self.dtype))
        return linear(self.fc3, h, self.dtype)


class RegressorFly(nn.Module):
    """The adversarial bottleneck regressor: the pose at frame t from
    (b, one_hot(t)) through MLP(b) (fc1..fc3) beside fc4(one_hot(t)),
    concatenated into fc5."""

    def __init__(self, n_in: int, n_out: int, seq_length: int = 50,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        d = n_in
        self.fc1 = nn.Linear(d, d, device=device)
        self.fc2 = nn.Linear(d, d // 2, device=device)
        self.fc3 = nn.Linear(d // 2, d // 4, device=device)
        self.fc4 = nn.Linear(seq_length, 128, device=device)
        self.fc5 = nn.Linear(d // 4 + 128, n_out, device=device)

    def forward(self, b, t_onehot):
        dt = self.dtype
        h = F.relu(linear(self.fc1, b, dt))
        h = F.relu(linear(self.fc2, h, dt))
        h = F.relu(linear(self.fc3, h, dt))
        c = F.relu(linear(self.fc4, t_onehot, dt))
        return linear(self.fc5, torch.cat([h, c], dim=-1), dt)


class FCResnet(nn.Module):
    """relu(fc3(relu(fc2(relu(fc1(x)))))) + shortcut(x), fc1 and fc2 at
    out_dim / 2, through a LayerNorm without scale or bias (eps 1e-5, its
    statistics in float32 as flax computes them)."""

    def __init__(self, n_in: int, out_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        half = out_dim // 2
        self.shortcut = nn.Linear(n_in, out_dim, device=device)
        self.fc1 = nn.Linear(n_in, half, device=device)
        self.fc2 = nn.Linear(half, half, device=device)
        self.fc3 = nn.Linear(half, out_dim, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.relu(linear(self.fc1, x, dt))
        h = F.relu(linear(self.fc2, h, dt))
        out = F.relu(linear(self.fc3, h, dt)) + linear(self.shortcut, x, dt)
        return F.layer_norm(out.float(), out.shape[-1:], eps=1e-5).to(dt)
