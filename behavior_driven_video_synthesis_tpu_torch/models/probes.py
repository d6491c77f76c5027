"""Probe heads of the behavior experiment: the action classifiers and the
adversarial regressor trained beside the cVAE.

Counterpart of ``ClassifierAction``, ``ClassifierActionBeta`` and
``RegressorFly`` in ``behavior_driven_video_synthesis_tpu/models/probes.py``,
with the reference's state-dict names (``RNN.weight_ih_l0``, ``fc1``,
``fc3``; ``fc1``..``fc5``), which the JAX package's ``convert_*``
functions read.  Unlike flax, torch needs each input width up front.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.recurrent import LSTM


class ClassifierAction(nn.Module):
    """LSTM over (B, T, n_in), then fc1 (128, ReLU) and fc3; returns
    (logits, the 128 features)."""

    def __init__(self, n_in: int, n_classes: int, dim: int = 256,
                 device=None):
        super().__init__()
        self.RNN = LSTM(n_in, dim, device=device)
        self.fc1 = nn.Linear(dim, 128, device=device)
        self.fc3 = nn.Linear(128, n_classes, device=device)

    def forward(self, x):
        _, (h_last, _) = self.RNN(x, return_sequences=False)
        feat = F.relu(self.fc1(h_last))
        return self.fc3(feat), feat


class ClassifierActionBeta(nn.Module):
    """A linear probe over the behavior latent."""

    def __init__(self, n_in: int, n_classes: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(n_in, n_classes, device=device)

    def forward(self, b):
        return self.fc1(b)


class RegressorFly(nn.Module):
    """The adversarial bottleneck regressor: the pose at frame t from
    (b, one_hot(t)) through MLP(b) (fc1..fc3) beside fc4(one_hot(t)),
    concatenated into fc5."""

    def __init__(self, n_in: int, n_out: int, seq_length: int = 50,
                 device=None):
        super().__init__()
        d = n_in
        self.fc1 = nn.Linear(d, d, device=device)
        self.fc2 = nn.Linear(d, d // 2, device=device)
        self.fc3 = nn.Linear(d // 2, d // 4, device=device)
        self.fc4 = nn.Linear(seq_length, 128, device=device)
        self.fc5 = nn.Linear(d // 4 + 128, n_out, device=device)

    def forward(self, b, t_onehot):
        h = F.relu(self.fc1(b))
        h = F.relu(self.fc2(h))
        h = F.relu(self.fc3(h))
        c = F.relu(self.fc4(t_onehot))
        return self.fc5(torch.cat([h, c], dim=-1))
