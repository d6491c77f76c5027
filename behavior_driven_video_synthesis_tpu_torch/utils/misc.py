"""Small shared helpers (reference lib/utils.py).

Counterpart of ``behavior_driven_video_synthesis_tpu/utils/misc.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def prepare_input(x):
    """Teacher-forcing split: (x[:, :-1], x[:, 1:])
    (reference lib/utils.py:914-917)."""
    return x[:, :-1], x[:, 1:]


def scale_img(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped (reference lib/utils.py:658-668)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def valid_joints(*joints) -> bool:
    """Whether every coordinate of every joint is >= 0."""
    j = np.stack([np.asarray(v) for v in joints])
    return bool((j >= 0).all())
