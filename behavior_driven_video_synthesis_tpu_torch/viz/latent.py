"""Latent-space helpers of the figures: slerp paths through behavior space.

Counterpart of ``behavior_driven_video_synthesis_tpu/viz/latent.py``
(``slerp`` :9-18, ``latent_interpolate`` :21-25), host numpy as there.
"""
from __future__ import annotations

import numpy as np


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interpolation between two latent vectors; linear where
    they are parallel."""
    low_n = low / np.linalg.norm(low)
    high_n = high / np.linalg.norm(high)
    omega = np.arccos(np.clip(np.dot(low_n, high_n), -1.0, 1.0))
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high
    return (np.sin((1.0 - val) * omega) / so * low
            + np.sin(val * omega) / so * high)


def latent_interpolate(b_start: np.ndarray, b_end: np.ndarray,
                       n_steps: int = 10) -> np.ndarray:
    """(H,) x 2 -> (n_steps, H) slerp path through behavior space."""
    vals = np.linspace(0.0, 1.0, n_steps)
    return np.stack([slerp(float(v), b_start, b_end) for v in vals])
