"""Keypoint z-score normalization with degenerate dimensions dropped.

Counterpart of ``behavior_driven_video_synthesis_tpu/geometry/
normalization.py:1-64``: mean and std over the full (N, D) data matrix,
dimensions with std < 1e-4 dropped (``dim_to_ignore``, their std set to
1), the rest z-scored.  Numpy in, numpy out; :func:`unnormalize` also takes
a torch tensor, on any device, and returns one there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NormStats:
    mean: np.ndarray          # (D,)
    std: np.ndarray           # (D,) with ignored dims set to 1.0
    dim_to_use: np.ndarray    # indices with std >= 1e-4
    dim_to_ignore: np.ndarray  # indices with std < 1e-4

    @property
    def full_dim(self) -> int:
        return int(self.mean.shape[0])


def normalization_stats(complete_data: np.ndarray,
                        eps: float = 1e-4) -> NormStats:
    """Mean, std and dim_to_use of an (N, D) data matrix."""
    mean = np.mean(complete_data, axis=0)
    std = np.std(complete_data, axis=0)
    dim_to_ignore = np.where(std < eps)[0]
    dim_to_use = np.where(std >= eps)[0]
    std = std.copy()
    std[dim_to_ignore] = 1.0
    return NormStats(mean=mean.astype(np.float32), std=std.astype(np.float32),
                     dim_to_use=dim_to_use, dim_to_ignore=dim_to_ignore)


def normalize(data, stats: NormStats) -> np.ndarray:
    """(..., D) full-dim data -> (..., d_use) z-scored, reduced data, in
    float32 (the JAX function's dtype)."""
    z = (np.asarray(data, np.float32) - stats.mean) / stats.std
    return z[..., stats.dim_to_use]


def unnormalize(normed, stats: NormStats):
    """(..., d_use) -> (..., D): scattered back into the full dims and
    un-z-scored; ignored dims come back as their (constant) mean."""
    if isinstance(normed, torch.Tensor):
        full = normed.new_zeros(normed.shape[:-1] + (stats.full_dim,))
        full[..., torch.as_tensor(stats.dim_to_use,
                                  device=normed.device)] = normed
        return (full * torch.as_tensor(stats.std, device=normed.device)
                + torch.as_tensor(stats.mean, device=normed.device))
    normed = np.asarray(normed)
    full = np.zeros(normed.shape[:-1] + (stats.full_dim,), normed.dtype)
    full[..., stats.dim_to_use] = normed
    return full * stats.std + stats.mean


def revert_output_format(poses, stats: NormStats):
    """The reference's name for :func:`unnormalize`."""
    return unnormalize(poses, stats)
