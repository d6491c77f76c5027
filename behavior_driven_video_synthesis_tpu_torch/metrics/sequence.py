"""Sequence diversity and accuracy metrics of the behavior evaluation.

Counterpart of ``behavior_driven_video_synthesis_tpu/metrics/sequence.py:
24-116``, on torch tensors on any device:

  * APD — mean over samples of the sum of pairwise full-sequence L2
          distances, divided by (n_samples - 1)
  * ASD — mean over samples of the distance to the nearest other sample
          (per-frame L2, time-averaged)
  * FSD — the same on the final frame only
  * ADE — mean over the batch of the min over samples of the time-averaged
          per-frame L2 to the ground-truth future
  * FDE — the same on the final frame

Shapes: samples (B, S, T, K, 3), S rollouts per sequence; gt (B, T, K, 3).
Each metric is one batched op over all pairs, as in the JAX package: at
B=64, S=50, T=50, 17x3 the (B, S, S, T, K, 3) difference is 1.6 GB of
float32 on the device.  ``mse_euler_per_action`` is the per-action MSE
of expmap sequences after their conversion to Euler angles.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..geometry.rotations import expmap_to_rotmat, rotmat_to_euler


def _frame_norm(x):
    # (..., T, K, 3) -> (..., T): L2 over (K*3) per frame
    return torch.sqrt(torch.sum(x.reshape(x.shape[:-2] + (-1,)) ** 2, dim=-1))


def _pairwise_diff(x):
    # (B, S, ...) -> (B, S, S, ...)
    return x[:, :, None] - x[:, None]


def average_pairwise_distance(samples):
    """samples: (B, S, T, K, 3) -> scalar APD."""
    S = samples.shape[1]
    diff = _pairwise_diff(samples)
    dist = torch.sqrt(torch.sum(diff.reshape(diff.shape[:3] + (-1,)) ** 2,
                                dim=-1))                     # (B, S, S)
    per_query = torch.sum(dist, dim=-1) / (S - 1)            # (B, S)
    return torch.mean(torch.sum(per_query, dim=-1) / S)


def _nearest_other(dist):
    """dist (B, S, S) with a zero diagonal -> (B, S) distance to the
    nearest other sample."""
    S = dist.shape[-1]
    eye = torch.eye(S, dtype=torch.bool, device=dist.device)
    return torch.min(dist.masked_fill(eye, float("inf")), dim=-1).values


def average_self_distance(samples):
    """samples (B, S, T, K, 3) -> scalar ASD."""
    dist = torch.mean(_frame_norm(_pairwise_diff(samples)), dim=-1)
    return torch.mean(_nearest_other(dist))


def final_self_distance(samples):
    """samples (B, S, T, K, 3) -> scalar FSD."""
    diff = _pairwise_diff(samples[:, :, -1])                 # (B, S, S, K, 3)
    dist = torch.sqrt(torch.sum(diff.reshape(diff.shape[:3] + (-1,)) ** 2,
                                dim=-1))
    return torch.mean(_nearest_other(dist))


def average_displacement_error(samples, gt):
    """samples (B, S, T, K, 3), gt (B, T, K, 3) -> scalar ADE (min over
    S)."""
    per_sample = torch.mean(_frame_norm(samples - gt[:, None]), dim=-1)
    return torch.mean(torch.min(per_sample, dim=-1).values)


def final_displacement_error(samples, gt):
    diff = samples[:, :, -1] - gt[:, None, -1]               # (B, S, K, 3)
    dist = torch.sqrt(torch.sum(diff.reshape(diff.shape[:2] + (-1,)) ** 2,
                                dim=-1))
    return torch.mean(torch.min(dist, dim=-1).values)


def sequence_sample_metrics(samples, gt) -> Dict[str, torch.Tensor]:
    """All five metrics (0-d tensors on the samples' device)."""
    return {
        "APD": average_pairwise_distance(samples),
        "ASD": average_self_distance(samples),
        "FSD": final_self_distance(samples),
        "ADE": average_displacement_error(samples, gt),
        "FDE": final_displacement_error(samples, gt),
    }


def mse_euler_per_action(pred_expmap, gt_expmap, actions) -> Dict[int, float]:
    """{action label: MSE} of Euler angles: each of the 32 joints' expmaps
    of ``pred_expmap`` and ``gt_expmap`` ((N, T, 99) channels, tensors or
    arrays) converted to Euler angles, the squared error averaged over the
    sequences of each label in ``actions`` (N,)."""
    def to_euler(flat):
        flat = torch.as_tensor(flat)
        exps = flat[..., 3:99].reshape(flat.shape[:-1] + (32, 3))
        return rotmat_to_euler(expmap_to_rotmat(exps))

    sq = (to_euler(pred_expmap) - to_euler(gt_expmap)) ** 2
    actions = np.asarray(torch.as_tensor(actions).cpu())
    return {int(a): float(torch.mean(sq[torch.from_numpy(actions == a)
                                        .to(sq.device)]))
            for a in np.unique(actions)}
