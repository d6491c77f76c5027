"""Schedule controllers of the training steps.

Counterpart of ``behavior_driven_video_synthesis_tpu/core/schedules.py:
27-62``: the clipped linear ramp ``linear_var``, the information-bottleneck
controller ``update_gamma`` and the ``imax_scaling`` target schedule.
Each works on Python numbers and on tensors.
"""
from __future__ import annotations

import torch


def _clip(val, lo, hi):
    if isinstance(val, torch.Tensor):
        return torch.clamp(val, lo, hi)
    return min(max(val, lo), hi)


def linear_var(act_it, start_it, end_it, start_val, end_val, clip_min,
               clip_max):
    """Linear interpolation between (start_it, start_val) and (end_it,
    end_val), clipped to [clip_min, clip_max]."""
    slope = (end_val - start_val) / float(end_it - start_it)
    return _clip(slope * (act_it - start_it) + start_val, clip_min, clip_max)


def update_gamma(gamma, avg_kl, imax, gamma_step):
    """One step of the controller: gamma - gamma_step * (imax - kl),
    floored at 0; it raises the KL weight while KL > imax."""
    new_gamma = gamma - gamma_step * (imax - avg_kl)
    if isinstance(new_gamma, torch.Tensor):
        return torch.clamp(new_gamma, min=0.0)
    return max(new_gamma, 0.0)


def imax_schedule(step, total_steps, information_max, mode: str = "none"):
    """The ``imax_scaling`` target over the full ``total_steps``: "none"
    constant, "ascend" 0 -> imax, "descend" imax -> 0."""
    if mode == "none":
        return float(information_max)
    if mode == "ascend":
        return linear_var(step, 0, total_steps, 0.0, information_max, 0.0,
                          information_max)
    if mode == "descend":
        return linear_var(step, 0, total_steps, information_max, 0.0, 0.0,
                          information_max)
    raise ValueError(f"unknown imax_scaling mode: {mode}")
