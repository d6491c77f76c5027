"""Schedule controllers of the training steps.

Counterpart of ``behavior_driven_video_synthesis_tpu/core/schedules.py:
27-88``: the clipped linear ramp ``linear_var``, the information-bottleneck
controller ``update_gamma``, the ``imax_scaling`` target schedule, the
behavior net's ``multistep_lr``, ``linear_decay_lr`` (no config uses it)
and the original VUNet's ``kl_ramp``.  Each works on Python numbers; all
but the two learning-rate schedules also on tensors.
"""
from __future__ import annotations

from typing import Callable, Sequence

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


def multistep_lr(lr_init: float, n_steps: int, tau: Sequence[float],
                 gamma: float) -> Callable[[int], float]:
    """MultiStepLR as ``optax.piecewise_constant_schedule``: the rate after
    ``count`` updates is lr_init times ``gamma`` for each boundary
    int(t * n_steps), t in ``tau``, with count >= boundary.  Equal
    boundaries collapse into one (the JAX package keys them in a dict):
    at n_steps=2 and tau (0.2, 0.45, 0.7) that is two decays, not three."""
    boundaries = sorted({int(t * n_steps): gamma for t in tau}.items())

    def schedule(count: int) -> float:
        v = lr_init
        for boundary, scale in boundaries:
            if count >= boundary:
                v = v * scale
        return v
    return schedule


def linear_decay_lr(lr_init: float, start_it: int,
                    end_it: int) -> Callable[[int], float]:
    """The rate at a step: ``lr_init`` until ``start_it``, then linear down
    to 0 at ``end_it`` and 0 after it.  With an optimizer whose lr is
    ``lr_init``, ``torch.optim.lr_scheduler.LambdaLR(opt, lambda s:
    schedule(s) / lr_init)`` applies it."""

    def schedule(step):
        return linear_var(step, start_it, end_it, lr_init, 0.0, 0.0, lr_init)
    return schedule


def kl_ramp(step, total_steps, start_frac=0.5, end_frac=0.75,
            kl_init=1e-6, kl_max=1.0):
    """The original VUNet's KL weight: linear from ``kl_init`` to
    ``kl_max`` between int(total/2) and int(3 total/4), clipped to
    [kl_init, 1]."""
    return linear_var(step, int(start_frac * total_steps),
                      int(end_frac * total_steps), kl_init, kl_max,
                      kl_init, 1.0)
