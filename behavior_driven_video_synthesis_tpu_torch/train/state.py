"""The cvbae experiment's optimizers.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/state.py`` and
``experiments/shape_and_pose_net.py:138-156``.  ``torch.optim.Adam`` is
optax's ``adam`` exactly: eps 1e-8 outside the square root, bias
correction from the first step.  The VUNet's learning rate decays linearly
from lr0 at the first step to 0 at ``end_iteration``
(``optax.linear_schedule``); the regressor's is a constant 1e-3.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def linear_decay(total_steps: int):
    """The LambdaLR factor of ``optax.linear_schedule(lr0, 0, total)``."""
    return lambda step: max(0.0, 1.0 - min(step, total_steps) / total_steps)


def make_vunet_optimizers(vunet: nn.Module, regressor: Optional[nn.Module],
                          training: dict) -> Dict[str, object]:
    """{"vunet": Adam, "vunet_lr": LambdaLR, "regressor": Adam or None}
    from a run config's ``training`` section."""
    betas = tuple(float(b) for b in training.get("adam_betas", (0.5, 0.9)))
    opt = torch.optim.Adam(vunet.parameters(),
                           lr=float(training.get("lr", 5e-4)), betas=betas,
                           eps=1e-8)
    total = int(training.get("end_iteration", 150000))
    return {
        "vunet": opt,
        "vunet_lr": torch.optim.lr_scheduler.LambdaLR(opt,
                                                      linear_decay(total)),
        "regressor": (torch.optim.Adam(regressor.parameters(), lr=1e-3)
                      if regressor is not None else None),
    }
