"""The optimizers of the cvbae and behavior experiments.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/state.py``,
``experiments/shape_and_pose_net.py:138-156`` and
``experiments/behavior_net.py:95-114, 205-213``.  ``torch.optim.Adam`` is
optax's ``adam`` exactly (eps 1e-8 outside the square root, bias
correction from the first step) and, with ``weight_decay``, the JAX
package's ``torch_adam``: the L2 term joins the gradient before the
moments (not AdamW's decoupled decay).  The VUNet's learning rate decays
linearly from lr0 at the first step to 0 at ``end_iteration``
(``optax.linear_schedule``); the regressor's is a constant 1e-3.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.schedules import multistep_lr


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


def make_behavior_optimizers(modules: Dict[str, nn.Module], training: dict,
                             n_steps: int) -> Dict[str, object]:
    """One Adam per module of the behavior experiment ("net", "regressor",
    "cls_action", "cls_action2", "cls_beta"), plus "net_lr", the net's
    MultiStepLR over ``n_steps`` updates as a LambdaLR: step it after each
    net update, and only then."""
    def adam(name, lr, weight_decay=0.0):
        return torch.optim.Adam(modules[name].parameters(), lr=lr,
                                weight_decay=weight_decay)
    opts = {
        "net": adam("net", float(training.get("lr_init", 1e-4)),
                    float(training.get("weight_decay", 0.0))),
        "regressor": adam("regressor", 1e-4),
        "cls_action": adam("cls_action", 1e-4, 1e-4),
        "cls_action2": adam("cls_action2", 1e-4, 1e-5),
        "cls_beta": adam("cls_beta", 1e-3),
    }
    opts["net_lr"] = torch.optim.lr_scheduler.LambdaLR(
        opts["net"], multistep_lr(
            1.0, n_steps, list(training.get("tau", [0.2, 0.45, 0.7])),
            float(training.get("gamma", 0.3))))
    return opts


def make_flow_optimizer(flow: nn.Module, training: dict
                        ) -> torch.optim.Adam:
    """The flow's Adam: lr flow_lr * batch_size, betas (0.5, 0.9)."""
    return torch.optim.Adam(
        flow.parameters(),
        lr=float(training.get("flow_lr", 4.5e-7))
        * int(training["batch_size"]),
        betas=(0.5, 0.9), weight_decay=float(training.get("weight_decay",
                                                          0.0)))
