"""The MT-VAE baseline's training step.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/mtvae_exp.py``
(``make_mtvae_train_step``, :37-80).  The loss of a batch of (B, T, K)
sequences, conditioned on their first ``n_cond`` frames:

  L1(prediction, the future segment)
  + linear_var(step + 1, 0, total_steps, 1e-5, 1, 0, 1) * KL(mu, logstd)
  + weight_motion * L1 of the velocities over the first
    k_v = min(k_vel, T - n_cond) predicted frames (the frame before the
    first prediction is the ground truth's frame n_cond - 1)
  + weight_cycle * L1(cycle sample, a fresh N(0, 1) draw),

then one Adam update (``train/state.py:make_mtvae_optimizer``), skipped
when the update is off: the parameters and Adam's state stay as they were
while the step count still advances.  The step's draws are the model's
(``models/mtvae.py:NOISE_SITES``) and the cycle target "target", drawn in
that order from ``generator`` or handed in as ``draws``.  With a bf16
model the products run in bf16 and every loss is reduced in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..core.schedules import linear_var
from ..models.mtvae import MTVAE
from ..ops import batch_draws
from .losses import kl_loss, l1_loss
from .vunet_exp import global_norm


@dataclass
class MTVAETrainState:
    """The model, its Adam and the step count."""

    model: MTVAE
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def draw_step(model: MTVAE, batch_size: int, generator, device
              ) -> Dict[str, torch.Tensor]:
    """A step's draws: the model's noise, then the cycle target."""
    draws = model.draw_noise(batch_size, generator, device)
    draws["target"] = batch_draws.randn(draws["cycle"].shape,
                                        generator=generator, device=device)
    return draws


def make_mtvae_train_step(config: dict, total_steps: int) -> Callable:
    """``train_step(state, batch, enable_update=True, generator=None,
    draws=None) -> metrics`` for a run config; ``batch`` holds
    ``keypoints`` and ``paired_keypoints`` (B, T, K); ``total_steps`` spans
    the KL ramp."""
    tr = config.get("training", {})
    k_vel = int(tr.get("k_vel", 8))
    w_motion = float(tr.get("weight_motion", 10.0))
    w_cycle = float(tr.get("weight_cycle", 10.0))

    def train_step(state: MTVAETrainState, batch, enable_update=True,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        model = state.model
        div = model.n_cond
        kps = batch["keypoints"].float()
        kps_cross = batch["paired_keypoints"].float()
        if draws is None:
            draws = draw_step(model, kps.shape[0], generator, kps.device)
        kl_weight = linear_var(state.step + 1, 0, total_steps, 1e-5, 1.0,
                               0.0, 1.0)
        k_v = min(k_vel, kps.shape[1] - div)

        out_seq, mu, logstd, out_cycle = (t.float() for t in model(
            kps, kps_cross, noise=draws))
        cycle = l1_loss(out_cycle, draws["target"])
        rec = l1_loss(out_seq, kps[:, div:])
        kl = kl_loss(mu, logstd)
        vel_tgt = kps[:, div:div + k_v] - kps[:, div - 1:div + k_v - 1]
        vel_pred = out_seq[:, :k_v] - torch.cat(
            [kps[:, div - 1:div], out_seq[:, :k_v - 1]], dim=1)
        motion = l1_loss(vel_tgt, vel_pred)
        loss = rec + kl_weight * kl + w_motion * motion + w_cycle * cycle

        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params)
        if enable_update:
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "rec_loss": rec.detach(),
                "kl_loss": kl.detach(), "motion_loss": motion.detach(),
                "cycle_loss": cycle.detach(),
                "kl_weight": torch.tensor(kl_weight, device=kps.device),
                "grad_norm": global_norm(grads)}

    return train_step
