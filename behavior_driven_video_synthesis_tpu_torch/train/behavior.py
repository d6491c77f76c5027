"""The behavior cVAE's training and eval steps.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/behavior.py``
(``make_behavior_train_step``, ``make_behavior_eval_step``).  One step, in
the JAX step's order:

  net:   recon_w * MSE(xs, target) + gamma * KL(mu, logstd)   [1 for cvae]
         - w_reg * (clip(L_reg, max=0.45) + clip(L_reg, max=0.7)),
         L_reg from the regressor as it stands (its parameters get no
         gradient); one Adam update and one lr-schedule step, both skipped
         when the net update is off;
  gamma: gamma <- max(gamma - gamma_step * (imax_t - KL), 0), only when
         the net updated; imax_t = 0 at step 0;
  reg:   5 Adam updates of MSE(regressor(mu.detach(), onehot(t_i)),
         seq[:, t_i]), after the net's update: the regressor lags the net
         by one batch (PARITY.md section 2.2);
  probes: one update each of the action classifiers on the sequence, on
         its frame differences, and on mu.detach().

Parameters and optimizer states change in place.  The step's random draws
(the adversarial frame t, the regressor's 5 frames and the posterior
noise) come from :func:`draw_step`, or are handed in as ``draws``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import schedules
from .losses import (accuracy, cross_entropy, kl_loss, mse_loss,
                     recon_loss_per_seq)
from .vunet_exp import global_norm

MODULES = ("net", "regressor", "cls_action", "cls_action2", "cls_beta")
N_REG_STEPS = 5


@dataclass
class BehaviorTrainState:
    """The five modules (by the names of ``MODULES``), their optimizers
    (``train/state.py:make_behavior_optimizers``, the net's lr schedule
    under "net_lr"), the gamma controller and the step count."""

    modules: Dict[str, nn.Module]
    optimizers: Dict[str, object]
    gamma: torch.Tensor
    step: int = 0

    def state_dict(self) -> dict:
        return {"modules": {k: m.state_dict()
                            for k, m in self.modules.items()},
                "optimizers": {k: o.state_dict()
                               for k, o in self.optimizers.items()},
                "gamma": self.gamma.detach().cpu(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for k, m in self.modules.items():
            m.load_state_dict(sd["modules"][k])
        for k, o in self.optimizers.items():
            o.load_state_dict(sd["optimizers"][k])
        self.gamma = sd["gamma"].to(self.gamma.device)
        self.step = int(sd["step"])


@dataclass
class StepDraws:
    """One step's draws: t_adv, the regressor's frames t_reg (0-d long
    tensors, or ints) and the posterior noise eps (B, H)."""

    t_adv: torch.Tensor
    t_reg: Sequence[torch.Tensor]
    eps: torch.Tensor


def draw_step(generator: Optional[torch.Generator], batch_size: int,
              hidden: int, seq_len: int, device) -> StepDraws:
    """A step's draws on ``device``, without a host sync."""
    t = torch.randint(0, seq_len, (1 + N_REG_STEPS,), generator=generator,
                      device=device)
    eps = torch.randn(batch_size, hidden, generator=generator, device=device)
    return StepDraws(t[0], list(t[1:]), eps)


def _update(optimizer, params, loss) -> None:
    """One optimizer step on the gradients of loss w.r.t. params only."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()


def _frame(seq, t, seq_len):
    """(one_hot(t) (B, seq_len), seq[:, t]) for a frame index t."""
    t = torch.as_tensor(t, device=seq.device).reshape(1)
    onehot = F.one_hot(t.expand(seq.shape[0]), seq_len).to(seq.dtype)
    return onehot, seq.index_select(1, t)[:, 0]


def make_behavior_train_step(config: dict, seq_len: int,
                             total_steps: int = 0) -> Callable:
    """``train_step(state, batch, enable_net_update=True, generator=None,
    draws=None) -> metrics`` for a run config (a dict with "training" and
    "architecture" sections).  ``batch`` holds ``keypoints`` (B, T+1, K)
    and ``action`` (B,) labels; ``total_steps`` spans the
    ``imax_scaling`` target schedule."""
    tr = config.get("training", {})
    recon_w = float(tr.get("recon_loss_weight", 2.5))
    w_reg = float(tr.get("weight_regressor", 0.01))
    use_reg = bool(tr.get("use_regressor", True))
    gamma_step = float(tr.get("gamma_step", 1e-5))
    imax = float(tr.get("information_max", 100.0))
    imax_mode = str(tr.get("imax_scaling", "none"))
    is_cvae = bool(config.get("architecture", {}).get("cvae", False))

    def train_step(state: BehaviorTrainState, batch,
                   enable_net_update: bool = True,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[StepDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        m, opt = state.modules, state.optimizers
        net, regressor = m["net"], m["regressor"]
        kps = batch["keypoints"].float()
        seq_b, target = kps[:, :-1], kps[:, 1:]
        labels = batch["action"].long()
        if draws is None:
            draws = draw_step(generator, seq_b.shape[0], net.dim_hidden_b,
                              seq_len, kps.device)

        # the net, against the regressor as it stands
        xs, _, _, mu, logstd, _ = net(seq_b, seq_b, seq_len, eps=draws.eps)
        recon = mse_loss(xs, target)
        kl = kl_loss(mu, logstd)
        loss = recon_w * recon + (1.0 if is_cvae else state.gamma) * kl
        if use_reg:
            onehot, target_adv = _frame(seq_b, draws.t_adv, seq_len)
            loss_reg_adv = mse_loss(regressor(mu, onehot), target_adv)
            loss = loss - torch.clamp(loss_reg_adv, max=0.45) * w_reg
            loss = loss - torch.clamp(loss_reg_adv, max=0.7) * w_reg
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params)
        if enable_net_update:
            for p, g in zip(params, grads):
                p.grad = g
            opt["net"].step()
            opt["net_lr"].step()
            imax_t = (0.0 if state.step == 0 else schedules.imax_schedule(
                state.step, max(total_steps, 1), imax, imax_mode))
            state.gamma = schedules.update_gamma(state.gamma, kl.detach(),
                                                 imax_t, gamma_step)
        mu_sg = mu.detach()

        # the adversarial regressor, on the latents without gradient
        loss_reg = torch.zeros((), device=kps.device)
        if use_reg:
            reg_params = list(regressor.parameters())
            for t in draws.t_reg:
                onehot, tgt = _frame(seq_b, t, seq_len)
                loss_reg = mse_loss(regressor(mu_sg, onehot), tgt)
                _update(opt["regressor"], reg_params, loss_reg)

        # the probe classifiers
        logits = {}

        def probe(name, x):
            out = m[name](x)
            logits[name] = out[0] if isinstance(out, tuple) else out
            ce = cross_entropy(logits[name], labels)
            _update(opt[name], list(m[name].parameters()), ce)
            return ce.detach()
        ca_loss = probe("cls_action", seq_b)
        ca2_loss = probe("cls_action2", seq_b[:, 1:] - seq_b[:, :-1])
        cb_loss = probe("cls_beta", mu_sg)

        state.step += 1
        return {
            "loss": loss.detach(),
            "grad_norm": global_norm(grads),
            "loss_recon": recon.detach(),
            "kl_loss": kl.detach(),
            "gamma": state.gamma,
            "loss_regressor": loss_reg.detach(),
            "loss_classifier_action": ca_loss,
            "acc_classifier_action": accuracy(logits["cls_action"], labels),
            "loss_classifier_action2": ca2_loss,
            "acc_classifier_action2": accuracy(logits["cls_action2"],
                                               labels),
            "loss_classifier_action_beta": cb_loss,
            "acc_action_beta": accuracy(logits["cls_beta"], labels),
            "loss_per_seq_recon": recon_loss_per_seq(xs.detach(), target),
        }

    return train_step


def make_behavior_eval_step(net: nn.Module, seq_len: int) -> Callable:
    """``eval_step(batch, generator=None, eps=None) -> (metrics, xs)``:
    the reconstruction MSE and the KL of one batch, without gradient."""

    @torch.no_grad()
    def eval_step(batch, generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None):
        kps = batch["keypoints"].float()
        seq_b, target = kps[:, :-1], kps[:, 1:]
        xs, _, _, mu, logstd, _ = net(seq_b, seq_b, seq_len,
                                      generator=generator, eps=eps)
        return {"recon_mse": mse_loss(xs, target),
                "kl": kl_loss(mu, logstd)}, xs

    return eval_step
