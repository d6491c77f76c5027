"""The flow stage: fit the latent flow over the frozen cVAE's posteriors.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/flow.py``
(``make_flow_train_step``).  One step infers b = mu + exp(logstd) * eps
with the frozen net (no gradient; a bf16 net's b is cast to float32, the
flow's dtype), takes the flow's NLL and one Adam update of the flow.  The
gradients come from ``backward``, which a flow sharded by FSDP
(``parallel/sharding_rules.py``, ``training.fsdp``) needs to
reduce-scatter them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.flows import flow_loss, gaussian_reference_nll
from .vunet_exp import global_norm


@dataclass
class FlowTrainState:
    """The flow, its optimizer (``train/state.py:make_flow_optimizer``)
    and the step count."""

    flow: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"flow": self.flow.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.flow.load_state_dict(sd["flow"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def make_flow_train_step(net: nn.Module) -> Callable:
    """``train_step(state, batch, generator=None, eps=None) -> metrics``;
    ``eps`` (B, H) is the posterior noise, else drawn from
    ``generator``."""

    def train_step(state: FlowTrainState, batch,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        seq_b = batch["keypoints"].float()[:, :-1]
        with torch.no_grad():
            b, _, _, _ = net.infer_b(seq_b, generator=generator, eps=eps)
        z, logdet = state.flow(b.float())
        loss = flow_loss(z, logdet)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in state.flow.parameters()
                 if p.grad is not None]
        state.optimizer.step()
        state.step += 1
        mean_logdet = torch.mean(logdet.detach())
        return {"flow_loss": loss.detach(), "grad_norm": global_norm(grads),
                "nlogdet_loss": -mean_logdet,
                "nll_loss": loss.detach() + mean_logdet,
                "reference_nll_loss": gaussian_reference_nll(z.detach())}

    return train_step
