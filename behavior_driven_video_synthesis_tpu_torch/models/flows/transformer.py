"""The flow prior over behavior latents and its NLL loss.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/
transformer.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import UnconditionalFlow


class LatentFlow(nn.Module):
    """Invertible map between behavior latents b and gaussian codes z."""

    def __init__(self, flow_in_channels: int, flow_mid_channels: int,
                 flow_hidden_depth: int = 2, n_flows: int = 15,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.flow_in_channels, self.dtype = flow_in_channels, dtype
        self.flow = UnconditionalFlow(flow_in_channels, flow_mid_channels,
                                      flow_hidden_depth, n_flows,
                                      dtype=dtype, device=device)

    def forward(self, b, reverse: bool = False):
        """forward: b -> (z, logdet); reverse: z -> b."""
        return self.flow(b, reverse=reverse)

    def reverse(self, z):
        return self.flow(z, reverse=True)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               device=None):
        z = torch.randn(n, self.flow_in_channels, generator=generator,
                        dtype=self.dtype, device=device)
        return self.flow(z, reverse=True)


def flow_loss(z, logdet):
    """mean(||z||^2 / 2) - mean(logdet), without the constant term."""
    nll_z = torch.mean(0.5 * torch.sum(z ** 2, dim=tuple(range(1, z.dim()))))
    return nll_z - torch.mean(logdet)
