"""The flow prior over behavior latents and its NLL loss.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/
transformer.py``.
"""
from __future__ import annotations

import math
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

    def initialize_(self, b):
        """ActNorm's data-dependent init from a batch of latents b (B, C),
        as the JAX package's ``init`` on that batch does.  A new flow calls
        this once before training; loaded weights need no call."""
        self.flow.initialize_(b)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               device=None):
        z = torch.randn(n, self.flow_in_channels, generator=generator,
                        dtype=self.dtype, device=device)
        return self.flow(z, reverse=True)


def flow_loss(z, logdet):
    """mean(||z||^2 / 2) - mean(logdet), without the constant term."""
    nll_z = torch.mean(0.5 * torch.sum(z ** 2, dim=tuple(range(1, z.dim()))))
    return nll_z - torch.mean(logdet)


def gaussian_reference_nll(z):
    """The NLL of z under N(0, 1) with its 0.5 * d * log(2 pi) constant,
    logged beside :func:`flow_loss`."""
    d = math.prod(z.shape[1:])
    return (torch.mean(0.5 * torch.sum(z ** 2, dim=tuple(range(1, z.dim()))))
            + 0.5 * d * math.log(2 * math.pi))
