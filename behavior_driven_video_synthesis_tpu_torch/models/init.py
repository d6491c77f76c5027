"""Random weights from a seed, for smoke runs and parity tests.

Training is not ported, so the port has no trained initializers; this fills
a module in place with seeded values of sensible scale, by parameter name:
weights N(0, 1/fan_in), weight-norm magnitudes g in [0.4, 0.8], gamma and
ActNorm scale near 1, biases, beta and ActNorm loc near 0, and a random
permutation for every Shuffle.  ``rng`` is a ``torch.Generator`` (values
drawn on the module's device) or a ``numpy.random.RandomState``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def init_random_(module: nn.Module, rng) -> nn.Module:
    def normal(t):
        if isinstance(rng, np.random.RandomState):
            return torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32))
        return torch.randn(t.shape, generator=rng, device=t.device)

    def permutation(n, t):
        if isinstance(rng, np.random.RandomState):
            return torch.from_numpy(rng.permutation(n))
        return torch.randperm(n, generator=rng, device=t.device)

    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "forward_shuffle_idx":
            v = permutation(t.numel(), t)
        elif leaf == "weight_g":
            v = 0.6 + 0.1 * normal(t).clamp(-2, 2)
        elif leaf in ("gamma", "scale"):
            v = 1.0 + 0.1 * normal(t)
        elif leaf in ("beta", "loc") or t.dim() == 1:
            v = 0.1 * normal(t)
        else:
            v = normal(t) / float(np.sqrt(np.prod(t.shape[1:])))
        t.copy_(v.to(device=t.device, dtype=t.dtype))
    return module
