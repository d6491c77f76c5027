"""MADE, the masked autoregressive fully-connected net.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/made.py``
(reference lib/modules.py:503-611).  The masks are fixed functions of
(nin, hidden_sizes, nout, seed, natural_ordering), built with the JAX
package's numpy code, so they are bit-equal to its masks; they are not in
the state dict (JAX keeps them as constants), and each layer holds one
copy per device it runs on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class MaskedDense(nn.Module):
    """Linear layer whose weight is multiplied by a fixed 0/1 mask
    (reference MaskedLinear).  ``mask`` is (in_features, features), as
    the flax kernel is laid out; ``weight`` is torch's (out, in)."""

    def __init__(self, in_features: int, features: int, mask: np.ndarray,
                 dtype=torch.float32, device=None):
        super().__init__()
        if mask.shape != (in_features, features):
            raise ValueError(f"mask of shape {mask.shape} for a "
                             f"{in_features} -> {features} layer")
        self.dtype, self.mask = dtype, mask
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self._masks = {}

    def _mask(self, device):
        key = (device, self.dtype)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                np.ascontiguousarray(self.mask.T)).to(device, self.dtype)
        return self._masks[key]

    def forward(self, x):
        dt = self.dtype
        w = self.weight.to(dt)
        return F.linear(x.to(dt), w * self._mask(w.device),
                        self.bias.to(dt))


def _build_masks(nin: int, hidden_sizes: Sequence[int], nout: int,
                 seed: int, natural_ordering: bool):
    """Degree-based MADE masks (reference update_masks,
    lib/modules.py:567-589), the JAX package's numpy code."""
    rng = np.random.RandomState(seed)
    L = len(hidden_sizes)
    m = {-1: (np.arange(nin) if natural_ordering
              else rng.permutation(nin))}
    for layer in range(L):
        m[layer] = rng.randint(m[layer - 1].min(), nin - 1,
                               size=hidden_sizes[layer])
    masks = [(m[layer - 1][:, None] <= m[layer][None, :])
             for layer in range(L)]
    masks.append(m[L - 1][:, None] < m[-1][None, :])
    if nout > nin:
        k = nout // nin
        masks[-1] = np.concatenate([masks[-1]] * k, axis=1)
    return [mk.astype(np.float32) for mk in masks]


class ARFullyConnectedNet(nn.Module):
    """MADE MLP: output unit j depends only on inputs of degree < j.

    nout is a multiple of nin; the k output chunks share the ordering
    (e.g. means then scales).  With ``ncond`` > 0 a dense conditioning
    trunk (``condnet``, unmasked as in the reference, whose mask update
    skips it) is added into every layer.  ReLU between layers."""

    def __init__(self, nin: int, hidden_sizes: Sequence[int], nout: int,
                 ncond: int = 0, natural_ordering: bool = False,
                 seed: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        if nout % nin:
            raise ValueError("nout must be an integer multiple of nin")
        self.ncond = ncond
        self.masks = _build_masks(nin, list(hidden_sizes), nout, seed,
                                  natural_ordering)
        sizes = list(hidden_sizes) + [nout]
        self.net = nn.ModuleList(
            MaskedDense(i, o, mk, dtype=dtype, device=device)
            for i, o, mk in zip([nin] + sizes[:-1], sizes, self.masks))
        if ncond > 0:
            self.dtype = dtype
            self.condnet = nn.ModuleList(
                nn.Linear(i, o, device=device)
                for i, o in zip([ncond] + sizes[:-1], sizes))

    def forward(self, x, y: Optional[torch.Tensor] = None):
        if self.ncond > 0:
            if y is None:
                raise ValueError("a conditioned MADE needs y")
            dt = self.dtype
            for i, (layer, cond) in enumerate(zip(self.net, self.condnet)):
                if i > 0:
                    x, y = F.relu(x), F.relu(y)
                y = F.linear(y.to(dt), cond.weight.to(dt), cond.bias.to(dt))
                x = layer(x) + y
            return x
        for i, layer in enumerate(self.net):
            if i > 0:
                x = F.relu(x)
            x = layer(x)
        return x
