"""Weights from a seed.

:func:`init_random_` fills a module in place with seeded values of sensible
scale, by parameter name, for smoke runs and parity tests: weights
N(0, 1/fan_in), weight-norm magnitudes g in [0.4, 0.8], gamma and ActNorm
scale near 1, biases, beta and ActNorm loc near 0, and a random permutation
for every Shuffle.  ``rng`` is a ``torch.Generator`` (values drawn on the
module's device) or a ``numpy.random.RandomState``.

:func:`init_like_jax_` gives a fresh training run the JAX package's
initializers, matched in distribution (not in bits).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.nn import L2NormConv2d, NormConv2d, NormDense
from ..ops.recurrent import GRU, LSTM
from .behavior import ResidualDecoder
from .flows.blocks import Shuffle

# flax's variance_scaling(..., "truncated_normal") divides the standard
# deviation by this, the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


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


def _truncated_normal_(t: torch.Tensor, scale: float, fan_in: int,
                       generator) -> None:
    std = (scale / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _uniform_(t: torch.Tensor, fan: int, generator) -> None:
    bound = fan ** -0.5
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_like_jax_(module: nn.Module, generator=None) -> nn.Module:
    """The JAX package's initializers, in place: a NormConv2d or NormDense
    draws v from he_normal over its fan-in (kh, kw, cin) and sets g = |v|
    per output channel, bias and beta 0, gamma 1 (``ops/nn.py:225-241``);
    an L2NormConv2d draws w from N(0, 0.05^2), with bias and beta 0 and
    gamma 1 (``ops/nn.py:297-313``);
    an LSTM or a GRU, and a ResidualDecoder's cell and output layer, draw
    every weight and bias from U(-1/sqrt(H), 1/sqrt(H)), its optional input
    layer from U(-1/sqrt(K), 1/sqrt(K)) (``ops/recurrent.py:_uniform_init``);
    an ``nn.Conv1d``, ``nn.Conv2d`` or ``nn.Linear`` (a flax Conv or Dense)
    draws lecun_normal weights and a zero bias; a Shuffle draws a random
    permutation.  GroupNorm keeps scale 1 and bias 0, and ActNorm is set
    from data (``LatentFlow.initialize_``)."""
    done = set()
    for m in module.modules():
        if m in done:
            continue
        if isinstance(m, (NormConv2d, NormDense)):
            v = m.conv.weight_v
            _truncated_normal_(v, 2.0, v[0].numel(), generator)
            m.conv.weight_g.copy_(
                torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True)))
            m.conv.bias.zero_()
            m.gamma.fill_(1.0)
            m.beta.zero_()
        elif isinstance(m, L2NormConv2d):
            m.weight.normal_(0.0, 0.05, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
            m.gamma.fill_(1.0)
            m.beta.zero_()
        elif isinstance(m, (LSTM, GRU)):
            for p in m.parameters():
                _uniform_(p, m.hidden, generator)
        elif isinstance(m, ResidualDecoder):
            hidden = m.rnn.hidden_size
            for p in list(m.rnn.parameters()) + list(m.n_out.parameters()):
                _uniform_(p, hidden, generator)
            if m.use_nin:
                for p in m.n_in.parameters():
                    _uniform_(p, m.n_in.in_features, generator)
            done.update(m.modules())
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            _truncated_normal_(m.weight, 1.0, m.weight[0].numel(),
                               generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Shuffle):
            idx = m.forward_shuffle_idx
            idx.copy_(torch.randperm(idx.numel(), generator=generator,
                                     device=idx.device))
    return module
