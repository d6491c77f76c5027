"""Conditional flow stack: couplings conditioned on an embedding.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/
conditional.py`` (the reference's ConditionalFlow path, models/flow/
blocks.py:8-56, :452-492, :655-689, :733-764).  As in JAX:

* :class:`InvLeakyRelu` reports a logdet of 0 although its slope is not
  1 (the reference's choice, kept so that converted checkpoints score the
  same);
* ``conditioning_option``: ``none`` feeds the raw embedding to every
  block, ``parallel`` a per-block Linear of it, ``sequential`` a chain of
  those Linears from block to block.

State dict: ``sub_layers.{i}.{norm_layer,coupling,shuffle}`` as in
:class:`~.blocks.UnconditionalFlow` and ``conditioning_layers.{i}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ActNorm, DoubleCoupling, Shuffle

CONDITIONING_OPTIONS = ("none", "parallel", "sequential")


class InvLeakyRelu(nn.Module):
    """y = x for x >= 0, alpha * x below; logdet 0 (see the module
    docstring)."""

    def __init__(self, alpha: float = 0.9):
        super().__init__()
        self.alpha = alpha

    def forward(self, x, reverse: bool = False):
        scaling = torch.where(x >= 0, 1.0, self.alpha).to(x.dtype)
        if reverse:
            return x / scaling
        return x * scaling, torch.zeros(x.shape[0], dtype=x.dtype,
                                        device=x.device)


class ConditionalCoupling(DoubleCoupling):
    """Two affine couplings whose s and t MLPs see concat(xa, cond)
    (reference ConditionalDoubleVectorCouplingBlock); odd C as in the
    unconditional coupling."""

    def __init__(self, in_channels: int, cond_channels: int,
                 hidden_dim: int, hidden_depth: int = 2, dtype=torch.float32,
                 device=None):
        super().__init__(in_channels, hidden_dim, hidden_depth, dtype,
                         device, cond_channels=cond_channels)

    def forward(self, x, cond, reverse: bool = False):
        return self._run(x, cond, reverse)


class ConditionalFlowBlock(nn.Module):
    """ActNorm -> InvLeakyRelu (``activation="lrelu"``) -> conditional
    coupling -> Shuffle."""

    def __init__(self, in_channels: int, cond_channels: int,
                 hidden_dim: int, hidden_depth: int = 2,
                 activation: str = "lrelu", dtype=torch.float32,
                 device=None):
        super().__init__()
        self.norm_layer = ActNorm(in_channels, device=device)
        self.act = InvLeakyRelu() if activation == "lrelu" else None
        self.coupling = ConditionalCoupling(in_channels, cond_channels,
                                            hidden_dim, hidden_depth,
                                            dtype=dtype, device=device)
        self.shuffle = Shuffle(in_channels, device=device)

    def forward(self, x, cond, reverse: bool = False):
        if not reverse:
            h, logdet = self.norm_layer(x)
            if self.act is not None:
                h, ld = self.act(h)
                logdet = logdet + ld
            h, ld = self.coupling(h, cond)
            logdet = logdet + ld
            h, ld = self.shuffle(h)
            return h, logdet + ld
        h = self.shuffle(x, reverse=True)
        h = self.coupling(h, cond, reverse=True)
        if self.act is not None:
            h = self.act(h, reverse=True)
        return self.norm_layer(h, reverse=True)


class ConditionalFlow(nn.Module):
    """A stack of ``n_flows`` embedding-conditioned flow blocks."""

    def __init__(self, in_channels: int, embedding_dim: int,
                 hidden_dim: int, hidden_depth: int = 2, n_flows: int = 4,
                 conditioning_option: str = "none",
                 activation: str = "lrelu", dtype=torch.float32,
                 device=None):
        super().__init__()
        opt = conditioning_option.lower()
        if opt not in CONDITIONING_OPTIONS:
            raise ValueError(f"unknown conditioning_option "
                             f"{conditioning_option!r}; expected one of "
                             f"{CONDITIONING_OPTIONS}")
        self.opt, self.dtype = opt, dtype
        self.sub_layers = nn.ModuleList(
            ConditionalFlowBlock(in_channels, embedding_dim, hidden_dim,
                                 hidden_depth, activation=activation,
                                 dtype=dtype, device=device)
            for _ in range(n_flows))
        if opt != "none":
            self.conditioning_layers = nn.ModuleList(
                nn.Linear(embedding_dim, embedding_dim, device=device)
                for _ in range(n_flows))

    def _conds(self, embedding):
        conds, hcond = [], embedding
        for i in range(len(self.sub_layers)):
            if self.opt != "none":
                layer, dt = self.conditioning_layers[i], self.dtype
                src = embedding if self.opt == "parallel" else hcond
                hcond = F.linear(src.to(dt), layer.weight.to(dt),
                                 layer.bias.to(dt))
            conds.append(hcond)
        return conds

    def forward(self, x, embedding, reverse: bool = False):
        conds = self._conds(embedding)
        if not reverse:
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for layer, cond in zip(self.sub_layers, conds):
                x, ld = layer(x, cond)
                logdet = logdet + ld
            return x, logdet
        for layer, cond in zip(reversed(self.sub_layers), reversed(conds)):
            x = layer(x, cond, reverse=True)
        return x

    def reverse(self, z, embedding):
        return self(z, embedding, reverse=True)

    @torch.no_grad()
    def initialize_(self, x, embedding):
        """Set every ActNorm from the activations that reach it on (x,
        embedding), as JAX's init on that batch does."""
        for layer, cond in zip(self.sub_layers, self._conds(embedding)):
            layer.norm_layer.initialize_(x)
            x, _ = layer(x, cond)
