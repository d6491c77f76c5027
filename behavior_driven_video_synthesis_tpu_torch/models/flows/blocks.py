"""Invertible flow blocks over flat (B, C) behavior latents.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/blocks.py``
(affine coupling only): ActNorm -> DoubleCoupling -> Shuffle, with analytic
log-determinants.  State-dict names are the reference's
(``norm_layer.loc``, ``coupling.s.{j}.main.{2k}.weight``,
``shuffle.forward_shuffle_idx``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.nn import FullyConnectedNet


class ActNorm(nn.Module):
    """y = scale * (x + loc); logdet = sum(log|scale|) per sample.  loc and
    scale keep the reference's (1, C, 1, 1) shape.  A new flow sets them
    from a batch with :meth:`initialize_` (the data-dependent init)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1, device=device))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1,
                                             device=device))

    def forward(self, x, reverse: bool = False):
        loc, scale = self.loc.reshape(1, -1), self.scale.reshape(1, -1)
        if reverse:
            return x / scale - loc
        logdet = torch.sum(torch.log(torch.abs(scale))).expand(x.shape[0])
        return scale * (x + loc), logdet

    @torch.no_grad()
    def initialize_(self, x):
        """loc = -mean(x), scale = 1 / (std(x, ddof=1) + 1e-6) over the
        batch (B, C): the output on x is then about N(0, 1) per feature."""
        self.loc.copy_(-x.mean(dim=0).reshape(self.loc.shape))
        self.scale.copy_((1.0 / (x.std(dim=0, unbiased=True) + 1e-6)
                          ).reshape(self.scale.shape))


class DoubleCoupling(nn.Module):
    """Two affine couplings with a half rotation between them; odd C
    splits as dim1 = ceil(C/2), dim2 = floor(C/2)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        c = in_channels
        self.dim1, self.dim2 = c // 2 + c % 2, c // 2

        def nets(use_tanh):
            return nn.ModuleList(
                FullyConnectedNet(self.dim1, hidden_depth, hidden_dim,
                                  use_tanh=use_tanh, out_dim=self.dim2,
                                  dtype=dtype, device=device)
                for _ in range(2))
        self.s = nets(True)
        self.t = nets(False)

    def _swap(self, x):
        # rotate the first dim1 channels to the back
        return torch.cat([x[:, self.dim1:], x[:, :self.dim1]], dim=1)

    def _unswap(self, x):
        # the exact inverse rotation (the JAX package's fix of the
        # reference, whose reverse re-applies the forward rotation and is
        # wrong for odd C)
        return torch.cat([x[:, self.dim2:], x[:, :self.dim2]], dim=1)

    def forward(self, x, reverse: bool = False):
        d1 = self.dim1
        if not reverse:
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for i in range(2):
                if i % 2 != 0:
                    x = self._swap(x)
                xa, xb = x[:, :d1], x[:, d1:]
                scale = self.s[i](xa)
                xb = xb * torch.exp(scale) + self.t[i](xa)
                x = torch.cat([xa, xb], dim=1)
                logdet = logdet + torch.sum(scale, dim=-1)
            return x, logdet
        for i in reversed(range(2)):
            if i % 2 == 0:
                x = self._unswap(x)
            xa, xb = x[:, :d1], x[:, d1:]
            xb = (xb - self.t[i](xa)) * torch.exp(-self.s[i](xa))
            x = torch.cat([xa, xb], dim=1)
        return x


class Shuffle(nn.Module):
    """Fixed channel permutation, held as the buffer forward_shuffle_idx
    (identity until loaded)."""

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        self.register_buffer("forward_shuffle_idx",
                             torch.arange(in_channels, device=device))

    def forward(self, x, reverse: bool = False):
        perm = self.forward_shuffle_idx
        if not reverse:
            return x[:, perm], torch.zeros(x.shape[0], dtype=x.dtype,
                                           device=x.device)
        return x[:, torch.argsort(perm)]


class CouplingFlowBlock(nn.Module):
    """ActNorm -> affine DoubleCoupling -> Shuffle (one flow step)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, coupling_type: str = "affine",
                 dtype=torch.float32, device=None):
        super().__init__()
        if coupling_type != "affine":
            raise NotImplementedError(
                f"coupling_type={coupling_type!r} is not ported yet")
        self.norm_layer = ActNorm(in_channels, device=device)
        self.coupling = DoubleCoupling(in_channels, hidden_dim, hidden_depth,
                                       dtype=dtype, device=device)
        self.shuffle = Shuffle(in_channels, device=device)

    def forward(self, x, reverse: bool = False):
        if not reverse:
            h, logdet = self.norm_layer(x)
            h, ld = self.coupling(h)
            logdet = logdet + ld
            h, ld = self.shuffle(h)
            return h, logdet + ld
        h = self.shuffle(x, reverse=True)
        h = self.coupling(h, reverse=True)
        return self.norm_layer(h, reverse=True)


class UnconditionalFlow(nn.Module):
    """A stack of ``n_flows`` coupling flow blocks."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, n_flows: int = 15,
                 coupling_type: str = "affine", dtype=torch.float32,
                 device=None):
        super().__init__()
        self.sub_layers = nn.ModuleList(
            CouplingFlowBlock(in_channels, hidden_dim, hidden_depth,
                              coupling_type=coupling_type, dtype=dtype,
                              device=device)
            for _ in range(n_flows))

    def forward(self, x, reverse: bool = False):
        if not reverse:
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for layer in self.sub_layers:
                x, ld = layer(x)
                logdet = logdet + ld
            return x, logdet
        for layer in reversed(self.sub_layers):
            x = layer(x, reverse=True)
        return x

    def reverse(self, z):
        return self(z, reverse=True)

    @torch.no_grad()
    def initialize_(self, x):
        """Set every ActNorm from the activations that reach it on x, each
        block after the ones before it are set."""
        for layer in self.sub_layers:
            layer.norm_layer.initialize_(x)
            x, _ = layer(x)
