"""Invertible flow blocks over flat (B, C) behavior latents.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/blocks.py``:
ActNorm -> coupling -> Shuffle, with analytic log-determinants.  The
coupling is one of :data:`COUPLING_TYPES`: ``affine`` (DoubleCoupling),
the volume-preserving ``gin`` and ``nice``, and ``rqs`` (the spline
coupling of ``spline.py``, registered by the package).  State-dict names
are the reference's (``norm_layer.loc``, ``coupling.s.{j}.main.{2k}.weight``,
``shuffle.forward_shuffle_idx``); the spline coupling's nets are
``coupling.nets.{j}``.
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
    splits as dim1 = ceil(C/2), dim2 = floor(C/2).  Per coupling i:
    xb' = xb * exp(s_i(xa)) + t_i(xa), logdet += sum(s_i(xa)).

    The other coupling types override :meth:`_nets` (their MLPs) and
    :meth:`_couple` (the map of xb given xa); with ``cond_channels`` the
    MLPs also see a conditioning vector concatenated to xa
    (``ConditionalCoupling``)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, dtype=torch.float32, device=None,
                 cond_channels: int = 0):
        super().__init__()
        c = in_channels
        self.dim1, self.dim2 = c // 2 + c % 2, c // 2
        self._nets(self.dim1 + cond_channels, hidden_dim, hidden_depth,
                   dtype, device)

    @staticmethod
    def _mlps(in_dim, out_dim, use_tanh, hidden_dim, hidden_depth, dtype,
              device):
        return nn.ModuleList(
            FullyConnectedNet(in_dim, hidden_depth, hidden_dim,
                              use_tanh=use_tanh, out_dim=out_dim,
                              dtype=dtype, device=device)
            for _ in range(2))

    def _nets(self, in_dim, hidden_dim, hidden_depth, dtype, device):
        self.s = self._mlps(in_dim, self.dim2, True, hidden_dim,
                            hidden_depth, dtype, device)
        self.t = self._mlps(in_dim, self.dim2, False, hidden_dim,
                            hidden_depth, dtype, device)

    def _couple(self, i, h, xb, reverse):
        """(xb', logdet of the map) given the MLPs' input h."""
        scale = self.s[i](h)
        if reverse:
            return (xb - self.t[i](h)) * torch.exp(-scale), None
        return xb * torch.exp(scale) + self.t[i](h), torch.sum(scale, dim=-1)

    def _swap(self, x):
        # rotate the first dim1 channels to the back
        return torch.cat([x[:, self.dim1:], x[:, :self.dim1]], dim=1)

    def _unswap(self, x):
        # the exact inverse rotation (the JAX package's fix of the
        # reference, whose reverse re-applies the forward rotation and is
        # wrong for odd C)
        return torch.cat([x[:, self.dim2:], x[:, :self.dim2]], dim=1)

    def _run(self, x, cond, reverse):
        d1 = self.dim1

        def mlp_input(xa):
            return xa if cond is None else torch.cat([xa, cond], dim=1)
        if not reverse:
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for i in range(2):
                if i % 2 != 0:
                    x = self._swap(x)
                xa, xb = x[:, :d1], x[:, d1:]
                xb, ld = self._couple(i, mlp_input(xa), xb, False)
                x = torch.cat([xa, xb], dim=1)
                if ld is not None:
                    logdet = logdet + ld
            return x, logdet
        for i in reversed(range(2)):
            if i % 2 == 0:
                x = self._unswap(x)
            xa, xb = x[:, :d1], x[:, d1:]
            xb, _ = self._couple(i, mlp_input(xa), xb, True)
            x = torch.cat([xa, xb], dim=1)
        return x

    def forward(self, x, reverse: bool = False):
        return self._run(x, None, reverse)


class GINCoupling(DoubleCoupling):
    """Volume-preserving affine coupling (GIN, JAX ``blocks.py:208``): the
    last scale channel is minus the sum of the others, so each coupling's
    logdet is 0.  Needs even C."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, dtype=torch.float32, device=None):
        if in_channels % 2:
            raise ValueError(f"GIN coupling needs even channels, got "
                             f"{in_channels}")
        super().__init__(in_channels, hidden_dim, hidden_depth, dtype,
                         device)

    def _nets(self, in_dim, hidden_dim, hidden_depth, dtype, device):
        self.s = self._mlps(in_dim, self.dim1 - 1, True, hidden_dim,
                            hidden_depth, dtype, device)
        self.t = self._mlps(in_dim, self.dim1, False, hidden_dim,
                            hidden_depth, dtype, device)

    def _couple(self, i, h, xb, reverse):
        s = self.s[i](h)
        scale = torch.cat([s, -torch.sum(s, dim=-1, keepdim=True)], dim=-1)
        if reverse:
            return (xb - self.t[i](h)) * torch.exp(-scale), None
        return xb * torch.exp(scale) + self.t[i](h), None


class NICECoupling(DoubleCoupling):
    """Additive (volume-preserving) coupling, NICE (JAX ``blocks.py:258``):
    xb' = xb + t_i(xa), logdet 0."""

    def _nets(self, in_dim, hidden_dim, hidden_depth, dtype, device):
        self.t = self._mlps(in_dim, self.dim2, False, hidden_dim,
                            hidden_depth, dtype, device)

    def _couple(self, i, h, xb, reverse):
        t = self.t[i](h)
        return (xb - t if reverse else xb + t), None


# coupling_type -> coupling class; the package adds "rqs" (spline.py)
COUPLING_TYPES = {
    "affine": DoubleCoupling,
    "gin": GINCoupling,
    "nice": NICECoupling,
}


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
    """ActNorm -> coupling of ``coupling_type`` (:data:`COUPLING_TYPES`)
    -> Shuffle (one flow step)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, coupling_type: str = "affine",
                 dtype=torch.float32, device=None):
        super().__init__()
        if coupling_type not in COUPLING_TYPES:
            raise ValueError(f"unknown coupling_type {coupling_type!r}; "
                             f"expected one of {sorted(COUPLING_TYPES)}")
        self.norm_layer = ActNorm(in_channels, device=device)
        self.coupling = COUPLING_TYPES[coupling_type](
            in_channels, hidden_dim, hidden_depth, dtype=dtype,
            device=device)
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
