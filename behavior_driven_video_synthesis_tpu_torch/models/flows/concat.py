"""Conditional flow with a learned conditioning embedder ("concat flow").

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/
concat.py`` (the reference's models/flow/concat_flow.py:14-124): a
:class:`~.conditional.ConditionalFlow` whose conditioning first runs
through :class:`DenseEmbedder` (label-like, 1x1 conditionings) or
:class:`Embedder` (images, NHWC: FeatureLayer scales and a dense head).
As in JAX, :meth:`ConditionalTransformer.reverse` is the reverse path and
:meth:`~ConditionalTransformer.sample` draws from an explicit generator.

The embedders' ActNorm and FeatureLayer statistics come from data: a new
model calls ``initialize_`` on a first batch, as JAX's init does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nn import DenseEncoderLayer, FeatureLayer, feature_layer_width
from .blocks import ActNorm
from .conditional import ConditionalFlow


class DenseEmbedder(nn.Module):
    """Linear -> ActNorm -> LeakyReLU(0.2) per hidden width, then a last
    Linear (the reference's kernel-1 convs).  The widths are
    ``given_dims``, or ``depth`` linspace'd ints from in_dim to up_dim.
    ``net`` holds the layers in that order (Linear at 3l, ActNorm at
    3l+1, the activation at 3l+2).  A (B, 1, 1, C) conditioning map is
    flattened first."""

    def __init__(self, in_dim: int, up_dim: int, depth: int = 4,
                 given_dims: Optional[Sequence[int]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        if given_dims is not None:
            if given_dims[0] != in_dim or given_dims[-1] != up_dim:
                raise ValueError(f"given_dims {given_dims} do not run from "
                                 f"{in_dim} to {up_dim}")
            dims = list(given_dims)
        else:
            dims = np.linspace(in_dim, up_dim, depth).astype(int).tolist()
        layers = []
        for d_in, d_out in zip(dims[:-2], dims[1:-1]):
            layers += [nn.Linear(d_in, d_out, device=device),
                       ActNorm(d_out, device=device), nn.LeakyReLU(0.2)]
        layers.append(nn.Linear(dims[-2], dims[-1], device=device))
        self.net = nn.ModuleList(layers)

    def _layers(self, x, until=None):
        """Run the net on x; with ``until`` (an ActNorm) stop before it."""
        h, dt = x.reshape(x.shape[0], -1).to(self.dtype), self.dtype
        for layer in self.net:
            if layer is until:
                return h
            if isinstance(layer, nn.Linear):
                h = F.linear(h, layer.weight.to(dt), layer.bias.to(dt))
            elif isinstance(layer, ActNorm):
                h, _ = layer(h)
            else:
                h = layer(h)
        return h

    def forward(self, x):
        return self._layers(x)

    @torch.no_grad()
    def initialize_(self, x):
        """Each ActNorm from the activations that reach it on x, in
        order."""
        for layer in self.net:
            if isinstance(layer, ActNorm):
                layer.initialize_(self._layers(x, until=layer))


class Embedder(nn.Module):
    """Image conditioning encoder: ``n_down`` FeatureLayer scales, then a
    dense head over the (spatial_size / 2**n_down)^2 bottleneck."""

    def __init__(self, in_channels: int, emb_dim: int, spatial_size: int,
                 n_down: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.feature_layers = nn.ModuleList(
            [FeatureLayer(0, in_channels=in_channels, dtype=dtype,
                          device=device)]
            + [FeatureLayer(scale, dtype=dtype, device=device)
               for scale in range(1, n_down)])
        bottleneck = spatial_size // 2 ** n_down
        self.dense_encode = DenseEncoderLayer(
            bottleneck * bottleneck * feature_layer_width(n_down - 1),
            emb_dim, dtype=dtype, device=device)

    def forward(self, x):
        for layer in self.feature_layers:
            x = layer(x)
        return self.dense_encode(x)

    @torch.no_grad()
    def initialize_(self, x):
        for layer in self.feature_layers:
            layer.initialize_(x)
            x = layer(x)


class ConditionalTransformer(nn.Module):
    """Embedder + ConditionalFlow over flat latents (B, C) (reference
    ConditionalTransformer).  A conditioning of ``conditioning_spatial_size``
    1 goes through a :class:`DenseEmbedder`, a larger one (NHWC images)
    through an :class:`Embedder`."""

    def __init__(self, in_channels: int, mid_channels: int,
                 hidden_depth: int, n_flows: int,
                 conditioning_option: str = "none",
                 conditioning_spatial_size: int = 1,
                 conditioning_in_channels: int = 0,
                 embedding_channels: Optional[int] = None,
                 embedder_down: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        emb = in_channels if embedding_channels is None \
            else embedding_channels
        self.flow = ConditionalFlow(
            in_channels, emb, mid_channels, hidden_depth, n_flows,
            conditioning_option=conditioning_option, dtype=dtype,
            device=device)
        if conditioning_spatial_size == 1:
            self.embedder = DenseEmbedder(conditioning_in_channels, emb,
                                          dtype=dtype, device=device)
        else:
            self.embedder = Embedder(conditioning_in_channels, emb,
                                     conditioning_spatial_size,
                                     n_down=embedder_down, dtype=dtype,
                                     device=device)

    def embed(self, conditioning):
        return self.embedder(conditioning)

    def forward(self, x, conditioning, reverse: bool = False):
        return self.flow(x, self.embed(conditioning), reverse=reverse)

    def reverse(self, z, conditioning):
        return self(z, conditioning, reverse=True)

    def sample(self, generator: Optional[torch.Generator], shape,
               conditioning):
        z = torch.randn(shape, generator=generator, dtype=self.dtype,
                        device=conditioning.device)
        return self.reverse(z, conditioning)

    @torch.no_grad()
    def initialize_(self, x, conditioning):
        """The data-dependent init on a first batch: the embedder's
        statistics from the conditioning, then the flow's ActNorms from x
        and the embedding, in JAX's order."""
        self.embedder.initialize_(conditioning)
        self.flow.initialize_(x, self.embed(conditioning))
