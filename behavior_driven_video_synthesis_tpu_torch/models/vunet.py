"""VUNet-alter: the appearance/shape image synthesizer, NHWC, eval mode.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/vunet.py`` for
the serving path: EncUp (eu, du), EncDown (ed) and DecDown (dd) in the
"alter" variant, with ``encode_means``, ``transfer_cached``, ``transfer``
and ``test_forward``.  Module names follow the reference's state dict
(``eu.blocks.{k}``, ``ed.make_latent_params.{i}``, ``dd.auto_blocks.{i}``,
``dd.out_conv``, ...), which is the layout
``models.convert.vunet_alter_reference_state_dict`` writes.

Latent sampling takes explicit noise (a list of tensors, one per latent
scale) or draws it from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.nn import Downsample, NormConv2d, Upsample, VunetRNB


def compute_n_scales(spatial_size: int, bottleneck_factor: int,
                     n_scales_cfg: int = 0) -> int:
    if n_scales_cfg >= 6:
        return n_scales_cfg
    return 1 + int(np.round(np.log2(spatial_size))) - bottleneck_factor


def _noise(eps: Optional[Sequence[torch.Tensor]], i: int, like: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if eps is not None:
        return eps[i].to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


class EncUp(nn.Module):
    """Bottom-up encoder: 2 RNBs per scale, stride-2 downsample between."""

    def __init__(self, in_channels: int, n_scales: int, nf_start: int,
                 nf_max: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        nf = nf_start
        self.out_channels: List[int] = []
        self.nin = NormConv2d(in_channels, nf, 1, **kw)
        blocks, downs = [], []
        for i in range(n_scales):
            for _ in range(2):
                blocks.append(VunetRNB(nf, **kw))
                self.out_channels.append(nf)
            if i + 1 < n_scales:
                nf_next = min(2 * nf, nf_max)
                downs.append(Downsample(nf, nf_next, **kw))
                nf = nf_next
        self.blocks = nn.ModuleList(blocks)
        self.downs = nn.ModuleList(downs)

    def forward(self, x) -> List[torch.Tensor]:
        hs = []
        h = self.nin(x)
        for i, down in enumerate(list(self.downs) + [None]):
            for block in self.blocks[2 * i:2 * i + 2]:
                h = block(h)
                hs.append(h)
            if down is not None:
                h = down(h)
        return hs


class EncDown(nn.Module):
    """Top-down posterior (alter variant: learned, sigmoid-squashed logstd)
    over ``n_latent_scales`` scales, fed by EncUp's skips."""

    def __init__(self, skip_channels: Sequence[int], nf: int,
                 n_latent_scales: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        skips = list(skip_channels)
        self.nin = NormConv2d(skips[-1], nf, 1, **kw)
        blocks, mus, logstds, ups = [], [], [], []
        for _ in range(n_latent_scales):
            blocks.append(VunetRNB(nf, True, skips.pop(), **kw))
            mus.append(NormConv2d(nf, nf, 3, padding=1, **kw))
            logstds.append(NormConv2d(nf, nf, 3, padding=1, **kw))
            blocks.append(VunetRNB(nf, True, skips.pop() + nf, **kw))
            ups.append(Upsample(nf, nf, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.make_latent_params = nn.ModuleList(mus)
        self.make_logstds = nn.ModuleList(logstds)
        self.ups = nn.ModuleList(ups)
        self.fin_block = VunetRNB(nf, True, skips.pop(), **kw)

    def forward(self, gs, eps=None, generator=None):
        """Returns (hs, means, logstds, zs); z = mean + exp(logstd) * eps."""
        gs = list(gs)
        hs, means, logstds, zs = [], [], [], []
        h = self.nin(gs[-1])
        for i, up in enumerate(self.ups):
            h = self.blocks[2 * i](h, gs.pop())
            hs.append(h)
            mu = self.make_latent_params[i](h)
            means.append(mu)
            logstd = torch.sigmoid(self.make_logstds[i](h))
            logstds.append(logstd)
            z = mu + torch.exp(logstd) * _noise(eps, i, mu, generator)
            zs.append(z)
            h = self.blocks[2 * i + 1](h, torch.cat([gs.pop(), z], dim=-1))
            hs.append(h)
            h = up(h)
        h = self.fin_block(h, gs.pop())
        hs.append(h)
        return hs, means, logstds, zs


class DecDown(nn.Module):
    """Top-down generator (alter variant): fuses DecUp's skips and injects
    one latent per scale at the first ``n_latent_scales`` scales."""

    def __init__(self, skip_channels: Sequence[int], n_scales: int,
                 nf_in: int, nf_last: int, nf_out: int = 3,
                 n_latent_scales: int = 2, subpixel_upsampling: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        skips = list(skip_channels)
        self.n_latent_scales = n_latent_scales
        nf = nf_in
        self.nin = NormConv2d(skips[-1], nf, 1, **kw)
        blocks, autos, ups = [], [], []
        for i in range(n_scales):
            blocks.append(VunetRNB(nf, True, skips.pop(), **kw))
            if i < n_latent_scales:
                autos.append(VunetRNB(nf, True, nf, **kw))
            blocks.append(VunetRNB(nf, True, skips.pop(), **kw))
            if i + 1 < n_scales:
                out_c = min(nf_in, nf_last * 2 ** (n_scales - (i + 2)))
                ups.append(Upsample(nf, out_c, subpixel=(
                    subpixel_upsampling or i < n_latent_scales), **kw))
                nf = out_c
        self.blocks = nn.ModuleList(blocks)
        self.auto_blocks = nn.ModuleList(autos)
        self.ups = nn.ModuleList(ups)
        self.out_conv = NormConv2d(nf, nf_out, 3, padding=1, **kw)

    def forward(self, gs, zs_posterior=None, eps=None, generator=None):
        """With ``zs_posterior`` the latents are those; else each is drawn
        from the N(0, 1) prior (``eps`` or ``generator``).  Returns the
        image (NHWC, nf_out channels)."""
        gs = list(gs)
        h = self.nin(gs[-1])
        n_scales = len(self.blocks) // 2
        for i in range(n_scales):
            h = self.blocks[2 * i](h, gs.pop())
            if i < self.n_latent_scales:
                z = (zs_posterior[i] if zs_posterior is not None
                     else _noise(eps, i, h, generator))
                h = self.auto_blocks[i](h, z)
            h = self.blocks[2 * i + 1](h, gs.pop())
            if i + 1 < n_scales:
                h = self.ups[i](h)
        return self.out_conv(h)


class VUNet(nn.Module):
    """VUNet in the alter variant, inference only.

    Every method takes and returns NHWC tensors.  Options of the JAX
    package that this slice does not port raise NotImplementedError.
    """

    def __init__(self, spatial_size: int = 256, n_channels_x: int = 3,
                 nf_start: int = 32, nf_max: int = 128,
                 n_latent_scales: int = 2, bottleneck_factor: int = 2,
                 box_factor: int = 2, n_scales_cfg: int = 0,
                 subpixel_upsampling: bool = True,
                 conv_layer_type: str = "l1", variant: str = "alter",
                 quant: str = "none", upsample_transpose: bool = False,
                 remat=False, dtype=torch.float32, device=None):
        super().__init__()
        unported = {
            "variant": (variant, "alter"),
            "conv_layer_type": (conv_layer_type, "l1"),
            "quant": (quant, "none"),
            "upsample_transpose": (upsample_transpose, False),
            "remat": (remat, False),
        }
        for name, (value, supported) in unported.items():
            if value != supported:
                raise NotImplementedError(
                    f"VUNet {name}={value!r} is not ported yet")
        self.spatial_size, self.dtype = spatial_size, dtype
        n_scales = compute_n_scales(spatial_size, bottleneck_factor,
                                    n_scales_cfg)
        n_scales_x = n_scales - box_factor if n_channels_x > 3 else n_scales
        kw = dict(dtype=dtype, device=device)
        self.eu = EncUp(n_channels_x, n_scales_x, nf_start, nf_max, **kw)
        self.ed = EncDown(self.eu.out_channels, nf_max, n_latent_scales,
                          **kw)
        self.du = EncUp(3, n_scales, nf_start, nf_max, **kw)
        self.dd = DecDown(self.du.out_channels, n_scales, nf_max, nf_start,
                          3, n_latent_scales, subpixel_upsampling, **kw)

    def encode_means(self, x, eps=None, generator=None):
        """Posterior means and logstds of appearance x (once per video)."""
        _, means, logstds, _ = self.ed(self.eu(x), eps, generator)
        return means, logstds

    def transfer_cached(self, means, c):
        """Appearance transfer from pre-computed posterior means: only the
        shape encoder and the generator (du + dd) run per frame."""
        return self.dd(self.du(c), list(means))

    def transfer(self, x, c, eps=None, generator=None):
        """Appearance transfer with the posterior means of x."""
        means, _ = self.encode_means(x, eps, generator)
        return self.transfer_cached(means, c)

    def test_forward(self, c, eps=None, generator=None):
        """Appearance sampled from the prior given only the stickman."""
        return self.dd(self.du(c), None, eps, generator)


def vunet_from_config(config: Optional[dict], variant: str,
                      n_channels_x: Optional[int] = None, **overrides):
    """Build a VUNet from a run config (a plain dict with "architecture",
    "data" and "training" keys) with the JAX package's defaults;
    ``overrides`` set serving-only options (dtype, device, ...)."""
    config = config or {}
    arch = config.get("architecture", {})
    data = config.get("data", {})
    training = config.get("training", {})
    if n_channels_x is None:
        n_channels_x = 30 if bool(data.get("inplane_normalize", False)) else 3
    kw = dict(
        spatial_size=int(data.get("spatial_size", 256)),
        n_channels_x=n_channels_x,
        nf_start=int(arch.get("nf_start", 32)),
        nf_max=int(arch.get("nf_max", 128)),
        n_latent_scales=int(arch.get("n_latent_scales", 2)),
        bottleneck_factor=int(data.get("bottleneck_factor", 2)),
        box_factor=int(data.get("box_factor", 2)),
        n_scales_cfg=int(arch.get("n_scales", 0)),
        subpixel_upsampling=bool(arch.get("subpixel_upsampling", True)),
        conv_layer_type=str(arch.get("conv_layer_type", "l1")),
        variant=variant,
        remat=training.get("remat", False) or False,
        dtype=(torch.bfloat16 if bool(training.get("bf16", True))
               else torch.float32),
    )
    kw.update(overrides)
    return VUNet(**kw)
