"""VUNet: the appearance/shape image synthesizer, NHWC.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/vunet.py``:
EncUp (eu, du), EncDown (ed) and DecDown (dd) in the "alter" and "org"
variants, with the training ``forward`` (posterior samples, dropout),
``encode_means``, ``transfer_cached``, ``transfer`` and ``test_forward``,
and the latent pose regressor ``VunetRegressor``.  Module names follow the
reference's state dict (``eu.blocks.{k}``, ``ed.make_latent_params.{i}``,
``dd.auto_blocks.{i}`` or, org, ``dd.auto_blocks.l_{i}.{j}``,
``dd.out_conv``, ...), the layouts ``models.convert.vunet_alter_plan`` and
``vunet_org_plan`` write.

The variants differ at the latent scales.  "alter": a learned,
sigmoid-squashed posterior logstd, and one z-injection RNB per scale in
DecDown.  "org" (the original VUNet): a posterior of fixed std 1, and in
DecDown the 4-group space-to-depth autoregressive prior, whose latent
enters through a 1x1 ``latent_nins`` conv.

Latent sampling takes explicit noise (a list with one entry per latent
scale; for the org prior each entry is a list of the four groups' tensors)
or draws it from a ``torch.Generator``; dropout masks come from a second
generator, ``dropout_generator`` (the JAX package's "sample" and "dropout"
rng collections).  ``rnb_impl="fused"`` runs every RNB without auxiliary
input (EncUp's, and the org prior's ``pre`` block) through the fused RNB
kernel at inference.

``remat`` (``training.remat``) trades memory for compute in the training
``forward``: ``True`` or ``"rnb"`` recomputes every ``VunetRNB`` in the
backward pass, ``"subnet"`` each of eu, ed, du and dd whole; the
recomputations draw the same noise and masks
(``ops.nn.checkpoint_with_generators``), and the state dict is the same
under every setting, so remat can be flipped on any checkpoint.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import batch_draws
from ..ops.nn import (CONV_LAYERS, Downsample, NormConv2d, Upsample,
                      VunetRNB, checkpoint_with_generators, conv2d_nhwc,
                      depth_to_space, quant_calibration, quant_scales,
                      space_to_depth)

VARIANTS = ("alter", "org")
REMAT = (False, True, "rnb", "subnet")


def compute_n_scales(spatial_size: int, bottleneck_factor: int,
                     n_scales_cfg: int = 0) -> int:
    if n_scales_cfg >= 6:
        return n_scales_cfg
    return 1 + int(np.round(np.log2(spatial_size))) - bottleneck_factor


def _noise(eps: Optional[Sequence[torch.Tensor]], i: int, like: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if eps is not None:
        return eps[i].to(device=like.device, dtype=like.dtype)
    return batch_draws.randn(like.shape, generator=generator,
                             dtype=like.dtype, device=like.device)


class EncUp(nn.Module):
    """Bottom-up encoder: 2 RNBs per scale, stride-2 downsample between."""

    def __init__(self, in_channels: int, n_scales: int, nf_start: int,
                 nf_max: int, dropout_prob: float = 0.0,
                 dropout_impl: str = "flax", rnb_impl: str = "cudnn",
                 conv_layer=NormConv2d, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        rnb_kw = dict(dropout_prob=dropout_prob, dropout_impl=dropout_impl,
                      rnb_impl=rnb_impl, conv_layer=conv_layer, **kw)
        nf = nf_start
        self.out_channels: List[int] = []
        self.nin = conv_layer(in_channels, nf, 1, **kw)
        blocks, downs = [], []
        for i in range(n_scales):
            for _ in range(2):
                blocks.append(VunetRNB(nf, **rnb_kw))
                self.out_channels.append(nf)
            if i + 1 < n_scales:
                nf_next = min(2 * nf, nf_max)
                downs.append(Downsample(nf, nf_next, conv_layer, **kw))
                nf = nf_next
        self.blocks = nn.ModuleList(blocks)
        self.downs = nn.ModuleList(downs)

    def forward(self, x, train: bool = False,
                dropout_generator=None) -> List[torch.Tensor]:
        hs = []
        h = self.nin(x)
        for i, down in enumerate(list(self.downs) + [None]):
            for block in self.blocks[2 * i:2 * i + 2]:
                h = block(h, None, train, dropout_generator)
                hs.append(h)
            if down is not None:
                h = down(h)
        return hs


class EncDown(nn.Module):
    """Top-down posterior over ``n_latent_scales`` scales, fed by EncUp's
    skips: "alter" learns a sigmoid-squashed logstd, "org" has std 1."""

    def __init__(self, skip_channels: Sequence[int], nf: int,
                 n_latent_scales: int = 2, variant: str = "alter",
                 dropout_prob: float = 0.0, dropout_impl: str = "flax",
                 rnb_impl: str = "cudnn", conv_layer=NormConv2d,
                 upsample_transpose: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        rnb_kw = dict(dropout_prob=dropout_prob, dropout_impl=dropout_impl,
                      rnb_impl=rnb_impl, conv_layer=conv_layer, **kw)
        self.variant = variant
        skips = list(skip_channels)
        self.nin = conv_layer(skips[-1], nf, 1, **kw)
        blocks, mus, logstds, ups = [], [], [], []
        for _ in range(n_latent_scales):
            blocks.append(VunetRNB(nf, True, skips.pop(), **rnb_kw))
            mus.append(conv_layer(nf, nf, 3, padding=1, **kw))
            if variant == "alter":
                logstds.append(conv_layer(nf, nf, 3, padding=1, **kw))
            blocks.append(VunetRNB(nf, True, skips.pop() + nf, **rnb_kw))
            ups.append(Upsample(nf, nf, transpose=upsample_transpose,
                                conv_layer=conv_layer, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.make_latent_params = nn.ModuleList(mus)
        if variant == "alter":
            self.make_logstds = nn.ModuleList(logstds)
        self.ups = nn.ModuleList(ups)
        self.fin_block = VunetRNB(nf, True, skips.pop(), **rnb_kw)

    def forward(self, gs, eps=None, generator=None, train: bool = False,
                dropout_generator=None):
        """Returns (hs, means, logstds, zs); z = mean + exp(logstd) * eps
        ("alter") or mean + eps ("org", whose logstds are empty)."""
        gs = list(gs)
        hs, means, logstds, zs = [], [], [], []
        h = self.nin(gs[-1])
        drop = (train, dropout_generator)
        for i, up in enumerate(self.ups):
            h = self.blocks[2 * i](h, gs.pop(), *drop)
            hs.append(h)
            mu = self.make_latent_params[i](h)
            means.append(mu)
            noise = _noise(eps, i, mu, generator)
            if self.variant == "alter":
                logstd = torch.sigmoid(self.make_logstds[i](h))
                logstds.append(logstd)
                z = mu + torch.exp(logstd) * noise
            else:
                z = mu + noise
            zs.append(z)
            h = self.blocks[2 * i + 1](h, torch.cat([gs.pop(), z], dim=-1),
                                       *drop)
            hs.append(h)
            h = up(h)
        h = self.fin_block(h, gs.pop(), *drop)
        hs.append(h)
        return hs, means, logstds, zs


class DecDown(nn.Module):
    """Top-down generator: fuses DecUp's skips and, at the first
    ``n_latent_scales`` scales, injects one latent ("alter": a z-injection
    RNB; "org": the 4-group autoregressive prior, then ``latent_nins``)."""

    def __init__(self, skip_channels: Sequence[int], n_scales: int,
                 nf_in: int, nf_last: int, nf_out: int = 3,
                 n_latent_scales: int = 2, subpixel_upsampling: bool = True,
                 variant: str = "alter", dropout_prob: float = 0.0,
                 dropout_impl: str = "flax", rnb_impl: str = "cudnn",
                 conv_layer=NormConv2d, upsample_transpose: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        rnb_kw = dict(dropout_prob=dropout_prob, dropout_impl=dropout_impl,
                      rnb_impl=rnb_impl, conv_layer=conv_layer, **kw)
        skips = list(skip_channels)
        self.n_latent_scales, self.variant = n_latent_scales, variant
        nf = nf_in
        self.nin = conv_layer(skips[-1], nf, 1, **kw)
        blocks, ups = [], []
        autos, auto_lp, latent_nins = [], {}, {}
        for i in range(n_scales):
            blocks.append(VunetRNB(nf, True, skips.pop(), **rnb_kw))
            if i < n_latent_scales and variant == "alter":
                autos.append(VunetRNB(nf, True, nf, **rnb_kw))
            elif i < n_latent_scales:
                # pre (no aux), then 3 residual blocks at 4*nf fed by the
                # group feedback; 4 group-mean convs; the latent's 1x1 nin
                autos.append((f"l_{i}", nn.ModuleList(
                    [VunetRNB(nf, **rnb_kw)]
                    + [VunetRNB(4 * nf, True, nf, **rnb_kw)
                       for _ in range(3)])))
                auto_lp[f"l_{i}"] = nn.ModuleList(
                    conv_layer(4 * nf, nf, 3, padding=1, **kw)
                    for _ in range(4))
                latent_nins[f"l_{i}"] = conv_layer(2 * nf, nf, 1, **kw)
            blocks.append(VunetRNB(nf, True, skips.pop(), **rnb_kw))
            if i + 1 < n_scales:
                out_c = min(nf_in, nf_last * 2 ** (n_scales - (i + 2)))
                ups.append(Upsample(nf, out_c, subpixel=(
                    subpixel_upsampling or i < n_latent_scales),
                    transpose=upsample_transpose, conv_layer=conv_layer,
                    **kw))
                nf = out_c
        self.blocks = nn.ModuleList(blocks)
        if variant == "alter":
            self.auto_blocks = nn.ModuleList(autos)
        else:
            self.auto_blocks = nn.ModuleDict(autos)
            self.auto_lp = nn.ModuleDict(auto_lp)
            self.latent_nins = nn.ModuleDict(latent_nins)
        self.ups = nn.ModuleList(ups)
        self.out_conv = conv_layer(nf, nf_out, 3, padding=1, **kw)

    def forward(self, gs, zs_posterior=None, eps=None, generator=None,
                train: bool = False, dropout_generator=None,
                prior: bool = False):
        """With ``zs_posterior`` the latents are those; else each is drawn
        from the prior (``eps`` or ``generator``): N(0, 1) for "alter",
        the autoregressive prior for "org".  Returns the image (NHWC,
        nf_out channels), the features after each block pair's blocks (the
        JAX package's ``hs``) and the org prior's means, one per latent
        scale.  Given ``zs_posterior``, those means feed nothing but the
        training KL, so they are computed only with ``prior=True``."""
        gs = list(gs)
        h = self.nin(gs[-1])
        hs, ps = [], []
        drop = (train, dropout_generator)
        n_scales = len(self.blocks) // 2
        for i in range(n_scales):
            h = self.blocks[2 * i](h, gs.pop(), *drop)
            hs.append(h)
            if i < self.n_latent_scales:
                z = None if zs_posterior is None else zs_posterior[i]
                if self.variant == "alter":
                    if z is None:
                        z = _noise(eps, i, h, generator)
                    h = self.auto_blocks[i](h, z, *drop)
                else:
                    if z is None or prior:
                        p, z = self._autoregressive_prior(
                            i, h, z, None if eps is None else eps[i],
                            generator, drop)
                        ps.append(p)
                    h = self.latent_nins[f"l_{i}"](torch.cat([h, z], -1))
            h = self.blocks[2 * i + 1](h, gs.pop(), *drop)
            hs.append(h)
            if i + 1 < n_scales:
                h = self.ups[i](h)
        return self.out_conv(h), hs, ps

    def _autoregressive_prior(self, i, h, z_posterior, eps, generator, drop):
        """The org prior at latent scale i (JAX ``vunet.py:275-316``): the
        latent splits into 4 space-to-depth groups; each group's prior
        mean comes from features that have seen the previous groups, fed
        back as their posterior values (given ``z_posterior``) or as
        samples ``mean + eps[l]`` (or a draw from ``generator``).  Returns
        (prior means, latent), both at h's size."""
        blocks, lps = self.auto_blocks[f"l_{i}"], self.auto_lp[f"l_{i}"]
        if z_posterior is not None:
            post = torch.chunk(space_to_depth(z_posterior, 2), 4, dim=-1)
        feats = space_to_depth(blocks[0](h, None, *drop), 2)
        p_groups, z_groups = [], []
        for l in range(4):
            p = lps[l](feats)
            p_groups.append(p)
            if z_posterior is None:
                z_groups.append(p + _noise(eps, l, p, generator))
            if l + 1 < 4:
                feats = blocks[l + 1](
                    feats, z_groups[l] if z_posterior is None else post[l],
                    *drop)
        p = depth_to_space(torch.cat(p_groups, -1), 2)
        if z_posterior is not None:
            return p, z_posterior
        return p, depth_to_space(torch.cat(z_groups, -1), 2)


class VUNet(nn.Module):
    """VUNet in the "alter" (cvbae) or "org" (original) variant.

    Every method takes and returns NHWC tensors.

    ``conv_layer_type`` picks every sub-network's conv layer
    (``ops.nn.CONV_LAYERS``: ``l1``, ``l2``, ``ln``).  ``quant`` (``int8``
    or ``int8_static``) and ``quant_max_hw`` make the per-frame path's
    (du and dd) 3x3 convs int8 (``ops.nn.NormConv2d``); eu and ed, which
    run once a video, stay in full precision.  ``int8_static`` serves the
    scales of a calibration pass (:func:`calibrate_quant`).
    ``upsample_transpose`` computes every subpixel upsample as one
    transposed conv.  Quant and the transposed upsample need ``l1``
    (ValueError otherwise, the JAX package's assertions), as does
    ``rnb_impl="fused"``.
    """

    def __init__(self, spatial_size: int = 256, n_channels_x: int = 3,
                 nf_start: int = 32, nf_max: int = 128,
                 n_latent_scales: int = 2, bottleneck_factor: int = 2,
                 box_factor: int = 2, n_scales_cfg: int = 0,
                 subpixel_upsampling: bool = True,
                 conv_layer_type: str = "l1", variant: str = "alter",
                 dropout_prob: float = 0.0, dropout_impl: str = "flax",
                 rnb_impl: str = "cudnn", quant: str = "none",
                 quant_max_hw: int = 0, upsample_transpose: bool = False,
                 remat=False, dtype=torch.float32, device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown VUNet variant {variant!r}; expected "
                             f"one of {VARIANTS}")
        if conv_layer_type not in CONV_LAYERS:
            raise ValueError(f"unknown conv_layer_type {conv_layer_type!r}; "
                             f"expected one of {tuple(CONV_LAYERS)}")
        conv_layer = CONV_LAYERS[conv_layer_type]
        conv_layer_pf = conv_layer
        if quant != "none":
            if conv_layer is not NormConv2d:
                raise ValueError("quantized serving requires the l1 "
                                 "(NormConv2d) conv layer")
            conv_layer_pf = partial(NormConv2d, quant=quant,
                                    quant_max_hw=quant_max_hw)
        if upsample_transpose and conv_layer is not NormConv2d:
            raise ValueError("upsample_transpose requires the l1 "
                             "(NormConv2d) conv layer")
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.spatial_size, self.dtype = spatial_size, dtype
        self.variant, self.remat = variant, remat
        n_scales = compute_n_scales(spatial_size, bottleneck_factor,
                                    n_scales_cfg)
        n_scales_x = n_scales - box_factor if n_channels_x > 3 else n_scales
        kw = dict(dropout_prob=dropout_prob, dropout_impl=dropout_impl,
                  rnb_impl=rnb_impl, dtype=dtype, device=device)
        self.eu = EncUp(n_channels_x, n_scales_x, nf_start, nf_max,
                        conv_layer=conv_layer, **kw)
        self.ed = EncDown(self.eu.out_channels, nf_max, n_latent_scales,
                          variant, conv_layer=conv_layer,
                          upsample_transpose=upsample_transpose, **kw)
        self.du = EncUp(3, n_scales, nf_start, nf_max,
                        conv_layer=conv_layer_pf, **kw)
        self.dd = DecDown(self.du.out_channels, n_scales, nf_max, nf_start,
                          3, n_latent_scales, subpixel_upsampling, variant,
                          conv_layer=conv_layer_pf,
                          upsample_transpose=upsample_transpose, **kw)
        if remat is True or remat == "rnb":
            for m in self.modules():
                if isinstance(m, VunetRNB):
                    m.remat = True

    def _subnet(self, module, generators, *args, **kwargs):
        """module(*args, **kwargs), recomputed in the backward pass under
        ``remat="subnet"`` when training under autograd."""
        if (self.remat == "subnet" and kwargs.get("train")
                and torch.is_grad_enabled()):
            return checkpoint_with_generators(module, generators, *args,
                                              **kwargs)
        return module(*args, **kwargs)

    def forward(self, x, c, train: bool = False, eps=None, generator=None,
                dropout_generator=None):
        """The training path: appearance x and stickman c (NHWC) through
        eu, ed (posterior samples), du and dd; dropout only with
        ``train=True``.  Returns (imgs, means, logstds, ps, activations)
        as the JAX ``VUNet.__call__``: ``ps`` are the org prior's means
        (empty for "alter"), activations are (hs, es, gs, ds)."""
        drop = dict(train=train, dropout_generator=dropout_generator)
        gens = (generator, dropout_generator)
        hs = self._subnet(self.eu, gens, x, **drop)
        es, means, logstds, zs = self._subnet(self.ed, gens, hs, eps,
                                              generator, **drop)
        gs = self._subnet(self.du, gens, c, **drop)
        imgs, ds, ps = self._subnet(self.dd, gens, gs, zs, prior=True,
                                    **drop)
        return imgs, means, logstds, ps, (hs, es, gs, ds)

    def encode_means(self, x, eps=None, generator=None):
        """Posterior means and logstds (empty for "org") of appearance x
        (once per video)."""
        _, means, logstds, _ = self.ed(self.eu(x), eps, generator)
        return means, logstds

    def transfer_cached(self, means, c):
        """Appearance transfer from pre-computed posterior means: only the
        shape encoder and the generator (du + dd) run per frame."""
        return self.dd(self.du(c), list(means))[0]

    def transfer(self, x, c, eps=None, generator=None):
        """Appearance transfer with the posterior means of x."""
        means, _ = self.encode_means(x, eps, generator)
        return self.transfer_cached(means, c)

    def test_forward(self, c, eps=None, generator=None):
        """Appearance sampled from the prior given only the stickman."""
        return self.dd(self.du(c), None, eps, generator)[0]


def calibrate_quant(vunet: VUNet, means, stickman) -> dict:
    """One calibration pass of an ``int8_static`` VUNet (JAX
    ``models/vunet.py:512-525``): ``transfer_cached`` on (means, stickman)
    with every int8 conv folding its input's max|x| + 1e-12 into its
    stored running max.  As in the JAX package's ``transfer_cached``, the
    org prior runs too (fed the posterior means), so its convs are
    calibrated though serving skips them.  Returns the scales
    (``ops.nn.quant_scales``); call it again over other batches to widen
    them."""
    with torch.no_grad(), quant_calibration(vunet):
        vunet.dd(vunet.du(stickman), list(means), prior=True)
    return quant_scales(vunet)


def vunet_from_config(config: Optional[dict], variant: str,
                      n_channels_x: Optional[int] = None, **overrides):
    """Build a VUNet from a run config (a plain dict with "architecture",
    "data" and "training" keys) with the JAX package's defaults;
    ``overrides`` set options such as dtype, device and rnb_impl, and the
    serving-only quant, quant_max_hw and upsample_transpose."""
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
        dropout_prob=float(training.get("dropout_prob", 0.0)),
        dropout_impl=str(training.get("dropout_impl", "flax")),
        remat=training.get("remat", False) or False,
        dtype=(torch.bfloat16 if bool(training.get("bf16", True))
               else torch.float32),
    )
    kw.update(overrides)
    return VUNet(**kw)


def latent_widths(spatial_size: int, bottleneck_factor: int = 2,
                  n_scales_cfg: int = 0, n_latent_scales: int = 2
                  ) -> List[int]:
    """Sizes of the posterior means' maps, smallest first (the regressor's
    ``latent_widths`` in the JAX experiment driver)."""
    n_scales = compute_n_scales(spatial_size, bottleneck_factor,
                                n_scales_cfg)
    bottleneck = spatial_size // 2 ** (n_scales - 1)
    return [bottleneck * 2 ** i for i in range(n_latent_scales)]


class VunetRegressor(nn.Module):
    """Latent -> 2D-pose probe (JAX ``models/vunet.py:528-558``): a VALID
    conv embedder over each posterior mean, ReLU, flatten, concat, MLP.

    As in the JAX package, embedder i takes ``latent_widths[i]`` as its
    kernel size and the i-th mean from the END of the list, whose map is
    ``latent_widths[-1 - i]`` wide.  An embedder whose kernel exceeds its
    map gives an empty output there (XLA's VALID conv), so it adds no
    features; its parameters exist all the same, so trees convert 1:1.
    Layers: ``embedders.{i}`` (flax ``Conv_{i}``), ``linears.{j}``
    (``Dense_{j}``); the math runs in f32 on NHWC maps.
    """

    def __init__(self, n_out: int, latent_widths: Sequence[int],
                 nf_max: int = 128, linear_width_factor: int = 1,
                 n_linear: int = 2, device=None):
        super().__init__()
        widths = list(latent_widths)
        features = linear_width_factor * nf_max
        self.embedders = nn.ModuleList(
            nn.Conv2d(nf_max, features, w, device=device) for w in widths)
        self.out_sizes = [max(widths[-1 - i] - w + 1, 0)
                          for i, w in enumerate(widths)]
        width = sum(features * s * s for s in self.out_sizes)
        linears = []
        for i in range(n_linear):
            out = max(width // 2, n_out) if i < n_linear - 1 else n_out
            linears.append(nn.Linear(width, out, device=device))
            width = out
        self.linears = nn.ModuleList(linears)

    def forward(self, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        outs = []
        for i, e in enumerate(reversed(list(embeddings))):
            if self.out_sizes[i] == 0:
                continue
            conv = self.embedders[i]
            y = torch.relu(conv2d_nhwc(e.float(), conv.weight, conv.bias,
                                       1, 0))
            outs.append(y.reshape(y.shape[0], -1))
        h = torch.cat(outs, dim=-1)
        for i, lin in enumerate(self.linears):
            h = lin(h)
            if i < len(self.linears) - 1:
                h = torch.relu(h)
        return h
