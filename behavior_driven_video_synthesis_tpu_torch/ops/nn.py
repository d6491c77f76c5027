"""NN primitives of the VUNet and the flows, NHWC at every public function.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/nn.py``.  Images
stay NHWC as in the JAX package; a conv views its NHWC input as an NCHW
tensor in ``torch.channels_last`` memory format (a free permute), so cuDNN
runs its NHWC kernels and the result permutes back to NHWC without a copy.

Parameters are float32 and keep the reference's state-dict names
(``conv.weight_v``, ``conv.weight_g``, ``conv.bias``, ``gamma``, ``beta``;
``main.{2k}.weight``); ``dtype`` is the compute dtype, as in the JAX
modules.

The three conv layers of ``architecture.conv_layer_type`` are
:data:`CONV_LAYERS`: ``l1`` :class:`NormConv2d` (weight norm), ``l2``
:class:`L2NormConv2d` and ``ln`` :class:`LayerNormConv2d`.  ``NormConv2d``
also serves int8 (``quant``, the int8 conv kernel of ``ops/cuda/
conv_int8.py``) and the subpixel upsample as one transposed conv
(``d2s_transpose``); at inference on the card its full-precision calls
fold the affine into the weights and end in the conv epilogue kernel
(``ops/cuda/conv_epilogue.py``).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .cuda.conv_int8 import (act_scale, conv_int8, kernel_takes,
                             pack_weights, quantize_weight)
from . import batch_draws
from .cuda.conv_epilogue import DTYPES as EPILOGUE_DTYPES
from .cuda.conv_epilogue import conv_epilogue, conv_epilogue_act
from .cuda import fused_rnb
from .cuda.elu_dropout import elu_dropout

QUANT_MODES = ("none", "int8", "int8_static")
# Builds of prepared kernel weights since import, by slot (prepared):
# "fold" (NormConv2d.folded), "int8" (a NormConv2d's int8 weights),
# "fused_rnb" (VunetRNB.fused_operands), "rollout"
# (ResidualDecoder.rollout_operands).
prepared_builds: Dict[str, int] = collections.Counter()


def prepared(owner, slot: str, params, build, *extra_key):
    """``build()`` under ``torch.no_grad()``, cached on ``owner`` under
    ``slot`` and kept while every tensor of ``params`` keeps its version
    counter, storage, device and dtype and ``extra_key`` is unchanged:
    ``load_state_dict``, an optimizer step or any other in-place update,
    ``.to()`` and a new ``extra_key`` rebuild it.  Each build counts in
    ``prepared_builds[slot]``.  The kernel weights a module derives from
    its parameters (folded, quantized or packed) are all kept so."""
    key = extra_key + tuple((p._version, p.data_ptr(), p.device, p.dtype)
                            for p in params)
    cache = vars(owner).setdefault("_prepared", {})
    hit = cache.get(slot)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = build()
    cache[slot] = (key, value)
    prepared_builds[slot] += 1
    return value


def space_to_depth(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """NHWC space->depth; channel (i*bs + j)*C + c <- pixel (h*bs+i, w*bs+j)."""
    n, h, w, c = x.shape
    bs = block_size
    x = x.reshape(n, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // bs, w // bs, bs * bs * c)


def depth_to_space(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """NHWC depth->space, inverse of :func:`space_to_depth`.

    Channels factor as (i, j, C') in C order.  ``torch.nn.PixelShuffle``
    factors them as (C', i, j) and would scramble converted weights.
    """
    n, h, w, c = x.shape
    bs = block_size
    cc = c // (bs * bs)
    x = x.reshape(n, h, w, bs, bs, cc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * bs, w * bs, cc)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int,
                padding: int) -> torch.Tensor:
    """conv2d of an NHWC tensor with an OIHW kernel, returning NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1)


class _WeightNormParams(nn.Module):
    """The reference's ``weight_norm(nn.Conv2d)`` parameters: v (OIHW),
    g (O, 1, 1, 1) and the conv bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 device=None):
        super().__init__()
        k = kernel_size
        self.weight_v = nn.Parameter(
            torch.empty(features, in_channels, k, k, device=device))
        self.weight_g = nn.Parameter(
            torch.ones(features, 1, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


class NormConv2d(nn.Module):
    """Weight-normalized conv with learned per-channel scale and shift.

    W = g * v / sqrt(sum(v^2) + 1e-12), the norm running over (cin, kh, kw)
    per output channel; y = gamma * (conv(x, W) + bias) + beta, with bias,
    gamma and beta cast to the compute dtype.

    ``quant`` (JAX ``ops/nn.py:155-282``): ``"int8"`` and ``"int8_static"``
    run a conv of kernel size at least 3 and at least 8 features, whose
    input is at most ``quant_max_hw`` high (0: any), as the int8 conv
    (``ops/cuda/conv_int8.py``: the kernel at 3x3 with padding 1, the
    library route at any other shape): activations quantized with one
    symmetric scale a tensor, W with one a output channel, the sum
    dequantized, then the affine in the compute dtype.  ``"int8"`` takes
    max|x| of each call as the scale; ``"int8_static"`` the running max stored in
    :attr:`act_amax` (``"ax"``, and ``"ax_aux"`` for the aux input), which
    a call under :func:`quant_calibration` folds its own max into (and
    uses).  The scales stay out of the state dict, as the JAX package keeps
    them in its ``quant`` collection (:func:`quant_scales`,
    :func:`load_quant_scales`).  W's int8 values are built once and kept
    (:func:`prepared`).

    ``d2s_transpose`` (JAX ``:76-108``, ``:246-260``): the conv to 4C of a
    subpixel upsample followed by ``depth_to_space(., 2)``, computed as one
    stride-2 transposed conv with the 6x6 kernel gathered from W, the
    affine applied by output parity.  The parameters are the same, so one
    checkpoint serves both forms.

    Every other call with autograd off, on a CUDA input and in bf16 or f16
    takes the folded route: gamma * (conv(x, W) + bias) + beta is
    conv(x, W') + b' with W' = gamma * W and b' = gamma * bias + beta
    (:meth:`folded`, built once in f32 and kept, :func:`prepared`), so the
    conv runs without bias and the conv epilogue kernel adds b', and the
    ``residual`` when one is given, in one pass.  With autograd on, on the
    CPU or in f32, a call computes the affine as above and then adds the
    ``residual``.  :meth:`route` names the route a call takes.  ``act_out``
    (the folded route only) has the epilogue store ELU of the output into
    that tensor, a channel slice of a contiguous NHWC buffer, instead of
    the output in place: a residual block assembles its conv input so.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, quant: str = "none",
                 quant_max_hw: int = 0, d2s_transpose: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant {quant!r}; expected one of "
                             f"{QUANT_MODES}")
        if d2s_transpose and not (stride == 1 and kernel_size == 3
                                  and padding == 1 and features % 4 == 0):
            raise ValueError("d2s_transpose supports the subpixel-upsample "
                             "conv shape only (3x3, stride 1, pad 1, "
                             "features divisible by 4)")
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.features, self.kernel_size = features, kernel_size
        self.quant, self.quant_max_hw = quant, quant_max_hw
        self.d2s_transpose = d2s_transpose
        self.conv = _WeightNormParams(in_channels, features, kernel_size,
                                      device)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, 1,
                                             device=device))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, 1,
                                             device=device))
        self.act_amax: Dict[str, torch.Tensor] = {}
        self.calibrating = False

    def kernel(self) -> torch.Tensor:
        v = self.conv.weight_v
        v_norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True)
                            + 1e-12)
        return v * (self.conv.weight_g / v_norm)

    def weight_params(self):
        """The parameters W and the affine come from: v, g, bias, gamma,
        beta."""
        return (self.conv.weight_v, self.conv.weight_g, self.conv.bias,
                self.gamma, self.beta)

    def route(self, x: torch.Tensor) -> str:
        """The route a call on x (NHWC) takes: ``"d2s_transpose"``;
        ``"int8"`` (JAX ``_quant_active``: 3x3 convs of at least 8
        features, 1x1 convs and small heads staying in full precision, and
        only where x is at most ``quant_max_hw`` high when that is above
        0); ``"folded"`` (autograd off, a CUDA input, a bf16 or f16
        compute dtype); else ``"unfolded"``."""
        if self.d2s_transpose:
            return "d2s_transpose"
        if (self.quant != "none" and self.kernel_size >= 3
                and self.features >= 8
                and (self.quant_max_hw <= 0
                     or x.shape[1] <= self.quant_max_hw)):
            return "int8"
        if (not torch.is_grad_enabled() and x.is_cuda
                and self.dtype in EPILOGUE_DTYPES):
            return "folded"
        return "unfolded"

    def _act_scale(self, x, name):
        if self.quant == "int8":
            return act_scale(x)
        if self.calibrating:
            ax = act_scale(x)
            old = self.act_amax.get(name)
            self.act_amax[name] = (ax if old is None else
                                   torch.maximum(old.to(ax.device), ax))
            return ax
        ax = self.act_amax.get(name)
        if ax is None:
            raise RuntimeError(
                f"this int8_static conv has no calibrated scale {name!r}: "
                "calibrate first (models.vunet.calibrate_quant)")
        return ax.to(x.device)

    def _int8_weights(self, cx: Optional[int]):
        """[(W_q, aw, packed for the kernel or None)] of W, or of its two
        fan-in halves at ``cx`` (x's channels, then aux's), each quantized
        over its own fan-in as the JAX package slices the kernel first;
        kept while v and g are unchanged (:func:`prepared`)."""
        def build():
            k = self.kernel().float()
            packs = k.device.type == "cuda" and kernel_takes(
                self.kernel_size, self.padding, self.stride)
            weights = []
            for w in [k] if cx is None else [k[:, :cx], k[:, cx:]]:
                w_q, aw = quantize_weight(w)
                weights.append((w_q, aw, pack_weights(w_q, aw)
                                if packs else None))
            return weights
        return prepared(self, "int8", (self.conv.weight_v,
                                       self.conv.weight_g), build, cx)

    def _forward_int8(self, x, aux):
        """The whole call, affine included, as one int8 conv (one kernel
        launch on the card): x's conv plus bias, aux's conv added in the
        compute dtype, then gamma * y + beta."""
        weights = self._int8_weights(None if aux is None else x.shape[-1])
        (w_q, aw, packed) = weights[0]
        ax = self._act_scale(x, "ax")
        kw = {}
        if aux is not None:
            (aux_w_q, aux_aw, aux_packed) = weights[1]
            kw = dict(aux=aux, aux_w_q=aux_w_q, aux_aw=aux_aw,
                      ax_aux=self._act_scale(aux, "ax_aux"),
                      aux_packed=aux_packed)
        return conv_int8(x, w_q, aw, ax, self.conv.bias.detach(), self.stride,
                         self.dtype, packed, padding=self.padding,
                         gamma=self.gamma.detach().reshape(-1),
                         beta=self.beta.detach().reshape(-1), **kw)

    def _forward_d2s_transpose(self, x):
        """depth_to_space(conv(x, W, pad 1) + bias, 2), then the affine, as
        one transposed conv: the 6x6 kernel's tap (u, v) holds W's tap
        (p_u, p_v) of output parity (i_u, i_v), i = (u + 1) % 2 and
        p = (u - 1 + i) // 2 (JAX ``_conv_d2s_transpose``); conv_transpose2d
        at stride 2 and padding 2 takes it flipped."""
        dt = self.dtype
        k = self.kernel()
        c, cin = k.shape[0] // 4, k.shape[1]
        u = torch.arange(6, device=k.device)
        i = (u + 1) % 2
        p = (u - 1 + i) // 2
        kr = k.reshape(2, 2, c, cin, 3, 3)
        k6 = kr[i[:, None], i[None, :], :, :, p[:, None], p[None, :]]
        w = k6.permute(3, 2, 0, 1).flip(2, 3)            # (cin, c, 6, 6)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), w.to(dt),
                               None, 2, 2).permute(0, 2, 3, 1)
        n, h2, w2, _ = y.shape

        def par(t):
            return t.to(dt).reshape(2, 2, c)[None, None, :, None, :, :]
        y = y.reshape(n, h2 // 2, 2, w2 // 2, 2, c)
        y = par(self.gamma) * (y + par(self.conv.bias)) + par(self.beta)
        return y.reshape(n, h2, w2, c)

    def folded(self):
        """(W', b'): W' = gamma * W in the compute dtype, b' = gamma * bias
        + beta in f32 (the epilogue sums in f32), both computed in f32;
        kept while the parameters and the compute dtype are unchanged
        (:func:`prepared`)."""
        def build():
            gamma = self.gamma.float().reshape(-1)
            w = self.kernel().float() * gamma[:, None, None, None]
            b = gamma * self.conv.bias.float() + self.beta.float().reshape(-1)
            return w.to(self.dtype), b
        return prepared(self, "fold", self.weight_params(), build,
                        self.dtype)

    def _forward_folded(self, x, aux, residual, act_out=None):
        """conv(x, W') without bias, then b' and the residual added in one
        pass of the conv epilogue kernel, in place (the plain version on
        the CPU), or with ``act_out`` the ELU of that stored into act_out,
        which is returned.  The residual has the output's shape and the
        compute dtype, as a residual block's input has."""
        dt = self.dtype
        w, b = self.folded()
        if aux is not None:
            x = torch.cat([x.to(dt), aux.to(dt)], dim=-1)
        y = conv2d_nhwc(x.to(dt), w, None, self.stride,
                        self.padding).contiguous()
        if act_out is not None:
            return conv_epilogue_act(y, act_out, b, residual)
        return conv_epilogue(y, b, residual)

    def forward(self, x: torch.Tensor, aux: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                act_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: NHWC.  aux: optional second input whose channels follow x's
        in the kernel's fan-in (the JAX package's split-kernel form).
        residual: optional tensor added to the output (a residual block's
        input).  act_out: where the folded route stores ELU of the output
        (returned); any other route raises."""
        dt = self.dtype
        route = self.route(x)
        if act_out is not None and route != "folded":
            raise ValueError("act_out is served by the folded route only "
                             "(autograd off, a CUDA input, bf16 or f16, "
                             "neither int8 nor d2s_transpose)")
        if route == "folded":
            return self._forward_folded(x, aux, residual, act_out)
        if route == "d2s_transpose":
            if aux is not None:
                raise ValueError("d2s_transpose takes no aux input")
            y = self._forward_d2s_transpose(x)
        elif route == "int8":
            y = self._forward_int8(x, aux)
        else:
            if aux is not None:
                x = torch.cat([x.to(dt), aux.to(dt)], dim=-1)
            y = conv2d_nhwc(x.to(dt), self.kernel().to(dt),
                            self.conv.bias.to(dt), self.stride, self.padding)
            y = (self.gamma.to(dt).reshape(-1) * y
                 + self.beta.to(dt).reshape(-1))
        return y if residual is None else residual + y


@contextlib.contextmanager
def quant_calibration(module: nn.Module):
    """Within the block, every ``int8_static`` NormConv2d of ``module``
    quantizes each call with the call's own max|x| + 1e-12 and folds it
    into its stored running max (JAX ``_act_scale`` with the ``quant``
    collection mutable)."""
    convs = [m for m in module.modules()
             if isinstance(m, NormConv2d) and m.quant == "int8_static"]
    for m in convs:
        m.calibrating = True
    try:
        yield
    finally:
        for m in convs:
            m.calibrating = False


def quant_scales(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The stored int8 activation scales of ``module``'s NormConv2d, keyed
    ``<module name>.ax`` and ``<module name>.ax_aux``."""
    return {f"{name}.{k}": v for name, m in module.named_modules()
            if isinstance(m, NormConv2d) for k, v in m.act_amax.items()}


def load_quant_scales(module: nn.Module,
                      scales: Dict[str, torch.Tensor]) -> None:
    """Replace every stored scale of ``module`` by ``scales`` (keys as
    :func:`quant_scales` gives them; ``{}`` clears them)."""
    convs = {name: m for name, m in module.named_modules()
             if isinstance(m, NormConv2d)}
    for m in convs.values():
        m.act_amax = {}
    for key, v in scales.items():
        name, k = key.rsplit(".", 1)
        m = convs.get(name)
        if m is None or m.quant != "int8_static" or k not in ("ax",
                                                             "ax_aux"):
            raise KeyError(f"{key!r} names no int8_static scale of the "
                           "module")
        m.act_amax[k] = torch.as_tensor(v, dtype=torch.float32,
                                        device=m.conv.weight_v.device)


class L2NormConv2d(nn.Module):
    """Conv whose kernel is L2-normalized per output channel, with learned
    per-channel scale and shift (JAX ``ops/nn.py:285-321``):
    W = w / sqrt(sum(w^2) + 1e-12) over (cin, kh, kw), then
    y = gamma * (conv(x, W) + bias) + beta in the compute dtype.

    State dict: ``weight`` (OIHW), ``bias`` (with ``use_bias``), ``gamma``
    and ``beta`` (1, C, 1, 1) -- the reference's own names for this layer
    are not available, so these follow its style (flax ``w``, ``bias``,
    ``gamma``, ``beta``; ``models/convert.py``).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        k = kernel_size
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, k, k, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, 1,
                                             device=device))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, 1,
                                             device=device))

    def kernel(self) -> torch.Tensor:
        w = self.weight
        return w / torch.sqrt(torch.sum(w * w, dim=(1, 2, 3), keepdim=True)
                              + 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        y = conv2d_nhwc(x.to(dt), self.kernel().to(dt), bias, self.stride,
                        self.padding)
        return (self.gamma.to(dt).reshape(-1) * y
                + self.beta.to(dt).reshape(-1))


class LayerNormConv2d(nn.Module):
    """A conv with bias, then a per-sample, per-channel normalization over
    H and W without affine, eps 1e-5 (JAX ``ops/nn.py:358-380``).  State
    dict: ``conv.weight`` (OIHW) and ``conv.bias``, the flax ``Conv_0``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride,
                              padding, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, conv = self.dtype, self.conv
        y = conv2d_nhwc(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        conv.stride[0], conv.padding[0])
        mean = y.mean(dim=(1, 2), keepdim=True)
        var = y.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (y - mean) * torch.rsqrt(var + 1e-5)


CONV_LAYERS = {"l1": NormConv2d, "l2": L2NormConv2d, "ln": LayerNormConv2d}


class NormDense(nn.Module):
    """Weight-normalized linear with per-feature gamma/beta, stored as the
    reference's 1x1 NormConv2d over (B, C, 1, 1)."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = _WeightNormParams(in_features, features, 1, device)
        self.gamma = nn.Parameter(torch.ones(1, features, 1, 1,
                                             device=device))
        self.beta = nn.Parameter(torch.zeros(1, features, 1, 1,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        v = self.conv.weight_v[:, :, 0, 0]                    # (out, in)
        v_norm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True) + 1e-12)
        w = v * (self.conv.weight_g.reshape(-1, 1) / v_norm)
        y = F.linear(x.to(dt), w.to(dt), self.conv.bias.to(dt))
        return (self.gamma.to(dt).reshape(-1) * y
                + self.beta.to(dt).reshape(-1))


class Downsample(nn.Module):
    """Stride-2 3x3 conv of ``conv_layer`` (a :data:`CONV_LAYERS` class, or
    a partial of one)."""

    def __init__(self, in_channels: int, features: int,
                 conv_layer=NormConv2d, dtype=torch.float32, device=None):
        super().__init__()
        self.down = conv_layer(in_channels, features, 3, stride=2,
                               padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.down(x)


class Upsample(nn.Module):
    """2x upsample: subpixel (a 3x3 conv to 4*features, then
    depth_to_space) or, with ``subpixel=False``, a 3x3 conv to ``features``
    and a bilinear resize with half-pixel centres, whose edge rows repeat
    the border (``jax.image.resize(..., "bilinear")`` at 2x), in the
    activation's dtype.  ``transpose`` computes the subpixel form as one
    transposed conv (``NormConv2d(d2s_transpose=True)``, the same
    parameters); the conv is ``conv_layer``'s."""

    def __init__(self, in_channels: int, features: int,
                 subpixel: bool = True, transpose: bool = False,
                 conv_layer=NormConv2d, dtype=torch.float32, device=None):
        super().__init__()
        self.subpixel = subpixel
        self.transpose = transpose and subpixel
        kw = dict(d2s_transpose=True) if self.transpose else {}
        self.up = conv_layer(in_channels,
                             (4 if subpixel else 1) * features, 3, padding=1,
                             dtype=dtype, device=device, **kw)

    def forward(self, x):
        y = self.up(x)
        if self.transpose:
            return y
        if self.subpixel:
            return depth_to_space(y, 2)
        y = F.interpolate(y.permute(0, 3, 1, 2), scale_factor=2,
                          mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


DROPOUT_IMPLS = ("flax", "pallas", "pallas_sharded")
RNB_IMPLS = ("cudnn", "fused")


def check_dropout_impl(impl: str) -> None:
    """Raise for a ``training.dropout_impl`` this package does not run."""
    if impl in ("packed", "bits"):
        raise NotImplementedError(
            f"dropout_impl {impl!r} is not ported (TPU-only mask "
            "representations, ROADMAP)")
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"unknown dropout_impl {impl!r}; expected one of "
                         f"{DROPOUT_IMPLS}")


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, survivors
    scaled by 1 / (1 - rate); the mask comes from ``generator``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = batch_draws.bernoulli(x, 1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def checkpoint_with_generators(fn, generators, *args, **kwargs):
    """``torch.utils.checkpoint`` (non-reentrant) of fn(*args, **kwargs)
    whose recomputation draws what its forward drew.  torch restores only
    the default generators' states for a recomputation, and every mask
    and noise here comes from an explicit ``torch.Generator`` (the
    ELU+dropout kernel's seed words are drawn from one too): so each of
    ``generators`` is set back to its state at the call for the
    recomputation, and to its state before it afterwards."""
    gens = [g for g in generators if g is not None]
    at_call = [g.get_state() for g in gens]
    calls = []

    def run(*a, **kw):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a, **kw)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, at_call):
            g.set_state(state)
        try:
            return fn(*a, **kw)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)
    return torch.utils.checkpoint.checkpoint(run, *args,
                                             use_reentrant=False, **kwargs)


class VunetRNB(nn.Module):
    """Pre-activation residual block:
    out = x + conv(dropout(elu([x] or [x, nin(elu(a))]))).

    A residual block (``residual=True``) takes an auxiliary input of
    ``aux_channels`` channels through the 1x1 ``nin`` conv; its main conv
    then sees 2*channels.  Dropout runs only with ``train=True`` and
    ``dropout_prob > 0``: ``dropout_impl="flax"`` is ELU then
    :func:`dropout`; ``"pallas"`` and ``"pallas_sharded"`` are the fused
    ELU+dropout kernel (``ops/cuda/elu_dropout.py``) at each branch.  The
    masks come from the ``generator`` passed to :meth:`forward`.  Under
    data parallelism (``ops/batch_draws.py:batch_rows``) each rank's masks
    are its rows of the masks of the global batch: :func:`dropout` draws
    them at the global shape, and the kernel starts at the rank's element
    offset.  JAX's ``pallas_sharded`` takes its XLA composition so that
    GSPMD can partition the step; here one process holds one shard, so
    ``"pallas"`` and ``"pallas_sharded"`` are one route.

    The convs are ``conv_layer``'s (a :data:`CONV_LAYERS` class or a
    partial of one, JAX ``:565-672``).  A NormConv2d takes the aux branch
    as its split-kernel second input; any other conv layer takes the two
    branches concatenated.

    ``act_fn`` replaces the ELU (JAX's ``act_fn``; ``MIDiscConv`` passes
    a LeakyReLU): such a block takes neither the ELU+dropout kernel nor
    the fused RNB kernel, both of which compute the ELU.

    ``rnb_impl="fused"`` runs a block without auxiliary input (activate,
    3x3 conv, not training) as one fused RNB kernel
    (``ops/cuda/fused_rnb.py``), unless its conv runs int8 at the input's
    height (``NormConv2d.route``, a rule on the settings and the static
    shape): that block keeps the int8 conv.  Such a block's conv is a 3x3,
    stride-1, SAME conv from C to C channels by construction, the shape
    the kernel takes.  The kernel's operands are the block's own
    (:meth:`fused_operands`), folded from a NormConv2d's weights, so
    ``"fused"`` with another conv layer raises a ValueError.  Every other
    block, and every block under the default ``"cudnn"``, runs the conv
    and eager elementwise ops; a NormConv2d conv takes the block's input
    as its ``residual``, which its folded route adds in the conv epilogue
    kernel.  A residual block with auxiliary input whose convs take the
    folded route (not training, the ELU, NormConv2d convs, x in the
    compute dtype, ``route`` "folded" for both convs) builds its 2C conv
    input without concatenating (:meth:`_forward_concat_free`): the
    epilogue's activated store writes ELU(x) into the lower half and
    ELU(nin(ELU(a))) into the upper half.

    With ``remat`` set (an attribute, not a parameter: the state dict is
    the same either way) a training forward under autograd stores only the
    block's inputs and recomputes the block in the backward pass
    (:func:`checkpoint_with_generators`).
    """

    def __init__(self, channels: int, residual: bool = False,
                 aux_channels: Optional[int] = None, kernel_size: int = 3,
                 activate: bool = True, dropout_prob: float = 0.0,
                 dropout_impl: str = "flax", rnb_impl: str = "cudnn",
                 conv_layer=NormConv2d, act_fn=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        check_dropout_impl(dropout_impl)
        if rnb_impl not in RNB_IMPLS:
            raise ValueError(f"unknown rnb_impl {rnb_impl!r}; expected one "
                             f"of {RNB_IMPLS}")
        self.residual, self.activate = residual, activate
        self.act_fn = act_fn
        self.dropout_prob, self.dropout_impl = dropout_prob, dropout_impl
        if residual:
            self.nin = conv_layer(aux_channels or channels, channels, 1,
                                  dtype=dtype, device=device)
        self.conv = conv_layer((2 if residual else 1) * channels, channels,
                               kernel_size, padding=kernel_size // 2,
                               dtype=dtype, device=device)
        if rnb_impl == "fused" and not isinstance(self.conv, NormConv2d):
            raise ValueError("rnb_impl 'fused' needs the l1 conv layer "
                             "(NormConv2d), whose weights its kernel reads")
        # the blocks the fused kernel computes: no auxiliary input, which
        # only a residual block takes, so a 3x3 conv from C to C channels
        self.fused = (rnb_impl == "fused" and activate and kernel_size == 3
                      and not residual and act_fn is None)
        self.remat = False

    def fused_weights(self):
        """(W, scale, shift) of the conv in f32 as the fused RNB kernel
        takes them: W (C, C, 3, 3) OIHW, scale = gamma and shift = gamma *
        bias + beta, each (C,)."""
        conv = self.conv
        scale = conv.gamma.reshape(-1).float()
        shift = scale * conv.conv.bias.float() + conv.beta.reshape(-1).float()
        return conv.kernel().float(), scale, shift

    def fused_operands(self):
        """(W packed, affine) of the conv for the fused RNB kernel
        (``fused_rnb.pack_weights``, ``pack_affine``), kept while the
        conv's parameters are unchanged (:func:`prepared`)."""
        def build():
            w, scale, shift = self.fused_weights()
            return fused_rnb.pack_weights(w), fused_rnb.pack_affine(scale,
                                                                    shift)
        return prepared(self, "fused_rnb", self.conv.weight_params(), build)

    def _forward_fused(self, x):
        """The block at x (no auxiliary input, not training) as the fused
        RNB kernel computes it: one launch on a CUDA tensor, on
        :meth:`fused_operands`; the plain version on a CPU tensor, in x's
        dtype.  The kernel has no backward, so a call that autograd would
        need to differentiate raises."""
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in self.conv.parameters())):
            raise RuntimeError("the fused RNB kernel has no backward; call "
                               "it under torch.no_grad() or "
                               "inference_mode()")
        if x.device.type == "cpu":
            return fused_rnb.fused_rnb_plain(x, *self.fused_weights())
        if x.shape[-1] != self.conv.features:
            raise ValueError(f"the block's 3x3 conv takes "
                             f"{self.conv.features} channels, x has "
                             f"{x.shape[-1]}")
        return fused_rnb.fused_rnb_prepared(x, self.fused_operands())

    def _act(self, v):
        if not self.activate:
            return v
        return F.elu(v) if self.act_fn is None else self.act_fn(v)

    def _act_dropout(self, train: bool, generator):
        """The activation of a conv input, with dropout when training."""
        if not train or self.dropout_prob <= 0.0:
            return self._act
        if (self.dropout_impl != "flax" and self.activate
                and self.act_fn is None):
            return lambda v: elu_dropout(
                v, self.dropout_prob, generator,
                offset=batch_draws.element_offset(v.numel()))
        return lambda v: dropout(self._act(v), self.dropout_prob, generator)

    def forward(self, x: torch.Tensor, a: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if (self.fused and a is None and not train
                and self.conv.route(x) != "int8"):
            return self._forward_fused(x.to(self.conv.dtype))
        if self.remat and train and torch.is_grad_enabled():
            return checkpoint_with_generators(self._forward, (generator,),
                                              x, a, train, generator)
        return self._forward(x, a, train, generator)

    def _concat_free(self, x, a, train) -> bool:
        """Whether a call with auxiliary input takes
        :meth:`_forward_concat_free`: every condition is one the call can
        see, so training, the CPU, f32, other conv layers, other activations
        and int8 blocks (whose kernel takes aux as a split fan-in) keep the
        concatenating code."""
        return (not train and self.activate and self.act_fn is None
                and isinstance(self.conv, NormConv2d)
                and x.dtype == self.conv.dtype
                and self.conv.route(x) == "folded"
                and self.nin.route(a) == "folded")

    def _forward_concat_free(self, x, a):
        """x + conv([elu(x), elu(nin(elu(a)))]) with the conv's input
        written in place of concatenating it: the conv epilogue's activated
        store puts elu(x) into its lower half and the nin conv's epilogue
        elu(nin(elu(a))) into its upper half; the conv's epilogue then adds
        b' and x.  Bit-equal to the concatenating folded route."""
        x = x.contiguous()
        C = x.shape[-1]
        buf = x.new_empty(*x.shape[:-1], 2 * C)
        conv_epilogue_act(x, buf[..., :C])
        self.nin(self._act(a), act_out=buf[..., C:])
        return self.conv(buf, residual=x)

    def _forward(self, x, a, train, generator):
        act = self._act_dropout(train, generator)
        if a is not None:
            if not self.residual:
                raise ValueError("auxiliary input to a non-residual VunetRNB")
            if self._concat_free(x, a, train):
                return self._forward_concat_free(x, a)
            a = self.nin(self._act(a))
            if isinstance(self.conv, NormConv2d):
                return self.conv(act(x), aux=act(a), residual=x)
            return x + self.conv(torch.cat([act(x), act(a)], dim=-1))
        if isinstance(self.conv, NormConv2d):
            return self.conv(act(x), residual=x)
        return x + self.conv(act(x))


class FullyConnectedNet(nn.Module):
    """LeakyReLU MLP dim -> hidden x (depth+1) -> out_dim, optional tanh;
    ``main`` holds the reference's Sequential (Linear at even indices)."""

    def __init__(self, dim: int, depth: int, hidden_dim: int = 256,
                 use_tanh: bool = False, out_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        layers = [nn.Linear(dim, hidden_dim, device=device), nn.LeakyReLU()]
        for _ in range(depth):
            layers += [nn.Linear(hidden_dim, hidden_dim, device=device),
                       nn.LeakyReLU()]
        layers.append(nn.Linear(hidden_dim, dim if out_dim is None
                                else out_dim, device=device))
        if use_tanh:
            layers.append(nn.Tanh())
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        h = x.to(self.dtype)
        for layer in self.main:
            if isinstance(layer, nn.Linear):
                h = F.linear(h, layer.weight.to(self.dtype),
                             layer.bias.to(self.dtype))
            else:
                h = layer(h)
        return h


class BasicUnConnectedNet(nn.Module):
    """Per-dimension MLP (JAX ``ops/nn.py:702``): every input scalar runs
    through the same 1-in / ``factor``-out LeakyReLU net, as a batched
    matmul over B * dim rows.  The output is factor-major,
    ``out[b, f * dim + d]`` (the reference's (B, factor, dim) reshape).
    ``main`` holds the Linear layers at even indices, as in
    :class:`FullyConnectedNet`."""

    def __init__(self, dim: int, depth: int, hidden_dim: int = 256,
                 use_tanh: bool = False, out_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        out_dim = dim if out_dim is None else out_dim
        if out_dim % dim:
            raise ValueError(f"out_dim {out_dim} is not a multiple of dim "
                             f"{dim}")
        self.dim, self.out_dim = dim, out_dim
        self.net = FullyConnectedNet(1, depth, hidden_dim, use_tanh=use_tanh,
                                     out_dim=out_dim // dim, dtype=dtype,
                                     device=device)

    def forward(self, x):
        h = self.net(x[..., None])                     # (B, dim, factor)
        return h.transpose(1, 2).reshape(x.shape[0], self.out_dim)


def feature_layer_width(scale: int, width_multiplier: float = 1) -> int:
    """A :class:`FeatureLayer`'s output channels, wm * 64 * min(2**scale,
    16)."""
    return int(width_multiplier * 64 * min(2 ** scale, 16))


class FeatureLayer(nn.Module):
    """One encoder scale (JAX ``ops/nn.py:741``): a 4x4 stride-2 conv
    without bias, a per-channel affine ``scale * (h + loc)``, then
    LeakyReLU(0.2); NHWC in and out.  ``in_channels`` defaults to the
    previous scale's width.  loc and scale come from data: a new layer
    calls :meth:`initialize_` on its first batch, as JAX's init does.
    State dict: ``conv.weight`` (OIHW), ``loc`` and ``scale`` (C,)."""

    def __init__(self, scale: int, in_channels: Optional[int] = None,
                 width_multiplier: float = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        if in_channels is None:
            if scale == 0:
                raise ValueError("FeatureLayer(0) needs in_channels")
            in_channels = feature_layer_width(scale - 1, width_multiplier)
        out = feature_layer_width(scale, width_multiplier)
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out, 4, stride=2, padding=1,
                              bias=False, device=device)
        self.loc = nn.Parameter(torch.zeros(out, device=device))
        self.scale = nn.Parameter(torch.ones(out, device=device))

    def _conv(self, x):
        dt = self.dtype
        return conv2d_nhwc(x.to(dt), self.conv.weight.to(dt), None, 2, 1)

    def forward(self, x):
        dt = self.dtype
        h = self.scale.to(dt) * (self._conv(x) + self.loc.to(dt))
        return F.leaky_relu(h, 0.2)

    @torch.no_grad()
    def initialize_(self, x):
        """loc = -mean, scale = 1 / (std(ddof=1) + 1e-6) of the conv's
        output on x, per channel over (B, H, W)."""
        h = self._conv(x).float()
        self.loc.copy_(-h.mean(dim=(0, 1, 2)))
        self.scale.copy_(1.0 / (h.std(dim=(0, 1, 2), unbiased=True) + 1e-6))


class DenseEncoderLayer(nn.Module):
    """Bottleneck-to-vector head (JAX ``ops/nn.py:772``): the reference's
    conv over the whole spatial extent, as flatten + Linear.  The input
    is NHWC and flattens (H, W, C) row-major, as the flax module's does,
    so the converted Dense kernel applies as it is (``dense.weight``,
    (out, H * W * C))."""

    def __init__(self, in_features: int, out_size: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(in_features, out_size, device=device)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.reshape(x.shape[0], -1).to(dt),
                        self.dense.weight.to(dt), self.dense.bias.to(dt))
