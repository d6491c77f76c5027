"""Image-synthesis discriminators and the GAN losses of the cvbae step.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/
synth_discriminators.py``: the PatchGAN (``PatchGANDiscriminator``, with
the JAX package's instance norm), the part-crop discriminator over
``VunetRNB`` stacks (``PartDiscriminator``, which no experiment builds, as
in the JAX package) and the losses as plain functions on tensors: the BCE
discriminator loss with the optional R1 penalty on the real images
(``disc_loss_with_r1``), the generator's BCE against "real"
(``generator_gan_loss``) and the gradient-based loss weight
(``adaptive_gan_weight``).

Images are NHWC.  Parameters are float32; ``dtype`` is the compute dtype,
as in the JAX modules: the input, the weights and the biases are cast to it
before each conv.  The instance norm takes its mean and (population)
variance in float32 and casts them to the activation's dtype, as ``jnp.mean``
and ``jnp.var`` of a bf16 tensor do.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import Downsample, NormConv2d, VunetRNB, conv2d_nhwc
from ..train.losses import bce_logits


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over each image's H and W (NHWC), no
    affine; the statistics accumulate in float32."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=(1, 2), keepdim=True)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)


class PatchGANDiscriminator(nn.Module):
    """The 70x70-receptive-field PatchGAN: ``n_layers`` stride-2 4x4 convs
    (ndf, 2 ndf, ... up to 8 ndf; instance norm after all but the first),
    a stride-1 4x4 conv and instance norm, then a stride-1 4x4 conv to one
    logit a patch, every conv padded by 1, leaky ReLU(0.2) between.  At 256
    px the maps are 128, 64, 32, 31 and 30 px wide.  ``convs.{i}`` is the
    flax module's ``Conv_{i}``."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 n_layers: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        widths = [ndf] + [ndf * min(2 ** n, 8) for n in range(1, n_layers)]
        widths += [ndf * min(2 ** n_layers, 8), 1]
        self.strides = [2] * n_layers + [1, 1]
        convs, cin = [], in_channels
        for cout in widths:
            convs.append(nn.Conv2d(cin, cout, 4, device=device))
            cin = cout
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.to(dt)
        last = len(self.convs) - 1
        for i, (conv, stride) in enumerate(zip(self.convs, self.strides)):
            h = conv2d_nhwc(h, conv.weight.to(dt), conv.bias.to(dt), stride,
                            1)
            if i == last:
                return h
            if i > 0:
                h = instance_norm(h)
            h = F.leaky_relu(h, 0.2)


class PartDiscriminator(nn.Module):
    """A real/fake logit of body-part crops (``in_size`` px, ``nf_in``
    channels): a valid 3x3 NormConv2d to 16 channels, then ``n_scales``
    times a VunetRNB and a stride-2 Downsample doubling the width up to
    ``max_filters``, then a dense layer over the flattened NHWC map.  The
    RNBs take ``dropout_impl``'s route when training with dropout."""

    def __init__(self, n_scales: int, in_size: int, nf_in: int = 3,
                 max_filters: int = 256, dropout_prob: float = 0.0,
                 dropout_impl: str = "flax", dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.conv_in = NormConv2d(nf_in, 16, 3, **kw)
        size, nf = in_size - 2, 16
        blocks, downs = [], []
        for _ in range(n_scales):
            blocks.append(VunetRNB(nf, dropout_prob=dropout_prob,
                                   dropout_impl=dropout_impl, **kw))
            nf_next = min(2 * nf, max_filters)
            downs.append(Downsample(nf, nf_next, **kw))
            nf, size = nf_next, (size - 1) // 2 + 1
        self.blocks, self.downs = nn.ModuleList(blocks), nn.ModuleList(downs)
        self.dense = nn.Linear(size * size * nf, 1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        h = self.conv_in(x)
        for block, down in zip(self.blocks, self.downs):
            h = down(block(h, None, train, generator))
        h = h.reshape(h.shape[0], -1)
        dt = self.dtype
        return F.linear(h.to(dt), self.dense.weight.to(dt),
                        self.dense.bias.to(dt))


# -- the GAN losses ----------------------------------------------------------

def disc_loss_with_r1(disc: nn.Module, real_x: torch.Tensor,
                      fake_x: torch.Tensor, lambda_gp: float = 10.0,
                      use_gp: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE of the discriminator's logits: real against 1, the detached fake
    against 0; with ``use_gp`` plus the R1 penalty, ``lambda_gp`` times the
    batch mean of the squared gradient norm of sum(D(real)) with respect to
    the real images, kept in the graph (``create_graph``) so that it
    reaches the parameters' gradients.  Returns (loss, {"dloss_r",
    "dloss_f", ["gp"], "dloss"})."""
    if use_gp:
        real_x = real_x.detach().requires_grad_(True)
    d_real = disc(real_x)
    d_fake = disc(fake_x.detach())
    real_loss = bce_logits(d_real, torch.ones_like(d_real))
    fake_loss = bce_logits(d_fake, torch.zeros_like(d_fake))
    loss = real_loss + fake_loss
    out = {"dloss_r": real_loss, "dloss_f": fake_loss}
    if use_gp:
        grads, = torch.autograd.grad(torch.sum(d_real), real_x,
                                     create_graph=True)
        reg = lambda_gp * torch.mean(torch.sum(
            grads.reshape(grads.shape[0], -1) ** 2, dim=1))
        loss = loss + reg
        out["gp"] = reg
    out["dloss"] = loss
    return loss, out


def generator_gan_loss(disc: nn.Module, fake_x: torch.Tensor
                       ) -> torch.Tensor:
    """BCE of D(fake) against 1, with the gradient reaching the fake
    alone: the discriminator's parameters stop requiring gradients for the
    forward, so no gradient of theirs is taken or accumulated."""
    flags = [p.requires_grad for p in disc.parameters()]
    disc.requires_grad_(False)
    try:
        d_fake = disc(fake_x)
    finally:
        for p, flag in zip(disc.parameters(), flags):
            p.requires_grad_(flag)
    return bce_logits(d_fake, torch.ones_like(d_fake))


def adaptive_gan_weight(grad_normal: torch.Tensor, grad_gan: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """|mean(grad_normal) / (mean(grad_gan) + eps)|, without gradient: the
    reference's gradient-based weight of the GAN loss."""
    return torch.abs(torch.mean(grad_normal)
                     / (torch.mean(grad_gan) + eps)).detach()
