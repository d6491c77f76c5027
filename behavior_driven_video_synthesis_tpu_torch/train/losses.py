"""Loss functions of the VUNet and behavior experiments.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/losses.py:22-100``:
``kl_loss`` (diagonal Gaussian to N(0, 1)), ``latent_kl`` and
``compute_kl_loss`` (the original VUNet's KL between per-scale means),
``compute_kl_with_prior`` (cvbae), ``vgg_loss`` (weighted L1 over a
feature pyramid), the behavior step's ``mse_loss``,
``recon_loss_per_seq``, ``cross_entropy`` and ``accuracy``, the MT-VAE
step's ``l1_loss``, and the GAN branch's ``bce_logits``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def kl_loss(mu, logstd):
    """KL(N(mu, exp(logstd)) || N(0, 1)) summed over the last axis,
    averaged over the rest."""
    dim = mu.shape[-1]
    std = torch.exp(logstd)
    kl = torch.sum(-logstd + 0.5 * (std ** 2 + mu ** 2), dim=-1) - 0.5 * dim
    return torch.mean(kl)


def latent_kl(prior_mean, posterior_mean):
    """0.5 * ||mu_p - mu_q||^2 summed over all but the batch axis, then
    batch-meaned."""
    kl = 0.5 * (prior_mean - posterior_mean) ** 2
    return torch.mean(torch.sum(kl, dim=tuple(range(1, kl.dim()))))


def compute_kl_loss(prior_means: Sequence, posterior_means: Sequence):
    """Sum of the per-scale latent KLs (original-VUNet objective)."""
    return sum(latent_kl(p, q) for p, q in zip(prior_means, posterior_means))


def compute_kl_with_prior(means: Sequence, logstds: Sequence):
    """Mean over scales of kl_loss on the flattened latent maps (cvbae),
    in the maps' own dtype, as the JAX step computes it (bf16 for a bf16
    VUNet)."""
    per_scale = [kl_loss(m.reshape(m.shape[0], -1),
                         s.reshape(s.shape[0], -1))
                 for m, s in zip(means, logstds)]
    return torch.mean(torch.stack(per_scale))


def vgg_loss(feats_target: Dict[str, torch.Tensor],
             feats_pred: Dict[str, torch.Tensor],
             loss_weights: Sequence[float]) -> Dict[str, torch.Tensor]:
    """Weighted L1 between feature pyramids, one term per level (the raw
    input included)."""
    return {name: w * torch.mean(torch.abs(feats_target[name]
                                           - feats_pred[name]))
            for w, name in zip(loss_weights, feats_target)}


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def recon_loss_per_seq(pred, target):
    """Per-sequence MSE (B,)."""
    return torch.mean((pred - target) ** 2, dim=tuple(range(1, pred.dim())))


def bce_logits(pred, target):
    """Mean binary cross-entropy of logits ``pred`` against ``target``, in
    the logits' dtype, in the JAX package's stable form."""
    return torch.mean(torch.clamp(pred, min=0) - pred * target
                      + torch.log1p(torch.exp(-torch.abs(pred))))


def cross_entropy(logits, labels):
    """Mean negative log-likelihood of int labels (B,) under softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
