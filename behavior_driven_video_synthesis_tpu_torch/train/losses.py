"""Loss functions of the VUNet and behavior experiments.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/losses.py``:
``kl_loss`` (diagonal Gaussian to N(0, 1)), ``latent_kl`` and
``compute_kl_loss`` (the original VUNet's KL between per-scale means),
``compute_kl_with_prior`` (cvbae), ``vgg_loss`` (weighted L1 over a
feature pyramid), the behavior step's ``mse_loss``,
``recon_loss_per_seq``, ``cross_entropy`` and ``accuracy``, the MT-VAE
step's ``l1_loss``, and the GAN branch's ``bce_logits``; and the rest of
the reference's loss library, which no config reaches: ``gan_loss``,
``hinge_d_loss``, ``triplet_loss``, ``feature_matching_loss`` (the
sequence discriminator's), ``weight_decay_loss``, ``mi_loss_terms`` (the
MI discriminator's) and ``zoom_loss``.  Each runs on the device its
inputs lie on.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


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


def gan_loss(pred, target, loss_type: str = "mse"):
    """"mse" (LSGAN) or "vanilla" (BCE with logits)."""
    if loss_type == "mse":
        return torch.mean((pred - target) ** 2)
    if loss_type == "vanilla":
        return bce_logits(pred, target)
    raise ValueError(loss_type)


def hinge_d_loss(pred, mode: str):
    """Hinge loss of a discriminator on "real" or "fake" logits, or of the
    generator ("gen")."""
    if mode == "real":
        return torch.mean(F.relu(1.0 - pred))
    if mode == "fake":
        return torch.mean(F.relu(1.0 + pred))
    if mode == "gen":
        return -torch.mean(pred)
    raise ValueError(mode)


def triplet_loss(anchor, positive, negative, margin: float = 0.2):
    """Mean of relu(|a - p|^2 - |a - n|^2 + margin), squared L2 over dim
    1."""
    dp = torch.sum((anchor - positive) ** 2, dim=1)
    dn = torch.sum((anchor - negative) ** 2, dim=1)
    return torch.mean(F.relu(dp - dn + margin))


def feature_matching_loss(feats_real: Sequence, feats_fake: Sequence):
    """Mean over levels of each level's mean L1 (the reference's sequence
    discriminator divides the summed level means by the level count)."""
    if len(feats_real) != len(feats_fake):
        raise ValueError(
            f"feature list length mismatch: {len(feats_real)} real vs "
            f"{len(feats_fake)} fake")
    if not feats_real:
        return torch.zeros(())
    return sum(torch.mean(torch.abs(fr - ff))
               for fr, ff in zip(feats_real, feats_fake)) / len(feats_real)


def weight_decay_loss(params: Union[nn.Module, Mapping[str, torch.Tensor],
                                    Iterable[torch.Tensor]]):
    """Sum of squared L2 norms over a module's parameters, a state dict's
    tensors or an iterable of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(torch.sum(w * w) for w in params)


def mi_loss_terms(disc: Callable[[torch.Tensor], torch.Tensor], joint,
                  marginal, seq_len: int = 1):
    """The MI discriminator's terms as (disc_loss, gen_loss): ``disc`` (a
    module or any callable to logits) is trained with BCE toward joint -> 1,
    scaled by 1 / seq_len, and marginal -> 0; the generator's loss is the
    negated unscaled sum."""
    t_joint = disc(joint).reshape(-1)
    t_marg = disc(marginal).reshape(-1)
    bce_joint = bce_logits(t_joint, torch.ones_like(t_joint))
    bce_marg = bce_logits(t_marg, torch.zeros_like(t_marg))
    return bce_joint / seq_len + bce_marg, -(bce_joint + bce_marg)


def zoom_loss(feats_fn, target, pred, kps, out_size: int, loss_weights):
    """:func:`vgg_loss` between ``feats_fn(target)`` and the features of
    ``pred``'s keypoint-centred crop at ``out_size`` (only ``pred`` is
    cropped); kps (B, K, 2) pixels, images (B, H, W, C)."""
    from ..utils.boxes import bounding_box_batch

    pred_crop = bounding_box_batch(kps, pred, out_size)
    return vgg_loss(feats_fn(target), feats_fn(pred_crop), loss_weights)
