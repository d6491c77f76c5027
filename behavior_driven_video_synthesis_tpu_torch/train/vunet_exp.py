"""The VUNet training steps: cvbae and the original VUNet.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/vunet_exp.py:
74-302`` (``_accum_grads``, ``make_cvbae_train_step``,
``make_org_vunet_train_step``).  One cvbae step:

  loss = ll_weight * sum(vgg_loss levels)
         + gamma * compute_kl_with_prior     [from step n_init_batches on;
                                              gamma = 1 for ``cvae``]
  one Adam update of the VUNet from the gradients averaged over
  ``grad_accum`` sequential microbatches;
  R Adam updates of the regressor, each predicting the keypoints of
  ``reg_imgs[:, i]`` from the VUNet's posterior means taken without
  gradient (with the VUNet's parameters from before its update);
  the logged loss minus clip(loss_reg, max=1.2) * weight_regressor, a term
  without gradient, as in the JAX step;
  the gamma controller after the step;
  with a discriminator (``gan``, a ``train/gan.py:GANState``) the VUNet's
  loss also takes gan_weight * BCE(D(out), 1) through the discriminator
  as it was before the step, and the discriminator then takes one Adam
  step on the targets and the detached outputs of the whole batch (the
  microbatches' outputs joined), its loss terms (``dloss``, ``dloss_r``,
  ``dloss_f``, with ``grad_pen`` ``gp``) and ``gen_gan_loss`` joining the
  metrics.

One original-VUNet step: loss = ll_weight * sum(vgg_loss levels)
+ kl_ramp(step) * compute_kl_loss(prior means, posterior means), one Adam
update from ``grad_accum`` microbatches as above.

Parameters and optimizer states change in place; ``VunetTrainState`` holds
the step count and gamma.  Posterior noise comes from ``eps`` (one list of
tensors per microbatch) or the ``generator``; the regressor's encodings
take ``reg_eps`` (one list per regressor image) or the same generator;
dropout masks come from ``dropout_generator``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Optional, Sequence

import torch

from ..core import schedules
from ..parallel import mesh
from .losses import compute_kl_loss, compute_kl_with_prior, vgg_loss


@dataclass
class VunetTrainState:
    step: int = 0
    gamma: torch.Tensor = field(default_factory=lambda: torch.zeros(()))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).  A
    tensor that FSDP shards (a DTensor) counts once with all its ranks'
    shards: its local shard's squares are summed over the ranks."""
    tensors = list(tensors)
    whole = [t for t in tensors if not mesh.is_dtensor(t)]
    sq = sum(torch.sum(t.float() ** 2) for t in whole)
    sharded = [t.to_local() for t in tensors if mesh.is_dtensor(t)]
    if sharded:
        part = sum(torch.sum(t.float() ** 2) for t in sharded)
        if mesh.initialized():
            torch.distributed.all_reduce(part)
        sq = sq + part
    return torch.sqrt(torch.as_tensor(sq))


def _accumulate(loss_fn, params, tensors, grad_accum: int, eps):
    """Gradients of ``loss_fn(*microbatch, eps_i)`` over ``grad_accum``
    sequential microbatches of ``tensors``, averaged into the parameters'
    ``.grad``.  Returns (mean loss, aux, the gradients): each scalar aux
    value the microbatches' mean, every other joined along the batch."""
    bsz = tensors[0].shape[0]
    if bsz % grad_accum:
        raise ValueError(f"batch {bsz} not divisible by "
                         f"grad_accum={grad_accum}")
    micro = [t.split(bsz // grad_accum) for t in tensors]
    losses, auxs = [], []
    for i in range(grad_accum):
        loss_i, aux_i = loss_fn(*(m[i] for m in micro),
                                None if eps is None else eps[i])
        loss_i.backward()
        losses.append(loss_i.detach())
        auxs.append({k: v.detach() for k, v in aux_i.items()})
    grads = [p.grad for p in params if p.grad is not None]
    if grad_accum > 1:
        for g in grads:
            g.div_(grad_accum)
    aux = {k: (torch.mean(torch.stack([a[k] for a in auxs]))
               if auxs[0][k].dim() == 0 else torch.cat([a[k] for a in auxs]))
           for k in auxs[0]}
    return torch.mean(torch.stack(losses)), aux, grads


def make_cvbae_train_step(vunet, regressor, perceptual, optimizers: dict,
                          config: dict, gan=None) -> Callable:
    """``train_step(state, batch, generator=None, dropout_generator=None,
    eps=None, reg_eps=None) -> metrics`` for a run config (a dict with
    "training" and "architecture" sections).  ``batch`` holds NHWC
    ``pose_img``, ``stickman``, optionally ``app_img`` (else the pose
    image), and ``reg_imgs`` (B, R, S, S, 3) and ``reg_targets``
    (B, R, K, 2) when the regressor trains.  ``gan``, a ``GANState``,
    turns the adversarial branch on (``training.gan_weight``,
    ``lambda_gp``, ``grad_pen``)."""
    tr = config.get("training", {})
    ll_weight = float(tr.get("ll_weight", 1.0))
    vgg_weights = list(tr.get("vgg_weights", [1.0] * 6))
    w_reg = float(tr.get("weight_regressor", 4.0))
    train_reg = bool(tr.get("train_regressor", True)) and regressor is not None
    gamma_step = float(tr.get("gamma_step", 1e-5))
    imax = float(tr.get("information_max", 1000.0))
    imax_mode = str(tr.get("imax_scaling", "none"))
    imax_total = int(tr.get("end_iteration", 150000))
    n_init_batches = int(tr.get("n_init_batches", 4))
    is_cvae = bool(config.get("architecture", {}).get("cvae", False))
    grad_accum = int(tr.get("grad_accum", 1))
    params = list(vunet.parameters())
    opt, lr_schedule = optimizers["vunet"], optimizers["vunet_lr"]
    opt_reg = optimizers.get("regressor")
    if bool(tr.get("use_gan", False)) and gan is None:
        raise ValueError("training.use_gan needs the discriminator's "
                         "GANState (train/gan.py:create_gan_state)")
    if gan is not None:
        from .gan import make_gan_update

        gan_update, gan_gen_loss = make_gan_update(
            gan, lambda_gp=float(tr.get("lambda_gp", 10.0)),
            use_gp=bool(tr.get("grad_pen", False)))
        gan_weight = float(tr.get("gan_weight", 1.0))

    def loss_fn(state, generator, dropout_generator, app, shape, target,
                eps):
        out, means, logstds, _, _ = vunet(
            app, shape, train=True, eps=eps, generator=generator,
            dropout_generator=dropout_generator)
        ll_dict = vgg_loss(perceptual(target),
                           perceptual(out.to(target.dtype)), vgg_weights)
        likelihood = ll_weight * sum(ll_dict.values())
        kl = compute_kl_with_prior(means, logstds)
        loss = likelihood
        if state.step >= n_init_batches:
            loss = loss + (1.0 if is_cvae else state.gamma) * kl
        aux = {"likelihood_loss": likelihood, "kl_loss": kl}
        if gan is not None:
            g_loss = gan_gen_loss(out.to(target.dtype))
            loss = loss + gan_weight * g_loss
            aux["gen_gan_loss"] = g_loss
            aux["out"] = out
        aux.update({f"ll_{k}": v for k, v in ll_dict.items()})
        return loss, aux

    def regressor_updates(batch, generator, reg_eps):
        reg_imgs, reg_targets = batch["reg_imgs"], batch["reg_targets"]
        loss_reg = None
        for i in range(reg_imgs.shape[1]):
            with torch.no_grad():
                means, _ = vunet.encode_means(
                    reg_imgs[:, i], None if reg_eps is None else reg_eps[i],
                    generator)
            tgt = reg_targets[:, i].reshape(reg_targets.shape[0], -1)
            opt_reg.zero_grad(set_to_none=True)
            preds = regressor(means)
            loss_reg = torch.mean(torch.sqrt(
                torch.sum((preds - tgt) ** 2, dim=1) + 1e-12))
            loss_reg.backward()
            opt_reg.step()
        return loss_reg.detach()

    def train_step(state: VunetTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   dropout_generator: Optional[torch.Generator] = None,
                   eps: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                   reg_eps: Optional[Sequence[Sequence[torch.Tensor]]] = None
                   ) -> Dict[str, torch.Tensor]:
        target = batch["pose_img"]
        tensors = (batch.get("app_img", target), batch["stickman"], target)
        opt.zero_grad(set_to_none=True)
        loss, aux, grads = _accumulate(
            partial(loss_fn, state, generator, dropout_generator), params,
            tensors, grad_accum, eps)

        loss_reg = torch.zeros((), device=target.device)
        if train_reg:
            loss_reg = regressor_updates(batch, generator, reg_eps)
            loss = loss - torch.clamp(loss_reg, max=1.2) * w_reg

        opt.step()
        # after the step: under data parallelism the ranks' mean gradient
        grad_norm = global_norm(grads)
        lr_schedule.step()
        imax_t = schedules.imax_schedule(state.step, imax_total, imax,
                                         imax_mode)
        # the KL of the global batch under data parallelism
        state.gamma = schedules.update_gamma(
            state.gamma.to(target.device), mesh.mean_over_ranks(
                aux["kl_loss"]), imax_t, gamma_step)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "likelihood_loss": aux["likelihood_loss"],
                   "kl_loss": aux["kl_loss"], "gamma": state.gamma,
                   "loss_reg": loss_reg}
        metrics.update({k: v for k, v in aux.items() if k.startswith("ll_")})
        if gan is not None:
            metrics.update(gan_update(target, aux["out"].to(target.dtype)))
            metrics["gen_gan_loss"] = aux["gen_gan_loss"]
        return metrics

    return train_step


def make_org_vunet_train_step(vunet, perceptual, optimizers: dict,
                              config: dict, total_steps: int) -> Callable:
    """``train_step(state, batch, generator=None, dropout_generator=None,
    eps=None) -> metrics`` of the original VUNet: the KL weight ramps with
    ``state.step`` over ``total_steps`` (``training.kl_init``,
    ``kl_max``); ``batch`` holds NHWC ``app_img`` (the part stack),
    ``stickman`` and ``pose_img``; ``eps`` as the cvbae step's."""
    tr = config.get("training", {})
    ll_weight = float(tr.get("ll_weight", 1.0))
    vgg_weights = list(tr.get("vgg_weights", [1.0] * 6))
    grad_accum = int(tr.get("grad_accum", 1))
    kl_init, kl_max = float(tr.get("kl_init", 1e-6)), float(
        tr.get("kl_max", 1.0))
    params = list(vunet.parameters())
    opt, lr_schedule = optimizers["vunet"], optimizers["vunet_lr"]

    def loss_fn(kl_weight, generator, dropout_generator, app, shape,
                target, eps):
        out, q_means, _, p_means, _ = vunet(
            app, shape, train=True, eps=eps, generator=generator,
            dropout_generator=dropout_generator)
        ll_dict = vgg_loss(perceptual(target),
                           perceptual(out.to(target.dtype)), vgg_weights)
        likelihood = ll_weight * sum(ll_dict.values())
        kl = compute_kl_loss(p_means, q_means)
        return likelihood + kl_weight * kl, {"likelihood_loss": likelihood,
                                             "kl_loss": kl}

    def train_step(state: VunetTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   dropout_generator: Optional[torch.Generator] = None,
                   eps: Optional[Sequence[Sequence[torch.Tensor]]] = None
                   ) -> Dict[str, torch.Tensor]:
        target = batch["pose_img"]
        kl_weight = schedules.kl_ramp(state.step, total_steps,
                                      kl_init=kl_init, kl_max=kl_max)
        opt.zero_grad(set_to_none=True)
        loss, aux, grads = _accumulate(
            partial(loss_fn, kl_weight, generator, dropout_generator),
            params, (batch["app_img"], batch["stickman"], target),
            grad_accum, eps)
        opt.step()
        grad_norm = global_norm(grads)
        lr_schedule.step()
        state.step += 1
        return {"loss": loss,
                "kl_weight": torch.tensor(kl_weight, device=target.device),
                "grad_norm": grad_norm, **aux}

    return train_step
