"""The adversarial (GAN) branch of the cvbae training step.

Counterpart of ``behavior_driven_video_synthesis_tpu/train/gan.py``: a
PatchGAN discriminator trained against the VUNet's outputs with BCE losses
and the optional R1 penalty.  ``GANState`` holds the discriminator and its
Adam (``train/state.py:make_disc_optimizer``); ``make_gan_update`` returns
the discriminator's update and the generator's loss, which the cvbae step
(``train/vunet_exp.py``) calls: the generator's loss inside the VUNet's
loss, through the discriminator as it was before this step's update, and
the update afterwards, on the targets and the detached outputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.init import init_like_jax_
from ..models.synth_discriminators import (PatchGANDiscriminator,
                                           disc_loss_with_r1,
                                           generator_gan_loss)
from .state import make_disc_optimizer


@dataclass
class GANState:
    disc: nn.Module
    opt: torch.optim.Optimizer


def create_gan_state(disc_model: nn.Module, training: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> GANState:
    """The discriminator with the JAX package's initializers drawn from
    ``generator``, and its Adam."""
    init_like_jax_(disc_model, generator)
    return GANState(disc=disc_model,
                    opt=make_disc_optimizer(disc_model, training))


def make_gan_update(gan_state: GANState, lambda_gp: float = 10.0,
                    use_gp: bool = False) -> Tuple[Callable, Callable]:
    """(update, gen_loss): ``update(real, fake)`` takes one Adam step of the
    discriminator on its loss (its gradients set afresh) and returns the
    loss's terms, detached; ``gen_loss(fake)`` is the generator's BCE
    through the discriminator, with gradients for the fake alone."""
    disc, opt = gan_state.disc, gan_state.opt

    def update(real: torch.Tensor, fake: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        loss, out = disc_loss_with_r1(disc, real, fake,
                                      lambda_gp=lambda_gp, use_gp=use_gp)
        loss.backward()
        opt.step()
        return {k: v.detach() for k, v in out.items()}

    def gen_loss(fake: torch.Tensor) -> torch.Tensor:
        return generator_gan_loss(disc, fake)

    return update, gen_loss


def build_discriminator(config: dict, device=None) -> PatchGANDiscriminator:
    """The PatchGAN of ``training.disc_ndf`` (64) and ``disc_layers`` (3),
    computing in bf16 unless ``training.bf16`` is false."""
    tr = config.get("training", {})
    return PatchGANDiscriminator(
        ndf=int(tr.get("disc_ndf", 64)),
        n_layers=int(tr.get("disc_layers", 3)),
        dtype=torch.bfloat16 if bool(tr.get("bf16", True)) else torch.float32,
        device=device)
