"""cvbae experiment driver: VUNet-alter with a KL-to-prior bottleneck.

Counterpart of ``ShapePoseExperiment.run_training``
(``behavior_driven_video_synthesis_tpu/experiments/shape_and_pose_net.py:
158-236``): perceptual likelihood + adaptive-gamma KL + latent pose
regressor, on the synthetic image dataset.  Not ported yet: the
in-training SSIM / IS evaluation and image grids (ROADMAP A10, A12), real
datasets, and resuming from a checkpoint.

The synthesis model is written as ``<ckpt dir>/synth.npz`` (flax trees
``vunet/...`` and ``regressor/...``) with ``synth.json`` (the run's
``architecture``, ``data`` and ``general`` config) every ``ckpt_steps``
steps and at the end: the files ``bdvs-generate-torch --synth_params``
reads.
"""
from __future__ import annotations

import json
import os

import torch

from ..data.synthetic_images import SyntheticImageDataset
from ..models import convert
from ..models.init import init_like_jax_
from ..models.perceptual import perceptual_from_config
from ..models.vunet import VunetRegressor, latent_widths, vunet_from_config
from ..train.state import make_vunet_optimizers
from ..train.vunet_exp import VunetTrainState, make_cvbae_train_step
from .base import Experiment


class _Epochs:
    """Batches of the dataset in a new order each epoch (the JAX driver's
    ``_Adapter``: epoch seeds 2, 3, ...)."""

    def __init__(self, ds, batch_size):
        self.ds, self.batch_size, self._epoch = ds, batch_size, 1

    def __len__(self):
        return len(self.ds) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        return self.ds.batches(self.batch_size, seed=self._epoch)


class ShapePoseExperiment(Experiment):
    variant = "alter"

    def _build_data(self):
        dcfg = self.config.get("data", {})
        name = str(dcfg.get("dataset", "synthetic_images")).lower()
        if name not in ("synthetic_images", "synthetic"):
            raise NotImplementedError(f"dataset {name!r} is not ported yet "
                                      "(only synthetic_images is)")
        ds = SyntheticImageDataset(
            n_persons=int(dcfg.get("n_persons", 8)),
            frames_per_person=int(dcfg.get("frames_per_person", 16)),
            spatial_size=int(dcfg.get("spatial_size", 64)), seed=0,
            with_reg=bool(self.config["training"].get("train_regressor",
                                                      False)),
            inplane_normalize=bool(dcfg.get("inplane_normalize", False)),
            device=self.device)
        return _Epochs(ds, int(self.config["training"]["batch_size"]))

    def _build_models(self, spatial_size: int, generator):
        arch = self.config.get("architecture", {})
        vunet = vunet_from_config(self.config, self.variant, n_channels_x=3,
                                  spatial_size=spatial_size,
                                  device=self.device)
        init_like_jax_(vunet, generator)
        regressor = None
        if bool(self.config["training"].get("train_regressor", False)):
            regressor = VunetRegressor(
                n_out=36,
                latent_widths=latent_widths(
                    spatial_size,
                    int(self.config.get("data", {}).get("bottleneck_factor",
                                                        2)),
                    int(arch.get("n_scales", 0)),
                    int(arch.get("n_latent_scales", 2))),
                nf_max=int(arch.get("nf_max", 128)),
                linear_width_factor=int(arch.get("linear_width_factor", 1)),
                n_linear=int(arch.get("n_linear", 2)), device=self.device)
            init_like_jax_(regressor, generator)
        return vunet, regressor

    def save_synth(self, vunet, regressor) -> str:
        """Write synth.npz + synth.json; returns the .npz path."""
        tree = {"vunet": convert.vunet_alter_to_flax(vunet.state_dict())}
        if regressor is not None:
            tree["regressor"] = convert.vunet_regressor_to_flax(
                regressor.state_dict())
        path = os.path.join(self.dirs["ckpt"], "synth.npz")
        tmp = os.path.join(self.dirs["ckpt"], "synth.tmp.npz")
        convert.save_flax_npz(tmp, tree)
        os.replace(tmp, path)
        with open(os.path.join(self.dirs["ckpt"], "synth.json"), "w") as f:
            json.dump({k: self.config.get(k, {}) for k in
                       ("architecture", "data", "general")}, f, indent=1,
                      default=list)
        return path

    def run_training(self):
        """Train for ``end_iteration`` steps (8 at most with --debug).
        Returns the models, the train state and the last synth.npz."""
        cfg = self.config
        tr = cfg["training"]
        seed = int(cfg.get("general", {}).get("seed", 42))
        gens = [torch.Generator(device=self.device).manual_seed(seed + i)
                for i in range(3)]
        loader = self._build_data()
        if len(loader) == 0:
            raise ValueError("the dataset holds fewer items than one batch")
        spatial = int(cfg.get("data", {}).get("spatial_size", 64))
        vunet, regressor = self._build_models(spatial, gens[0])
        vunet.train()
        perceptual = perceptual_from_config(cfg)
        optimizers = make_vunet_optimizers(vunet, regressor, tr)
        step_fn = make_cvbae_train_step(vunet, regressor, perceptual,
                                        optimizers, cfg)
        state = VunetTrainState(gamma=torch.zeros((), device=self.device))

        end_iteration = int(tr.get("end_iteration", 1000))
        if self.debug:
            end_iteration = min(end_iteration, 8)
        ckpt_steps = int(cfg.get("logging", {}).get("ckpt_steps", 500))
        path = None
        while state.step < end_iteration:
            for batch in loader:
                self.collect(step_fn(state, batch, generator=gens[1],
                                     dropout_generator=gens[2]))
                it = state.step
                if it % 50 == 0 or it == end_iteration:
                    self.log(it)
                if it % ckpt_steps == 0 or it == end_iteration:
                    path = self.save_synth(vunet, regressor)
                if it >= end_iteration:
                    break
        return {"vunet": vunet, "regressor": regressor, "state": state,
                "synth_params": path,
                "n_params": sum(p.numel() for p in vunet.parameters())}
