"""The VUNet experiments: cvbae (``ShapePoseExperiment``, VUNet-alter with a
KL-to-prior bottleneck) and the original VUNet (``VunetExperiment``).

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
shape_and_pose_net.py`` (``run_training`` :158-236, ``_log_image_grids``
:243-268, ``_batch_keypoints`` :270-282, ``_eval_ssim`` :284-418,
``run_inference`` :420-442, ``_posthoc_latent_regressor`` :444-524,
``VunetExperiment`` :527-537) on one device.  The data (``_build_data``)
is the synthetic image dataset (``dataset: synthetic_images``, rendered
on the device) or a real one through ``data/__init__.py:get_dataset``:
``human3.6m`` (an ``annot_export.h5`` tree), ``deepfashion`` or
``market`` (an ``index.p`` tree) under ``data.datapath``, whose items
``data.n_data_workers`` threads fetch (``data/loader.py:Loader``, a
``PerPersonSampler`` where the dataset has persons, else a
``RandomSampler``, under a ``SequenceSampler``) and whose batches go to
the device from pinned memory without blocking, a batch ahead, the part
stacks made there.  With ``data.inplane_normalize`` the appearance is the
30-channel part stack, and the VUNet's appearance encoder takes 30
channels:

  training: the cvbae step (perceptual likelihood, adaptive-gamma KL,
            latent pose regressor) or the org step (perceptual likelihood,
            ramped KL to the autoregressive prior), ``end_iteration``
            steps (8 at most with ``--debug``); image grids every
            ``logging.log_steps``; SSIM on ``metrics.ssim_train_samples``
            test images every ``metrics.n_it_metrics``, recorded in
            ``<ckpt dir>/metric_ckpts.json``; the train state saved every
            ``logging.ckpt_steps`` and at the end;
  inference (``-m infer``): the newest save restored; SSIM over up to
            ``metrics.max_n_samples`` test images, and with
            ``metrics.compute_is`` / ``compute_fid`` the Inception Score
            of the transfers (``is_recon``) and of prior samples
            (``is_transfer``) and the FID of the transfers against the
            targets, all resized to 128 px (antialiased) and, with
            ``metrics.is_on_crops`` (the default), cropped about the
            keypoints first; the targets' features are cached in
            ``<ckpt dir>/<dataset>-fid-features.npy`` and read by later
            evaluations; InceptionV3 loads
            ``metrics.inception_weights_path`` or is randomly initialized;
            with ``metrics.posthoc_regressor`` (the default) a fresh pose
            regressor trained on the frozen posterior means of the test
            images (Adam 1e-3, 20 epochs, 2 with ``--debug``); the summary
            logged under ``infer/``.

The train state (the VUNet, the regressor, both optimizers and the lr
schedule, gamma, the step and the noise and dropout generators) is saved
in ``<ckpt dir>/reg_ckpt`` (``core/checkpoint.py``) and restored whenever
a save exists, so the lr decay and the KL ramp go on from its step and a
finished run runs no step.  The synthesis model is also written as
``<ckpt dir>/synth.npz`` (flax trees ``vunet/...`` and, with a regressor,
``regressor/...``) with ``synth.json`` (the run's ``architecture``,
``data`` and ``general`` config): the files ``bdvs-generate-torch
--synth_params`` reads.  Synthetic test images come from the dataset's
seed 1, with epochs numbered from 1001, as in the JAX driver.

The cvbae regressor predicts the probe images' keypoints: 36 outputs (18
keypoints) as in the JAX driver, or twice the dataset's keypoints
(Human3.6M's 17 give 34, where the JAX driver's 36 outputs fail against
34 targets, ROADMAP C8).  Not ported: the GAN branch (``training.use_gan``;
A11).  With in-plane part stacks the JAX post-hoc regressor encodes the
3-channel pose image with the 30-channel appearance encoder and fails
(ROADMAP C6); this driver refuses that input up front.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..data import get_dataset
from ..data.loader import Loader, prefetch_iter
from ..data.parts import PART_SUFFIXES, finish_part_stacks
from ..data.samplers import PerPersonSampler, RandomSampler, SequenceSampler
from ..data.synthetic_images import SyntheticImageDataset
from ..metrics.fid import fid_from_features
from ..metrics.inception_score import inception_score_from_logits
from ..metrics.ssim import ssim
from ..models import convert
from ..models.inception import (InceptionV3Features, inception_features,
                                load_inception_weights)
from ..models.init import init_like_jax_
from ..models.perceptual import perceptual_from_config
from ..models.vunet import VunetRegressor, latent_widths, vunet_from_config
from ..train.state import make_vunet_optimizers
from ..train.vunet_exp import (VunetTrainState, make_cvbae_train_step,
                               make_org_vunet_train_step)
from ..utils.boxes import bounding_box_batch
from ..viz.videos import frames_to_uint8, make_img_grid, write_image
from .base import Experiment

N_GRID_IMAGES = 4


class _Epochs:
    """Batches of the dataset in a new order each epoch (the JAX driver's
    ``_Adapter``: epoch seeds 2, 3, ... for training, 1001, 1002, ... for
    the test split)."""

    def __init__(self, ds, batch_size, first_epoch: int):
        self.ds, self.batch_size, self._epoch = ds, batch_size, first_epoch

    def __len__(self):
        return len(self.ds) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        return self.ds.batches(self.batch_size, seed=self._epoch)


class _DeviceBatches:
    """A loader's numpy batches on ``device``: each array copied from
    pinned memory without blocking (a plain copy off the card) on a
    background thread a batch ahead, then the batch's part stacks made
    (``data/parts.py:finish_part_stacks``)."""

    def __init__(self, loader, device, part_size: int):
        self.loader, self.device, self.part_size = loader, device, part_size

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return prefetch_iter(iter(self.loader), self.place, n=1)

    def place(self, batch: Dict[str, np.ndarray]) -> Dict:
        out = {}
        for k, v in batch.items():
            if k.endswith(PART_SUFFIXES[1:]):      # homographies stay
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True)
                      if self.device.type == "cuda" else t.to(self.device))
        return finish_part_stacks(out, self.part_size)


class ShapePoseExperiment(Experiment):
    variant = "alter"

    def __init__(self, config, dirs, device):
        super().__init__(config, dirs, device)
        self.seed = int(config.get("general", {}).get("seed", 42))
        self.inplane = bool(config.get("data", {}).get("inplane_normalize",
                                                       False))
        self._datasets = {}

    # -- construction -------------------------------------------------------
    def _build_data(self, mode: str):
        """(batches, dataset) of the train or test split, built once a
        split: the synthetic dataset (seed 0 or 1) rendered on the device,
        or a real dataset's batches placed on it (:class:`_DeviceBatches`).
        """
        if mode in self._datasets:
            return self._datasets[mode]
        dcfg = self.config.get("data", {})
        bs = int(self.config["training"]["batch_size"])
        train_reg = bool(self.config["training"].get("train_regressor",
                                                     False))
        name = str(dcfg.get("dataset", "synthetic_images")).lower()
        if name in ("synthetic_images", "synthetic"):
            ds = SyntheticImageDataset(
                n_persons=int(dcfg.get("n_persons", 8)),
                frames_per_person=int(dcfg.get("frames_per_person", 16)),
                spatial_size=int(dcfg.get("spatial_size", 64)),
                seed=0 if mode == "train" else 1, with_reg=train_reg,
                inplane_normalize=self.inplane,
                box_factor=int(dcfg.get("box_factor", 2)),
                device=self.device)
            out = (_Epochs(ds, bs, 1 if mode == "train" else 1000), ds)
        else:
            kwargs = {k: v for k, v in dcfg.items()
                      if k not in ("dataset", "seq_length")}
            ds = get_dataset({"dataset": name})(
                transforms=None,
                data_keys=["pose_img", "stickman", "app_img", "sample_ids"],
                seq_length=tuple(dcfg.get("seq_length", (0, 0))), mode=mode,
                train_regressor=train_reg, **kwargs)
            if len(ds) == 0:
                raise ValueError(f"the {name} dataset at data.datapath "
                                 f"{dcfg.get('datapath')!r} holds no {mode} "
                                 f"images")
            ids = (PerPersonSampler(ds) if getattr(ds, "person_ids", None)
                   else RandomSampler(ds))
            loader = Loader(ds, SequenceSampler(ds, ids, bs),
                            num_workers=int(dcfg.get("n_data_workers", 8)))
            part = ds.spatial_size // 2 ** ds.box_factor
            out = (_DeviceBatches(loader, self.device, part), ds)
        self._datasets[mode] = out
        return out

    def _regressor_outputs(self, ds) -> int:
        """Twice the probe targets' keypoints: 36 for the synthetic
        dataset (18 keypoints, the JAX driver's fixed width)."""
        if isinstance(ds, SyntheticImageDataset):
            return 36
        return int(np.prod(ds._get_kps_for_rendering(0).shape))

    def _latent_widths(self) -> List[int]:
        arch, data = self.config.get("architecture", {}), self.config.get(
            "data", {})
        return latent_widths(int(data.get("spatial_size", 64)),
                             int(data.get("bottleneck_factor", 2)),
                             int(arch.get("n_scales", 0)),
                             int(arch.get("n_latent_scales", 2)))

    def _new_regressor(self, n_out: int, generator) -> VunetRegressor:
        arch = self.config.get("architecture", {})
        regressor = VunetRegressor(
            n_out=n_out, latent_widths=self._latent_widths(),
            nf_max=int(arch.get("nf_max", 128)),
            linear_width_factor=int(arch.get("linear_width_factor", 1)),
            n_linear=int(arch.get("n_linear", 2)), device=self.device)
        return init_like_jax_(regressor, generator)

    def _build_models(self, generator, n_reg_out: int = 36):
        vunet = vunet_from_config(self.config, self.variant,
                                  n_channels_x=30 if self.inplane else 3,
                                  spatial_size=int(self.config.get(
                                      "data", {}).get("spatial_size", 64)),
                                  device=self.device)
        init_like_jax_(vunet, generator)
        regressor = None
        if bool(self.config["training"].get("train_regressor", False)):
            regressor = self._new_regressor(n_reg_out, generator)
        return vunet, regressor

    def _make_step(self, vunet, regressor, perceptual, optimizers):
        return make_cvbae_train_step(vunet, regressor, perceptual,
                                     optimizers, self.config)

    def _eps(self, batch_size: int):
        """Posterior noise of an evaluation's encoding of ``batch_size``
        images, one tensor per latent scale; None draws it from the run's
        generator (tests hand in shared noise here)."""
        return None

    # -- training -----------------------------------------------------------
    def run_training(self):
        """Train for ``end_iteration`` steps (8 at most with --debug),
        going on from the newest save.  Returns the models, the train
        state and the last synth.npz."""
        cfg = self.config
        tr = cfg["training"]
        gens = [torch.Generator(device=self.device).manual_seed(
            self.seed + i) for i in range(3)]
        self.generator = gens[1]
        loader, ds = self._build_data("train")
        if len(loader) == 0:
            raise ValueError("the dataset holds fewer items than one batch")
        vunet, regressor = self._build_models(gens[0],
                                              self._regressor_outputs(ds))
        vunet.train()
        perceptual = perceptual_from_config(cfg, self.device, gens[0])
        optimizers = make_vunet_optimizers(vunet, regressor, tr)
        step_fn = self._make_step(vunet, regressor, perceptual, optimizers)
        state = VunetTrainState(gamma=torch.zeros((), device=self.device))
        modules = {"vunet": vunet, "regressor": regressor}
        mgr, _ = self.restore("reg_ckpt", lambda p: self._load(
            p, modules, optimizers, state, gens[1:]))

        end_iteration = int(tr.get("end_iteration", 1000))
        if self.debug:
            end_iteration = min(end_iteration, 8)
        logging = cfg.get("logging", {})
        ckpt_steps = int(logging.get("ckpt_steps", 500))
        log_steps = int(logging.get("log_steps", 300))
        mcfg = cfg.get("metrics", {})
        metric_steps = int(mcfg.get("n_it_metrics", 1000))
        ssim_samples = int(mcfg.get("ssim_train_samples", 256))
        path = None

        def save():
            mgr.save(state.step, self._payload(modules, optimizers, state,
                                               gens[1:]))
            return self.save_synth(vunet, regressor)

        while state.step < end_iteration:
            for batch in loader:
                self.collect(step_fn(state, batch, generator=gens[1],
                                     dropout_generator=gens[2]))
                it = state.step
                if it % 50 == 0 or it == end_iteration:
                    self.log(it)
                if it % log_steps == 0:
                    self._log_image_grids(vunet, batch, it)
                if it % ckpt_steps == 0 or it == end_iteration:
                    path = save()
                if it % metric_steps == 0:
                    self._record_metric_ckpt(it, self._eval_ssim(
                        vunet, it, ssim_samples))
                if it >= end_iteration:
                    break
        if mgr.latest_step() != state.step or path is None:
            path = save()
        return {"vunet": vunet, "regressor": regressor, "state": state,
                "synth_params": path,
                "n_params": sum(p.numel() for p in vunet.parameters())}

    def _payload(self, modules, optimizers, state, gens) -> dict:
        return {
            "modules": {k: m.state_dict() for k, m in modules.items()
                        if m is not None},
            "optimizers": {k: o.state_dict() for k, o in optimizers.items()
                           if o is not None},
            "step": state.step, "gamma": state.gamma,
            "generators": [g.get_state() for g in gens]}

    @staticmethod
    def _load(payload, modules, optimizers=None, state=None, gens=()):
        for k, m in modules.items():
            if m is not None:
                m.load_state_dict(payload["modules"][k])
        for k, o in (optimizers or {}).items():
            if o is not None:
                o.load_state_dict(payload["optimizers"][k])
        if state is not None:
            state.step = int(payload["step"])
            state.gamma = payload["gamma"].to(state.gamma.device)
        for g, s in zip(gens, payload["generators"]):
            g.set_state(s)

    def save_synth(self, vunet, regressor) -> str:
        """Write synth.npz + synth.json; returns the .npz path."""
        to_flax = (convert.vunet_org_to_flax if self.variant == "org"
                   else convert.vunet_alter_to_flax)
        tree = {"vunet": to_flax(vunet.state_dict())}
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

    def _record_metric_ckpt(self, step: int, ssim_val: float) -> None:
        """The step's SSIM in ``<ckpt dir>/metric_ckpts.json`` (the JAX
        driver's sidecar beside its integer-stepped saves)."""
        path = os.path.join(self.dirs["ckpt"], "metric_ckpts.json")
        records = {}
        if os.path.exists(path):
            with open(path) as f:
                records = json.load(f)
        records[str(step)] = {"ssim": ssim_val}
        with open(path, "w") as f:
            json.dump(records, f, indent=1)

    @torch.no_grad()
    def _log_image_grids(self, vunet, batch, step: int,
                         n: int = N_GRID_IMAGES) -> str:
        """Target, stickman, transfer and prior sample of the first ``n``
        items side by side, one item a row, under the generated dir."""
        app, stick = batch["app_img"][:n], batch["stickman"][:n]
        target = batch["pose_img"][:n]
        recon = vunet.transfer(app, stick, self._eps(len(app)),
                               self.generator)
        prior = vunet.test_forward(stick, generator=self.generator)
        rows = torch.cat([target[..., :3].float(), stick.float(),
                          recon.float(), prior.float()], dim=2)
        grid = make_img_grid(frames_to_uint8(rows.cpu().numpy()), n_cols=1)
        return write_image(grid, os.path.join(self.dirs["generated"],
                                              f"grid_{step:07d}.png"))

    # -- evaluation ---------------------------------------------------------
    def _batch_keypoints(self, batch, ds) -> torch.Tensor:
        """Normalized 2D keypoints (B, K, 2) of a batch: its own, or the
        dataset's ``norm_keypoints`` at each item's ``sample_ids`` (a file
        dataset's item holds its frame's id as a sequence of one; the JAX
        driver's crop fails on the (B, 1, K, 2) that indexing with those
        gives, ROADMAP C9)."""
        if "keypoints" in batch:
            return batch["keypoints"].float()
        kps = getattr(ds, "norm_keypoints", None)
        if kps is None:
            kps = ds.datadict["norm_keypoints"]
        ids = batch["sample_ids"].reshape(len(batch["pose_img"]), -1)[:, 0]
        return torch.as_tensor(np.asarray(kps[ids.cpu().numpy()],
                                          np.float32), device=self.device)

    # -- the Inception metrics -----------------------------------------------
    def _inception(self) -> InceptionV3Features:
        """InceptionV3 with logits, f32, from
        ``metrics.inception_weights_path`` or randomly initialized."""
        model = InceptionV3Features(with_logits=True, device=self.device)
        path = self.config.get("metrics", {}).get("inception_weights_path")
        if path:
            load_inception_weights(model, str(path))
        else:
            print("metrics: InceptionV3 with RANDOM init (no pretrained "
                  "weights in this environment) — IS/FID values are "
                  "relative only, NOT literature-comparable; see "
                  "WEIGHTS.md")
            init_like_jax_(model, torch.Generator(
                device=self.device).manual_seed(0))
        return model.eval().requires_grad_(False)

    # -- evaluation ---------------------------------------------------------
    def _eval_ssim(self, vunet, step: int,
                   max_samples: Optional[int] = None) -> float:
        """The SSIM of :meth:`_eval_metrics`."""
        return self._eval_metrics(vunet, step, max_samples)["ssim"]

    @torch.no_grad()
    def _eval_metrics(self, vunet, step: int,
                      max_samples: Optional[int] = None) -> Dict[str, float]:
        """Mean SSIM of transfers (the posterior means of the appearance,
        the target's stickman) against the targets on the test split,
        clipped to [0, 1], over at most ``max_samples`` images
        (``metrics.max_n_samples``, 8000, if None); with
        ``metrics.compute_is`` the Inception Scores of the transfers
        (``is_recon``) and of prior samples of the stickmen
        (``is_transfer``), with ``metrics.compute_fid`` the transfers' FID
        against the targets.  Logged under ``eval/`` with the count."""
        mcfg = self.config.get("metrics", {})
        if max_samples is None:
            max_samples = int(mcfg.get("max_n_samples", 8000))
        compute_is = bool(mcfg.get("compute_is", False))
        compute_fid = bool(mcfg.get("compute_fid", False))
        is_on_crops = bool(mcfg.get("is_on_crops", True))
        spatial = int(self.config.get("data", {}).get("spatial_size", 64))
        loader, ds = self._build_data("test")
        feats = {"recon": [], "gt": [], "recon_logits": [],
                 "transfer_logits": []}
        fid_cache = have_gt_cache = None
        if compute_is or compute_fid:
            incep = self._inception()
            dataset = self.config.get("data", {}).get("dataset", "data")
            fid_cache = os.path.join(self.dirs["ckpt"],
                                     f"{dataset}-fid-features.npy")
            have_gt_cache = compute_fid and os.path.exists(fid_cache)
            if have_gt_cache:
                feats["gt"] = [torch.from_numpy(np.load(fid_cache))]

        def inception(img, batch):
            if is_on_crops:
                img = bounding_box_batch(
                    self._batch_keypoints(batch, ds) * spatial, img.float(),
                    spatial)
            return inception_features(incep, img)

        vals, n_seen = [], 0
        for batch in loader:
            target = batch["pose_img"]
            out = vunet.transfer(batch["app_img"], batch["stickman"],
                                 self._eps(len(target)), self.generator)
            vals.append(ssim(torch.clamp((out.float() + 1) / 2, 0, 1),
                             (target + 1) / 2))
            n_seen += int(target.shape[0])
            if compute_is or compute_fid:
                f, logits = inception(out, batch)
                if compute_fid:
                    feats["recon"].append(f)
                    if not have_gt_cache:
                        feats["gt"].append(inception(target, batch)[0])
                if compute_is:
                    feats["recon_logits"].append(logits)
                    prior = vunet.test_forward(batch["stickman"],
                                               self._eps(len(target)),
                                               self.generator)
                    feats["transfer_logits"].append(
                        inception(prior, batch)[1])
            if n_seen >= max_samples:
                break
        metrics = {"ssim": float(torch.cat(vals).mean()), "ssim_n": n_seen}
        if compute_is:
            for key, logits in (("is_recon", "recon_logits"),
                                ("is_transfer", "transfer_logits")):
                metrics[key] = inception_score_from_logits(
                    torch.cat(feats[logits]))[0]
        if compute_fid:
            gt = torch.cat([g.to(self.device) for g in feats["gt"]])
            if not have_gt_cache:
                np.save(fid_cache, gt.cpu().numpy())
            metrics["fid"] = fid_from_features(torch.cat(feats["recon"]), gt)
        self.log(step, prefix="eval/", extra=metrics, collected=False)
        return metrics

    def run_inference(self) -> Dict[str, float]:
        """SSIM (with IS and FID where asked for) and the post-hoc latent
        regressor on the newest save; returns the summary it logs under
        ``infer/``."""
        posthoc = bool(self.config.get("metrics", {}).get(
            "posthoc_regressor", True))
        if posthoc and self.inplane:
            raise ValueError(
                "metrics.posthoc_regressor with data.inplane_normalize: the "
                "post-hoc regressor encodes the 3-channel pose image with "
                "the 30-channel part-stack encoder, which the JAX package "
                "does not run either (ROADMAP C6); set "
                "metrics.posthoc_regressor: false")
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        vunet, _ = self._build_models(self.generator)
        out = CheckpointManager(os.path.join(
            self.dirs["ckpt"], "reg_ckpt")).restore_latest(
                map_location="cpu")
        if out is None:
            raise FileNotFoundError("no VUNet checkpoint (reg_ckpt) to "
                                    "evaluate")
        self._load(out[0], {"vunet": vunet})
        print(f"Restored reg_ckpt checkpoint at step {out[1]}")
        vunet.eval().requires_grad_(False)
        summary = {k: v for k, v in self._eval_metrics(vunet, 0).items()
                   if k != "ssim_n"}
        print(f"inference SSIM: {summary['ssim']:.4f}")
        if posthoc:
            summary.update(self._posthoc_latent_regressor(vunet))
        self.log(0, prefix="infer/", extra=summary, collected=False)
        return summary

    def _posthoc_latent_regressor(self, vunet) -> Dict[str, float]:
        """A fresh pose regressor from the frozen posterior means of the
        test images to their keypoints, Adam(1e-3) for 20 epochs (2 with
        --debug): the disentanglement probe of the inference protocol.
        Returns the mean of its last 100 losses; plots the loss course as
        generated/loss_course_eval.png where matplotlib imports."""
        loader, ds = self._build_data("test")
        first = next(iter(loader))
        n_out = self._batch_keypoints(first, ds)[0].numel()
        regressor = self._new_regressor(n_out, self.generator)
        opt = torch.optim.Adam(regressor.parameters(), lr=1e-3)

        def encode(img):
            with torch.no_grad():
                return vunet.encode_means(img, self._eps(len(img)),
                                          self.generator)[0]

        losses = []
        for _ in range(2 if self.debug else 20):
            for batch in loader:
                tgt = self._batch_keypoints(batch, ds).reshape(
                    len(batch["pose_img"]), -1)
                means = encode(batch["pose_img"])
                opt.zero_grad(set_to_none=True)
                loss = torch.mean(torch.sqrt(torch.sum(
                    (regressor(means) - tgt) ** 2, dim=1) + 1e-12))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        losses = torch.stack(losses).cpu().numpy()
        self._plot_losses(losses)
        return {"loss_regressor_posthoc": float(np.mean(losses[-100:]))}

    def _plot_losses(self, losses) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("regressor loss plot skipped: no matplotlib")
            return
        plt.plot(np.arange(len(losses)), losses)
        plt.xlabel("Train iterations")
        plt.ylabel("Loss")
        plt.title("Loss of regressor from shape latents to pose.")
        plt.savefig(os.path.join(self.dirs["generated"],
                                 "loss_course_eval.png"))
        plt.close()


class VunetExperiment(ShapePoseExperiment):
    """The original VUNet (variant "org"), trained by the org step."""

    variant = "org"

    def _make_step(self, vunet, regressor, perceptual, optimizers):
        total = int(self.config["training"].get("end_iteration", 1000))
        return make_org_vunet_train_step(vunet, perceptual, optimizers,
                                         self.config, total)
