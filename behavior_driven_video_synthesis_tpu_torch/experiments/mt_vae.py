"""The MT-VAE baseline experiment, the paper's comparison model.

Counterpart of ``MTVAEExperiment`` in
``behavior_driven_video_synthesis_tpu/experiments/mt_vae.py`` (:20-176) on
one device:

  training: ``n_epochs`` epochs over the sequence data
           (``experiments/data_factory.py``; at most 2 with ``--debug``),
           the KL ramp over len(loader) * max(1, n_epochs - 10) steps; in
           the last 10 epochs of a run longer than 10 the updates are off;
           a train/ line and a ``reg_ckpt`` save (the newest 3 kept) after
           every epoch; a run restores its newest save and goes on from
           that save's epoch, so a finished run runs no step;
  inference (``-m infer``): the newest save restored; per test batch (at
           most ``max_batches``, 2 with ``--debug``) APD/ASD/FSD/ADE/FDE
           over ``n_samples`` prior samples of each sequence (batched
           SAMPLE_ROWS sequences a forward), the posterior
           self-reconstruction's MSE, and ADE_c/FDE_c of the transfer onto
           the paired sequence's context; then the post-hoc real/fake
           classifiers (``eval_protocol.py``) over the prior, self and
           cross outputs (``metrics.posthoc_iters`` iterations, 50 with
           ``--debug``); the summary is logged under ``infer/``.  The
           caches stay on the device.

``training.bf16`` runs the products in bf16 with float32 parameters and
Adam state.  The width is the reference's (dim 1024, z 512): like the JAX
experiment, this one reads no ``architecture.dim_hidden_b``.  Every draw of
training comes from one generator (checkpointed with the state), every
draw of inference from :class:`InferenceDraws`, seeded from
``general.seed`` on the run's device.  ``general.visualization`` (``-v``)
writes, after each epoch, ``e<epoch>_mtvae_seq<i>.mp4`` of the epoch's
last batch (``experiments/visualize.py:visualize_mtvae``) and, in ``-m
infer``, ``mtvae_eval_<i>.png`` of the first test batch (filmstrips of a
prior sample, the reconstruction, the transfer and the ground truth)
under the run's ``generated`` directory.  The figures draw from a
generator of their own (seeded ``general.seed + 2``), so training's
metrics are the same with and without ``-v``.  Under data parallelism
(``parallel/mesh.py``) each rank trains on its rows of every global
batch, with its rows of the step's noise, and the gradients averaged
over the ranks; rank 0 logs, saves and draws the figures.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..data.loader import prefetch_iter
from ..metrics.sequence import sequence_sample_metrics
from ..models.init import init_like_jax_
from ..models.mtvae import MTVAE
from ..parallel import mesh
from ..train.mtvae_exp import MTVAETrainState, make_mtvae_train_step
from ..train.state import make_mtvae_optimizer
from . import visualize
from .base import Experiment
from .data_factory import build_sequence_data
from .eval_protocol import (PosthocDraws, cross_transfer_metrics,
                            train_posthoc_classifiers)

DEBUG_POSTHOC_ITERS = 50
SAMPLE_ROWS = 4096   # sequences one prior-sampling forward holds


class InferenceDraws:
    """The draws of inference from one generator on the device:
    ``noise(site, model, batch, device)`` gives one forward's noise (site
    "prior", "self" or "cross"), ``posthoc`` the post-hoc probes'.  A test
    hands in another run's values by overriding both."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.posthoc = PosthocDraws(generator)

    def noise(self, site: str, model: MTVAE, batch: int, device):
        return model.draw_noise(batch, self.generator, device)


def _3d(x):
    """(..., K) keypoints -> (..., K / 3, 3)."""
    return x.reshape(x.shape[:-1] + (-1, 3))


class MTVAEExperiment(Experiment):
    def __init__(self, config, dirs, device):
        super().__init__(config, dirs, device)
        tr = config.get("training", {})
        self.dtype = (torch.bfloat16 if bool(tr.get("bf16", False))
                      else torch.float32)
        self.seed = int(config.get("general", {}).get("seed", 42))
        self.init_generator = torch.Generator(self.device).manual_seed(
            self.seed)
        self.generator = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self.visualization = bool(config.get("general", {}).get(
            "visualization", False))
        self.figure_generator = torch.Generator(self.device).manual_seed(
            self.seed + 2)

    def _build_model(self, n_kps: int) -> MTVAE:
        model = MTVAE(n_kps, int(self.config["training"].get("n_cond", 10)),
                      dtype=self.dtype, device=self.device)
        return init_like_jax_(model, self.init_generator)

    # -- training -----------------------------------------------------------
    def run_training(self):
        """Returns the model, its train state and its parameter count."""
        cfg = self.config
        tr = cfg["training"]
        train_loader, meta = build_sequence_data(cfg, "train", shard=True)
        n_epochs = int(tr["n_epochs"])
        if self.debug:
            n_epochs = min(n_epochs, 2)
        steps_per_epoch = max(1, len(train_loader))
        model = self._build_model(meta["n_kps"])
        state = MTVAETrainState(model, make_mtvae_optimizer(model, tr))
        # a new epoch of the loader, as the JAX experiment's sample batch is
        next(iter(train_loader))
        mgr, start = self.restore("reg_ckpt", lambda p: self._load(state, p))
        mesh.replicate([model])
        mesh.sync_gradients(state.optimizer)
        step_fn = make_mtvae_train_step(
            cfg, steps_per_epoch * max(1, n_epochs - 10))
        for epoch in range(start // steps_per_epoch, n_epochs):
            enable = epoch < n_epochs - 10 or n_epochs <= 10
            for batch in prefetch_iter(iter(train_loader), self._prep_batch):
                with mesh.batch_shard():
                    self.collect(step_fn(state, batch, enable,
                                         generator=self.generator))
            self.log(state.step, prefix="train/")
            if self.visualization and mesh.is_main():
                visualize.visualize_mtvae(
                    model, batch, self.dirs["generated"],
                    norm_stats=meta.get("norm_stats"),
                    tag=f"e{epoch:03d}_", generator=self.figure_generator)
            mgr.save(state.step, self._payload(state))
        return {"model": model, "state": state,
                "n_params": sum(p.numel() for p in model.parameters())}

    # -- inference ----------------------------------------------------------
    def run_inference(self, n_samples: int = 50, max_batches: int = 20,
                      draws: Optional[InferenceDraws] = None
                      ) -> Dict[str, float]:
        """The evaluation over the test split; returns the summary it logs
        under ``infer/``."""
        cfg = self.config
        test_loader, meta = build_sequence_data(cfg, "test")
        model = self._build_model(meta["n_kps"])
        if draws is None:
            draws = InferenceDraws(torch.Generator(self.device).manual_seed(
                self.seed))
        # a new epoch of the loader where the JAX experiment takes its
        # template batch, so that both evaluate the same test batches
        next(iter(test_loader))
        out = CheckpointManager(os.path.join(
            self.dirs["ckpt"], "reg_ckpt")).restore_latest(
                map_location="cpu")
        if out is None:
            raise FileNotFoundError("no mtvae checkpoint to evaluate")
        model.load_state_dict(out[0]["state"]["model"])
        print(f"Restored reg_ckpt checkpoint at step {out[1]}")
        model.eval().requires_grad_(False)
        div = model.n_cond

        rows = []
        caches = {k: [] for k in ("orig", "prior", "self", "cross")}
        with torch.no_grad():
            for i, batch in enumerate(test_loader):
                batch = self._prep_batch(batch)
                kps, cross = batch["keypoints"], batch["paired_keypoints"]
                B = kps.shape[0]
                samples = self._sample_prior(model, kps, cross, n_samples,
                                             draws)
                gt = kps[:, div:]
                row = {k: float(v) for k, v in sequence_sample_metrics(
                    _3d(samples), _3d(gt)).items()}
                self_out = model(kps, cross, noise=draws.noise(
                    "self", model, B, self.device))[0].float()
                cross_out = model(kps, cross, transfer=True,
                                  noise=draws.noise("cross", model, B,
                                                    self.device))[0].float()
                row["self_recon_mse"] = float(torch.mean(
                    (self_out - gt) ** 2))
                row.update(cross_transfer_metrics(_3d(cross_out),
                                                  _3d(cross[:, div:])))
                rows.append(row)
                caches["orig"].append(gt)
                caches["prior"].append(samples[:, 0])
                caches["self"].append(self_out)
                caches["cross"].append(cross_out)
                if i == 0 and self.visualization:
                    self._write_eval_strips(samples, self_out, cross_out, gt,
                                            meta)
                if i + 1 >= max_batches or (self.debug and i >= 1):
                    print(f"mtvae inference: capped at {i + 1} batches "
                          f"(max_batches={max_batches}, debug={self.debug})")
                    break
        summary = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

        cat = {k: torch.cat(v) for k, v in caches.items()}
        n_iters = (DEBUG_POSTHOC_ITERS if self.debug else
                   int(cfg.get("metrics", {}).get("posthoc_iters", 2000)))
        summary.update(train_posthoc_classifiers(
            cat["orig"], {k: cat[k] for k in ("prior", "self", "cross")},
            n_iters=n_iters, draws=draws.posthoc, device=self.device))
        self.log(0, prefix="infer/", extra=summary, collected=False)
        return summary

    @staticmethod
    def _sample_prior(model, kps, cross, n_samples: int,
                      draws: InferenceDraws) -> torch.Tensor:
        """(B, n_samples, T - n_cond, K) float32 outputs from N(0, 1)
        codes, SAMPLE_ROWS sequences (whole samples of the batch) a
        forward."""
        B = kps.shape[0]
        per = max(1, min(n_samples, SAMPLE_ROWS // B))
        outs = []
        for s0 in range(0, n_samples, per):
            n = min(per, n_samples - s0)
            out = model(kps.repeat(n, 1, 1), cross.repeat(n, 1, 1),
                        sample_prior=True,
                        noise=draws.noise("prior", model, n * B,
                                          kps.device))[0]
            outs.append(out.float().reshape((n, B) + out.shape[1:]))
        return torch.cat(outs).transpose(0, 1)

    def _write_eval_strips(self, samples, self_out, cross_out, gt, meta,
                           n_vids: int = 2) -> None:
        """Per sequence ``mtvae_eval_<b>.png``: 3-D skeleton filmstrips of
        the first prior sample, the reconstruction, the transfer and the
        ground truth, one row each."""
        from ..viz.figures import sample_examples_grid
        from ..viz.videos import create_video_3d, save_png

        stats = meta.get("norm_stats")
        for b in range(min(n_vids, gt.shape[0])):
            grid = np.concatenate([sample_examples_grid(create_video_3d(
                visualize.to_world(seq, stats))[None], n_frames=6)
                for seq in (samples[b, 0], self_out[b], cross_out[b],
                            gt[b])], axis=0)
            save_png(grid, os.path.join(self.dirs["generated"],
                                        f"mtvae_eval_{b}.png"))

    # -- helpers ------------------------------------------------------------
    def _payload(self, state) -> dict:
        return {"state": state.state_dict(),
                "generator": self.generator.get_state()}

    def _load(self, state, payload) -> None:
        state.load_state_dict(payload["state"])
        self.generator.set_state(payload["generator"])

    def _prep_batch(self, batch):
        """The step's keypoint arrays as float32 tensors on the device
        (copied from pinned memory without blocking)."""
        out = {k: torch.from_numpy(np.asarray(batch[k], np.float32))
               for k in ("keypoints", "paired_keypoints")}
        if self.device.type != "cuda":
            return out
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in out.items()}
