"""The behavior_net experiment: the behavior cVAE, its flow prior, and the
inference protocol.

Counterpart of ``BehaviorNetExperiment`` in
``behavior_driven_video_synthesis_tpu/experiments/behavior_net.py``
(``run_training`` :116-273, ``_fallback_ckpt`` :393-417,
``_sample_rollouts`` :457-472, ``run_inference`` :475-557,
``_run_posthoc_protocol`` :560-713) on one device:

  stage 1: the cVAE with the adversarial regressor, the three probe
           classifiers and the gamma controller (``train/behavior.py``),
           ``n_epochs`` epochs; the net stops updating in the last 10
           epochs of a run longer than 10 while the probes go on;
           eval on (at most) two test batches after every
           ``logging.n_epoch_eval`` epochs; a checkpoint per epoch;
  stage 2: the latent flow over the frozen net's posteriors, 5 epochs
           (``n_epochs`` with ``training.only_flow``, ``-f``), with ActNorm
           set from a batch first and the KS p-value of the flow's codes
           logged after each epoch (``train/flow.py``);
  inference (``-m infer``): both stages restored; ADE/FDE/ASD/FSD/APD over
           ``n_samples`` prior and flow rollouts of each test sequence (one
           batched f32 rollout of B * n_samples sequences through
           ``generate_seq``, the decoder's plain loop, not the bf16
           rollout kernel), then the protocol of ``eval_protocol.py`` over
           cached rollouts; the summary is logged under ``infer/``.

``training.bf16`` runs all five modules' products in bf16 with float32
parameters and Adam state; losses are reduced in float32.
``training.only_flow`` skips stage 1 and trains the flow over this run's
cVAE checkpoint or, without one, the first sibling run's (``ckpt/<other
project>/reg_ckpt``) that loads; with none it raises.  ``--debug`` runs at
most 2 epochs and 1 flow epoch on at most 8 batches of data; inference
then samples two batches, caches one and trains the post-hoc probes 50
iterations.  Checkpoints (``core/checkpoint.py``) are ``<ckpt
dir>/reg_ckpt`` and ``<ckpt dir>/flow_ckpt``; a run restores both when
they exist and goes on from their steps, so a finished run runs no step.
After each stage the model is written as ``<ckpt dir>/behavior.npz`` (flax
trees ``net/...`` and, after the flow stage, ``flow/params/...`` and
``flow/buffers/...``) with ``behavior.json`` (the run's
``architecture``, ``data``, ``general`` and ``training`` config): the
files ``bdvs-generate-torch --behavior_params`` (and ``--from_dataset``)
reads.

Every draw of inference (the posterior noise, the prior and flow codes,
the post-hoc probes' initial weights and batches) comes from
:class:`InferenceDraws`, seeded from ``general.seed`` on the run's device.

``general.visualization`` (``-v``) writes the figures of
``experiments/visualize.py`` under the run's ``generated`` directory:
after each eval, ``e<epoch>_seq<i>_{transfer,samples}.mp4``,
``e<epoch>_latent_interp.mp4`` and ``e<epoch>_eval_grid.mp4`` of the
first batch of a test loader of its own; after ``-m infer``'s protocol,
``beta_embedding.png``, ``recon_error_hist.png`` and
``beta_nearest_neighbours.png``.  With ``logging.synth_params`` (``-s``, a
cvbae run of this package) and a dataset with cameras and norm
statistics, both also render RGB videos through
``BehaviorTransferPipeline`` (``<tag>rgb<i>.mp4``) and the paper figures
under ``generated/figures``.  Unlike the JAX experiment, nothing catches
an error of the render; a frame without an image file gets a zero
appearance, as there.  Every draw of the figures comes from a generator
of their own (seeded ``general.seed + 2``), so a run's training metrics
are the same with and without ``-v`` (the JAX figures take their keys
from the training key sequence).  ``metrics/sequence.py:
mse_euler_per_action`` is ported; like the JAX experiment, this one does
not call it.

Under data parallelism (``parallel/mesh.py``, a ``torchrun`` launch)
each rank trains on its rows of every global batch (the step's noise its
rows of the global batch's draw, gamma following the global KL, every
optimizer averaging its gradients over the ranks); ActNorm is set from the
global sample batch on every rank, as the JAX flow state is made from one
host batch; every rank evaluates the whole test batches; rank 0 alone
logs, writes checkpoints and ``behavior.npz`` and draws the figures.
``training.fsdp`` shards the flow's parameters and Adam moments over the
ranks (``parallel/sharding_rules.py``: every leaf, on its largest
dimension that the world size divides, else unevenly on dimension 0; JAX's
``training.fsdp_min_size`` is ignored) and saves full tensors; without a
process group it keeps the replicated layout, as the JAX experiment does
on one device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager, sibling_roles
from ..data.loader import prefetch_iter
from ..geometry.normalization import unnormalize
from ..metrics.sequence import sequence_sample_metrics
from ..models import convert
from ..models.behavior import ResidualBehaviorNet
from ..models.discriminators import SequenceDiscMichael
from ..models.flows import LatentFlow
from ..models.init import init_like_jax_
from ..models.probes import (ClassifierAction, ClassifierActionBeta,
                             RegressorFly)
from ..parallel import mesh, sharding_rules
from ..train.behavior import (BehaviorTrainState, make_behavior_eval_step,
                              make_behavior_train_step)
from ..train.flow import FlowTrainState, make_flow_train_step
from ..train.state import make_behavior_optimizers, make_flow_optimizer
from .base import Experiment
from .data_factory import build_sequence_data, normalize_action_labels
from . import visualize
from .eval_protocol import (PosthocDraws, action_transfer_scores,
                            cross_transfer_metrics, ks_test_flow_gaussianity,
                            mu_consistency_metrics, train_posthoc_classifiers)

N_FLOW_EPOCHS = 5
N_EVAL_BATCHES = 2
DEBUG_POSTHOC_ITERS = 50
N_RGB_VIDEOS = 2


class InferenceDraws:
    """The draws of inference from one generator on the device.
    ``normal(site, shape, device)`` draws the noise of one site:
    "eval_eps" (the eval step's posterior noise), "prior_z" and "flow_z"
    (the codes of the sampled rollouts), "cross_eps" (the posterior noise
    of the cross transfer, whose b also gives the flow's codes),
    "prior_b" (the prior rollout's b) and "flow_codes" (the flow
    rollout's codes); ``posthoc`` draws the post-hoc probes'.  A test
    hands in another run's values by overriding ``normal`` and
    ``posthoc``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.posthoc = PosthocDraws(generator)

    def normal(self, site: str, shape, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=device)


class BehaviorNetExperiment(Experiment):
    def __init__(self, config, dirs, device):
        super().__init__(config, dirs, device)
        tr = config.get("training", {})
        self.only_flow = bool(tr.get("only_flow", False))
        self.dtype = (torch.bfloat16 if bool(tr.get("bf16", False))
                      else torch.float32)
        self.seed = int(config.get("general", {}).get("seed", 42))
        # weights, and the steps' draws (checkpointed with the state)
        self.init_generator = torch.Generator(self.device).manual_seed(
            self.seed)
        self.generator = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self.visualization = bool(config.get("general", {}).get(
            "visualization", False))
        self.figure_generator = torch.Generator(self.device).manual_seed(
            self.seed + 2)
        # -s: the synthesis run's VUNet, loaded on first use; a run that
        # cannot be rendered is refused here, before any step
        self.synth_dir = config.get("logging", {}).get("synth_params")
        if self.synth_dir:
            visualize.synth_run_config(str(self.synth_dir))
        self._synth = None

    # -- construction -------------------------------------------------------
    def _build_models(self, n_kps: int, n_actions: int, seq_len: int):
        arch = self.config.get("architecture", {})
        hid = int(arch.get("dim_hidden_b", 1024))
        dev, dt = self.device, self.dtype
        modules = {
            "net": ResidualBehaviorNet(
                n_kps, hid, decoder_arch=str(arch.get("decoder_arch",
                                                      "lstm")),
                use_nin_dec=bool(arch.get("linear_in_decoder", False)),
                information_bottleneck=True, dtype=dt, device=dev),
            "regressor": RegressorFly(hid, n_kps, seq_len, dtype=dt,
                                      device=dev),
            "cls_action": ClassifierAction(n_kps, n_actions, dim=512,
                                           dtype=dt, device=dev),
            "cls_action2": SequenceDiscMichael(n_kps, seq_len - 1,
                                               layers=(2, 1, 1, 1),
                                               out_dim=n_actions, dtype=dt,
                                               device=dev),
            "cls_beta": ClassifierActionBeta(hid, n_actions, dtype=dt,
                                             device=dev),
        }
        for m in modules.values():
            init_like_jax_(m, self.init_generator)
        return modules

    def _build_flow(self) -> LatentFlow:
        arch = self.config.get("architecture", {})
        hid = int(arch.get("dim_hidden_b", 1024))
        flow = LatentFlow(
            hid, hid * int(arch.get("flow_mid_channels_factor", 2)),
            int(arch.get("flow_hidden_depth", 2)),
            int(arch.get("n_flows", 15)), device=self.device)
        return init_like_jax_(flow, self.init_generator)

    # -- training -----------------------------------------------------------
    def run_training(self):
        """Both stages (the flow alone with ``only_flow``); returns the
        modules, the train states and the path of the written
        behavior.npz."""
        cfg = self.config
        tr = cfg["training"]
        train_loader, meta = build_sequence_data(cfg, "train", shard=True)
        test_loader, _ = build_sequence_data(cfg, "test")
        seq_len = meta["seq_len"]
        n_epochs = int(tr["n_epochs"])
        n_flow_epochs = n_epochs if self.only_flow else N_FLOW_EPOCHS
        if self.debug:
            n_epochs, n_flow_epochs = min(n_epochs, 2), 1
        steps_per_epoch = max(1, len(train_loader))

        modules = self._build_models(meta["n_kps"], meta["n_actions"],
                                     seq_len)
        net = modules["net"]
        state = BehaviorTrainState(
            modules, make_behavior_optimizers(modules, tr,
                                              n_epochs * steps_per_epoch),
            gamma=torch.full((), float(tr.get("gamma_init", 0.0)),
                             device=self.device))
        # a new epoch of the loader, as the JAX experiment's sample batch is;
        # the global batch on every rank
        sample_batch = mesh.gather_rows(self._prep_batch(
            next(iter(train_loader)), meta))
        mgr, start_step = self.restore(
            "reg_ckpt", lambda p: self._load(state, p))
        if self.only_flow:
            if start_step == 0:
                self._fallback_ckpt(state)
            mesh.replicate(modules.values())
        else:
            self._train_cvae(state, train_loader, test_loader, meta, mgr,
                             start_step, n_epochs, steps_per_epoch)
            self.export_behavior(net)

        flow = self._build_flow()
        flow.initialize_(self._infer_b(net, sample_batch))
        fsdp = self._shard_flow(flow)
        fstate = FlowTrainState(flow, make_flow_optimizer(flow, tr))
        mesh.sync_gradients(fstate.optimizer)
        fmgr, fstart = self.restore(
            "flow_ckpt", lambda p: self._load_flow(fstate, p, fsdp))
        if not fsdp:
            mesh.replicate([flow])
        flow_step = make_flow_train_step(net)
        for epoch in range(fstart // steps_per_epoch, n_flow_epochs):
            for batch in prefetch_iter(iter(train_loader),
                                       lambda b: self._prep_batch(b, meta)):
                with mesh.batch_shard():
                    self.collect(flow_step(fstate, batch,
                                           generator=self.generator))
            with torch.no_grad():
                z, _ = flow(self._infer_b(net, sample_batch))
            self.log(fstate.step, prefix="flow/", extra={
                "flow_ks_p": ks_test_flow_gaussianity(z.cpu().numpy())})
            fmgr.save(fstate.step, self._flow_payload(fstate, fsdp))
        path = self.export_behavior(net, flow)
        return {"modules": modules, "state": state, "flow": flow,
                "flow_state": fstate, "behavior_params": path, "fsdp": fsdp,
                "n_params": {k: sum(p.numel() for p in m.parameters())
                             for k, m in dict(modules, flow=flow).items()}}

    def _train_cvae(self, state, train_loader, test_loader, meta, mgr,
                    start_step, n_epochs, steps_per_epoch):
        seq_len = meta["seq_len"]
        step_fn = make_behavior_train_step(
            self.config, seq_len, total_steps=max(1, (n_epochs - 10)
                                                  * steps_per_epoch))
        eval_fn = make_behavior_eval_step(state.modules["net"], seq_len)
        n_epoch_eval = int(self.config.get("logging", {}).get(
            "n_epoch_eval", 1))
        # the figures' batches come from a test loader of their own, so the
        # eval's batches are those of a run without them
        figure_loader = (build_sequence_data(self.config, "test")[0]
                         if self.visualization and mesh.is_main() else None)
        mesh.replicate(state.modules.values())
        for opt in state.optimizers.values():
            if isinstance(opt, torch.optim.Optimizer):
                mesh.sync_gradients(opt)
        for epoch in range(start_step // steps_per_epoch, n_epochs):
            enable = epoch < n_epochs - 10 or n_epochs <= 10
            for batch in prefetch_iter(iter(train_loader),
                                       lambda b: self._prep_batch(b, meta)):
                with mesh.batch_shard():
                    self.collect(step_fn(state, batch, enable,
                                         generator=self.generator))
            self.log(state.step, prefix="train/")
            if (epoch + 1) % n_epoch_eval == 0:
                self._run_eval(eval_fn, test_loader, meta, state.step)
                if figure_loader is not None:
                    self._epoch_figures(
                        state.modules["net"],
                        self._prep_batch(next(iter(figure_loader)), meta),
                        meta, tag=f"e{epoch:03d}_")
            mgr.save(state.step, self._payload(state))
        mgr.save(state.step, self._payload(state))   # no-op if saved

    def _fallback_ckpt(self, state) -> str:
        """Flow-only training without a cVAE save of its own: the newest
        save of the first sibling run whose modules load into ``state``
        (the JAX package tries every sibling ``reg_ckpt`` the same way).
        Returns its directory; raises when none loads."""
        for cand in sibling_roles(self.dirs["ckpt"], "reg_ckpt"):
            out = CheckpointManager(cand).restore_latest(map_location="cpu")
            if out is None:
                continue
            try:
                self._load_modules(state.modules, out[0])
            except (KeyError, RuntimeError):
                continue
            print(f"flow-only: using the cVAE checkpoint {cand} (step "
                  f"{out[1]})")
            return cand
        raise FileNotFoundError(
            f"flow-only training: no cVAE checkpoint (reg_ckpt) of this "
            f"run or of a sibling run under "
            f"{os.path.dirname(self.dirs['ckpt'])} loads into this model")

    # -- inference ----------------------------------------------------------
    def run_inference(self, n_samples: int = 50, max_batches: int = 50,
                      draws: Optional[InferenceDraws] = None
                      ) -> Dict[str, float]:
        """The inference protocol over the test split; returns the summary
        it logs under ``infer/``."""
        cfg = self.config
        test_loader, meta = build_sequence_data(cfg, "test")
        seq_len = meta["seq_len"]
        modules = self._build_models(meta["n_kps"], meta["n_actions"],
                                     seq_len)
        net = modules["net"]
        if draws is None:
            draws = InferenceDraws(torch.Generator(self.device).manual_seed(
                self.seed))
        # a new epoch of the loader where the JAX run takes its template
        # batch, so that both sample the same test batches
        next(iter(test_loader))
        out = CheckpointManager(os.path.join(
            self.dirs["ckpt"], "reg_ckpt")).restore_latest(
                map_location="cpu")
        if out is None:
            raise FileNotFoundError("no behavior checkpoint to evaluate")
        self._load_modules(modules, out[0])
        print(f"Restored reg_ckpt checkpoint at step {out[1]}")
        flow = None
        fout = CheckpointManager(os.path.join(
            self.dirs["ckpt"], "flow_ckpt")).restore_latest(
                map_location="cpu")
        if fout is not None:
            flow = self._build_flow()
            flow.load_state_dict(fout[0]["state"]["flow"])
            print(f"Restored flow_ckpt checkpoint at step {fout[1]}")
        for m in list(modules.values()) + ([flow] if flow else []):
            m.eval().requires_grad_(False)

        stats = meta["norm_stats"]
        hid = net.dim_hidden_b

        def to_3d(flat):
            if stats is not None:
                flat = unnormalize(flat, stats)
            return flat.reshape(flat.shape[:-1] + (-1, 3))

        results = {"prior": [], "flow": []}
        recon_mse = []
        eval_fn = make_behavior_eval_step(net, seq_len)
        with torch.no_grad():
            for i, batch in enumerate(test_loader):
                batch = self._prep_batch(batch, meta)
                kps = batch["keypoints"]
                B = kps.shape[0]
                m, _ = eval_fn(batch, eps=draws.normal(
                    "eval_eps", (B, hid), self.device))
                recon_mse.append(m["recon_mse"])
                seq_start, gt = kps[:, 0], to_3d(kps[:, 1:])
                for src, f in (("prior", None), ("flow", flow)):
                    if src == "flow" and flow is None:
                        continue
                    z = draws.normal(f"{src}_z", (B * n_samples, hid),
                                     self.device)
                    samples = self._sample_rollouts(net, seq_start, z,
                                                    n_samples, seq_len, f)
                    results[src].append({
                        k: float(v) for k, v in sequence_sample_metrics(
                            to_3d(samples), gt).items()})
                if i + 1 >= max_batches or (self.debug and i >= 1):
                    print(f"inference: sample-metric loop capped at {i + 1} "
                          f"batches (max_batches={max_batches}, "
                          f"debug={self.debug})")
                    break

        summary = {"recon_mse": float(np.mean(
            [float(v) for v in recon_mse]))}
        for src, rows in results.items():
            if rows:
                for k in rows[0]:
                    summary[f"{k}_{src}"] = float(
                        np.mean([r[k] for r in rows]))
        summary.update(self._run_posthoc_protocol(
            modules, flow, test_loader, meta, draws))
        self.log(0, prefix="infer/", extra=summary)
        return summary

    @staticmethod
    def _sample_rollouts(net, seq_start, z, n_samples: int, seq_len: int,
                         flow=None):
        """seq_start (B, K), codes z (B * n_samples, H) -> (B, n_samples,
        seq_len, K) rollouts, one batched rollout of the decoder's loop;
        through the flow's reverse first when ``flow`` is given."""
        B, K = seq_start.shape
        b = z if flow is None else flow.reverse(z)
        starts = seq_start.repeat_interleave(n_samples, dim=0)
        xs, _ = net.generate_seq(b, starts[:, None], seq_len)
        return xs.float().reshape(B, n_samples, seq_len, K)

    def _run_posthoc_protocol(self, modules, flow, test_loader, meta,
                              draws: InferenceDraws):
        """Caches rollouts per source and runs the protocol: ADE_c/FDE_c,
        mu consistency, the KS p-value of the flow's codes, the per-start
        post-hoc classifiers and regressor, and the CF scores.  The cache
        stops at ``metrics.max_cache`` sequences (25,000, the reference's
        cap), the probes train ``metrics.posthoc_iters`` iterations (2000);
        both caps are logged when they apply."""
        mcfg = self.config.get("metrics", {})
        max_cache = int(mcfg.get("max_cache", 25_000))
        seq_len = meta["seq_len"]
        net = modules["net"]
        hid = net.dim_hidden_b
        caches = {k: [] for k in ("orig", "prior", "cross", "self", "flow",
                                  "mu", "mu_re", "mu_rel", "z", "labels")}
        n_cached = 0
        with torch.no_grad():
            for batch in test_loader:
                batch = self._prep_batch(batch, meta)
                kps = batch["keypoints"]
                seq_s = kps[:, :-1]
                seq_t = batch["paired_keypoints"][:, :-1]
                B = kps.shape[0]
                # cross transfer: the source's behavior from the target's
                # start pose
                xc, _, b, mu, _, _ = net(seq_s, seq_t, seq_len,
                                         eps=draws.normal(
                                             "cross_eps", (B, hid),
                                             self.device))
                x_self, _ = net.generate_seq(mu, seq_s, seq_len)
                xp, _ = net.generate_seq(draws.normal(
                    "prior_b", (B, hid), self.device), seq_s, seq_len)
                caches["orig"].append(kps[:, 1:])
                caches["cross"].append(xc.float())
                caches["self"].append(x_self.float())
                caches["prior"].append(xp.float())
                caches["mu"].append(mu.float())
                caches["mu_re"].append(self._mu(net, xc))
                caches["mu_rel"].append(self._mu(net, seq_t))
                caches["labels"].append(batch["action"])
                if flow is not None:
                    caches["z"].append(flow(b.float())[0])
                    bflow = flow.reverse(draws.normal(
                        "flow_codes", (B, hid), self.device))
                    xf, _ = net.generate_seq(bflow, seq_s, seq_len)
                    caches["flow"].append(xf.float())
                n_cached += B
                if n_cached >= max_cache or self.debug:
                    print(f"inference: rollout cache capped at {n_cached} "
                          f"samples (max_cache={max_cache}, "
                          f"debug={self.debug})")
                    break

        cat = {k: torch.cat(v) for k, v in caches.items() if v}
        out = {}
        out.update(cross_transfer_metrics(cat["cross"], cat["orig"]))
        out.update(mu_consistency_metrics(
            *(cat[k].cpu().numpy() for k in ("mu", "mu_re", "mu_rel"))))
        if "z" in cat:
            out["flow_ks_p"] = ks_test_flow_gaussianity(
                cat["z"].cpu().numpy())
        fake_sets = {k: cat[k] for k in ("prior", "cross", "self", "flow")
                     if k in cat}
        n_iters = int(mcfg.get("posthoc_iters", 2000))
        if self.debug:
            n_iters = DEBUG_POSTHOC_ITERS
            print(f"inference: post-hoc probes capped at {n_iters} "
                  f"iterations (debug)")
        out.update(train_posthoc_classifiers(
            cat["orig"], fake_sets, mu=cat["mu"], n_iters=n_iters,
            draws=draws.posthoc, device=self.device))

        cls_action, cls_beta = modules["cls_action"], modules["cls_beta"]
        out.update(action_transfer_scores(cls_action, cat["cross"],
                                          cat["orig"], cat["labels"]))
        # CF_action: the action classifier on prior-sample rollouts;
        # CF_action_beta: the beta classifier on the inferred mu
        labels = cat["labels"].reshape(len(cat["mu"]), -1)[:, 0]
        with torch.no_grad():
            logits_p = cls_action(cat["prior"])[0].float()
            beta_logits = cls_beta(cat["mu"]).float()
        out["CF_action"] = float(torch.mean(
            (torch.argmax(logits_p, -1) == labels).float()))
        out["CF_action_beta"] = float(torch.mean(
            (torch.argmax(beta_logits, -1) == labels).float()))
        if self.visualization:
            self._infer_figures(net, cat, labels, test_loader, meta)
        return out

    # -- figures (-v, -s) ---------------------------------------------------
    def _epoch_figures(self, net, batch, meta, tag: str) -> Dict[str, str]:
        """The JAX experiment's per-eval figures of one test batch."""
        out_dir = self.dirs["generated"]
        seq_len, stats = meta["seq_len"], meta["norm_stats"]
        n_vids = int(self.config.get("logging", {}).get(
            "n_vid_to_generate", 2))
        paths = visualize.visualize_transfer3d(
            net, batch, out_dir, seq_len, norm_stats=stats, n_vids=n_vids,
            tag=tag, generator=self.figure_generator)
        paths["latent_interp"] = visualize.latent_interpolate_videos(
            net, batch, out_dir, seq_len, norm_stats=stats, tag=tag)
        paths["eval_grid"] = visualize.make_behavior_startpose_grid(
            net, batch, out_dir, seq_len, norm_stats=stats, tag=tag)
        paths.update(self._maybe_render_rgb(net, batch, meta, out_dir,
                                            tag=tag) or {})
        return paths

    def _infer_figures(self, net, cat, labels, test_loader, meta):
        """``-m infer``'s figures: the beta embedding by action, the
        per-sequence recon-error histogram, the nearest-neighbour figure
        and the RGB figures of the first test batch."""
        from ..viz.embedding import make_hist, plot_embedding
        from ..viz.figures import nearest_neighbour_figure

        out_dir = self.dirs["generated"]
        mu, labels = cat["mu"].cpu().numpy(), labels.cpu().numpy()
        plot_embedding(mu, labels, os.path.join(out_dir,
                                                "beta_embedding.png"))
        err = torch.sqrt(((cat["self"] - cat["orig"]) ** 2).sum(-1))
        make_hist(err.mean(-1).cpu().numpy(),
                  os.path.join(out_dir, "recon_error_hist.png"))
        nearest_neighbour_figure(
            mu, cat["orig"].cpu().numpy(), labels,
            os.path.join(out_dir, "beta_nearest_neighbours.png"))
        self._maybe_render_rgb(net, self._prep_batch(next(iter(
            test_loader)), meta), meta, out_dir, tag="infer_")

    def synth_vunet(self):
        """The ``-s`` run's VUNet and config (loaded once)."""
        if self._synth is None:
            self._synth = visualize.load_synth_params(str(self.synth_dir),
                                                      self.device)
        return self._synth

    def _maybe_render_rgb(self, net, batch, meta, out_dir: str,
                          tag: str = "") -> Optional[Dict[str, str]]:
        """With ``-s`` and a dataset with cameras and norm statistics, the
        first two sequences' behaviors as RGB videos from their own start
        poses, then the paper figures; None otherwise."""
        ds, stats = meta.get("dataset"), meta.get("norm_stats")
        if (not self.synth_dir or stats is None
                or "extrinsics_univ" not in getattr(ds, "datadict", {})):
            return None
        from ..pipeline import BehaviorTransferPipeline

        vunet, synth_cfg = self.synth_vunet()
        spatial = int((synth_cfg or {}).get("data", {}).get("spatial_size",
                                                            64))
        pipe = BehaviorTransferPipeline(
            net, vunet, ds.joint_model, stats.mean, stats.std,
            stats.dim_to_use, spatial_size=spatial,
            stickman_thickness=max(2.0, spatial / 64.0))
        n = min(N_RGB_VIDEOS, batch["keypoints"].shape[0])
        kps = batch["keypoints"].float()[:n]
        with torch.no_grad():
            mu = visualize._mu(net, kps[:, :-1])
        rows = []
        for i in range(n):
            try:
                rows.append(visualize.get_synth_input(ds, i, spatial))
            except (KeyError, FileNotFoundError) as e:
                print(f"synth input of frame {i} unavailable ({e!r}): a "
                      f"zero appearance")
                dd = ds.datadict
                rows.append((np.zeros((spatial, spatial, 3), np.float32),
                             *(np.asarray(dd[k][i], np.float32) for k in (
                                 "extrinsics_univ", "intrinsics_univ",
                                 "image_size"))))
        apps, extrs, intrs, sizes = (np.stack(a) for a in zip(*rows))
        paths = visualize.render_rgb_videos(
            pipe, mu, kps[:, 0], apps, extrs, intrs, sizes, out_dir,
            length=meta["seq_len"], tag=tag + "rgb",
            generator=self.figure_generator)
        paths.update(self._render_paper_figures(
            pipe, net, kps.cpu().numpy(), apps, extrs, intrs, sizes, meta,
            out_dir))
        return paths

    def _render_paper_figures(self, pipe, net, kps, apps, extrs, intrs,
                              sizes, meta, out_dir) -> Dict[str, str]:
        """Multi-camera enrollment, latent interpolation and diverse
        futures under ``<out_dir>/figures``."""
        fig_dir = os.path.join(out_dir, "figures")
        seq_len, g = meta["seq_len"], self.figure_generator
        try:
            cams = visualize.get_synth_input_all_cameras(
                meta.get("dataset"), spatial_size=apps.shape[1])
        except (KeyError, FileNotFoundError) as e:
            print(f"all-camera synth input unavailable ({e!r}); the "
                  f"enrollment figure falls back to the sampled inputs")
            cams = (apps, extrs, intrs, sizes)
        paths = {f"enroll_{k}": v for k, v in
                 visualize.make_enrollment_figures(
                     pipe, kps[0, :-1], kps[min(1, len(kps) - 1), 0], *cams,
                     fig_dir, length=seq_len, generator=g).items()}
        if len(kps) > 1:
            paths.update({f"interp_{k}": v for k, v in
                          visualize.latent_interpolate_eval_figures(
                              pipe, net, kps[0], kps[1], apps, extrs, intrs,
                              sizes, fig_dir, length=seq_len,
                              generator=g).items()})
            paths.update({f"samples_{k}": v for k, v in
                          visualize.sample_examples_single_figures(
                              pipe, net, kps[0], kps[1], apps[0], extrs[0],
                              intrs[0], sizes[0], fig_dir, length=seq_len,
                              use_flow=False, generator=g).items()})
        return paths

    # -- helpers ------------------------------------------------------------
    def _payload(self, state) -> dict:
        return {"state": state.state_dict(),
                "generator": self.generator.get_state()}

    def _load(self, state, payload) -> None:
        state.load_state_dict(payload["state"])
        self.generator.set_state(payload["generator"])

    def _shard_flow(self, flow) -> bool:
        """Shard the flow over the process group with ``training.fsdp``
        (JAX ``experiments/behavior_net.py:219-241``); True if it did."""
        tr = self.config.get("training", {})
        if not bool(tr.get("fsdp", False)):
            return False
        if not mesh.initialized():
            print("flow stage: training.fsdp requested but only one "
                  "device is visible — falling back to the replicated "
                  "layout")
            return False
        if "fsdp_min_size" in tr:
            print("flow stage: training.fsdp_min_size is ignored: every "
                  "flow leaf is sharded, since PyTorch's multi-tensor Adam "
                  "takes no mix of sharded and whole parameters")
        sharding_rules.shard_fsdp(flow)
        n = mesh.world_size()
        print(f"flow stage: FSDP sharding of flow params + optimizer "
              f"moments over {n} devices (each leaf on its largest "
              f"dimension that {n} divides, else unevenly on dimension 0)")
        return True

    def _flow_payload(self, fstate, fsdp: bool) -> dict:
        """The flow stage's save, full tensors also when sharded (every
        rank calls it)."""
        if not fsdp:
            return self._payload(fstate)
        msd, osd = sharding_rules.full_state(fstate.flow, fstate.optimizer)
        return {"state": {"flow": msd, "optimizer": osd,
                          "step": fstate.step},
                "generator": self.generator.get_state()}

    def _load_flow(self, fstate, payload, fsdp: bool) -> None:
        if not fsdp:
            return self._load(fstate, payload)
        sd = payload["state"]
        sharding_rules.load_full_state(fstate.flow, sd["flow"],
                                       fstate.optimizer, sd["optimizer"])
        fstate.step = int(sd["step"])
        self.generator.set_state(payload["generator"])

    @staticmethod
    def _load_modules(modules, payload) -> None:
        """The cVAE stage's modules of a ``reg_ckpt`` save, without its
        optimizers."""
        saved = payload["state"]["modules"]
        for k, m in modules.items():
            m.load_state_dict(saved[k])

    def _prep_batch(self, batch, meta):
        """The step's arrays as tensors on the device (copied from pinned
        memory without blocking)."""
        out = {"keypoints": np.asarray(batch["keypoints"], np.float32),
               "paired_keypoints": np.asarray(
                   batch.get("paired_keypoints", batch["keypoints"]),
                   np.float32),
               "action": normalize_action_labels(np.asarray(batch["action"]),
                                                 meta["action_offset"])}
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in out.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                        non_blocking=True)
                for k, v in out.items()}

    def _infer_b(self, net, batch):
        with torch.no_grad():
            b, _, _, _ = net.infer_b(batch["keypoints"].float()[:, :-1],
                                     generator=self.generator)
        return b.float()

    @staticmethod
    def _mu(net, seq):
        """The posterior mean of seq (the noise is not used)."""
        zeros = torch.zeros(seq.shape[0], net.dim_hidden_b,
                            device=seq.device)
        return net.infer_b(seq, eps=zeros)[1].float()

    def _run_eval(self, eval_fn, test_loader, meta, step: int) -> None:
        for i, batch in enumerate(test_loader):
            metrics, _ = eval_fn(self._prep_batch(batch, meta),
                                 generator=self.generator)
            self.collect(metrics)
            if i + 1 >= N_EVAL_BATCHES:
                print(f"eval: averaged over the first {N_EVAL_BATCHES} test "
                      f"batches (cap; remaining batches skipped)")
                break
        self.log(step, prefix="eval/")

    def export_behavior(self, net, flow=None) -> str:
        """Write behavior.npz + behavior.json (rank 0; every rank calls it,
        which gathers a sharded flow); returns the .npz path."""
        path = os.path.join(self.dirs["ckpt"], "behavior.npz")
        flow_sd = (sharding_rules.full_state(flow)[0] if flow is not None
                   else None)
        if not mesh.is_main():
            return path
        tree = {"net": convert.behavior_net_to_flax(net.state_dict())}
        if flow is not None:
            tree["flow"] = convert.latent_flow_to_flax(flow_sd)
        tmp = os.path.join(self.dirs["ckpt"], "behavior.tmp.npz")
        convert.save_flax_npz(tmp, tree)
        os.replace(tmp, path)
        with open(os.path.join(self.dirs["ckpt"], "behavior.json"), "w") as f:
            json.dump({k: self.config.get(k, {}) for k in
                       ("architecture", "data", "general", "training")}, f,
                      indent=1, default=list)
        return path
