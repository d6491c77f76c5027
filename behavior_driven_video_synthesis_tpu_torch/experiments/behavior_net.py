"""The behavior_net experiment: the behavior cVAE, then its flow prior.

Counterpart of ``BehaviorNetExperiment.run_training``
(``behavior_driven_video_synthesis_tpu/experiments/behavior_net.py:
116-273``) on one device:

  stage 1: the cVAE with the adversarial regressor, the three probe
           classifiers and the gamma controller (``train/behavior.py``),
           ``n_epochs`` epochs; the net stops updating in the last 10
           epochs of a run longer than 10 while the probes go on;
           eval on (at most) two test batches after every
           ``logging.n_epoch_eval`` epochs; a checkpoint per epoch;
  stage 2: the latent flow over the frozen net's posteriors, 5 epochs,
           with ActNorm set from a batch first and the KS p-value of the
           flow's codes logged after each epoch (``train/flow.py``).

``--debug`` runs at most 2 epochs and 1 flow epoch on at most 8 batches
of data.  Checkpoints (``core/checkpoint.py``) are ``<ckpt
dir>/reg_ckpt`` and ``<ckpt dir>/flow_ckpt``; a run restores both when
they exist and goes on from their steps, so a finished run runs no step.
After each stage the model is written as ``<ckpt dir>/behavior.npz`` (flax
trees ``net/...`` and, after the flow stage, ``flow/params/...`` and
``flow/buffers/...``) with ``behavior.json`` (the run's
``architecture``, ``data`` and ``general`` config): the files
``bdvs-generate-torch --behavior_params`` reads.

Not ported yet: ``general.visualization``, ``training.bf16`` and
``training.only_flow`` (ROADMAP A6b), ``training.fsdp`` (A14), and the
inference protocol (``-m infer``, A6b), for which ``main.py`` exits 2.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.loader import prefetch_iter
from ..models import convert
from ..models.behavior import ResidualBehaviorNet
from ..models.discriminators import SequenceDiscMichael
from ..models.flows import LatentFlow
from ..models.init import init_like_jax_
from ..models.probes import (ClassifierAction, ClassifierActionBeta,
                             RegressorFly)
from ..train.behavior import (BehaviorTrainState, make_behavior_eval_step,
                              make_behavior_train_step)
from ..train.flow import FlowTrainState, make_flow_train_step
from ..train.state import make_behavior_optimizers, make_flow_optimizer
from .base import Experiment
from .data_factory import build_sequence_data, normalize_action_labels
from .eval_protocol import ks_test_flow_gaussianity

N_FLOW_EPOCHS = 5
N_EVAL_BATCHES = 2
_UNPORTED = (("general", "visualization", "A6b"), ("training", "bf16", "A6b"),
             ("training", "only_flow", "A6b"), ("training", "fsdp", "A14"))


class BehaviorNetExperiment(Experiment):
    def __init__(self, config, dirs, device):
        super().__init__(config, dirs, device)
        unported = [f"{sec}.{key} (ROADMAP {item})"
                    for sec, key, item in _UNPORTED
                    if config.get(sec, {}).get(key, False)]
        if unported:
            raise NotImplementedError(f"{', '.join(unported)}: not ported "
                                      "yet")
        seed = int(config.get("general", {}).get("seed", 42))
        # weights, and the steps' draws (checkpointed with the state)
        self.init_generator = torch.Generator(self.device).manual_seed(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)

    # -- construction -------------------------------------------------------
    def _build_models(self, n_kps: int, n_actions: int, seq_len: int):
        arch = self.config.get("architecture", {})
        hid = int(arch.get("dim_hidden_b", 1024))
        dev = self.device
        modules = {
            "net": ResidualBehaviorNet(
                n_kps, hid, decoder_arch=str(arch.get("decoder_arch",
                                                      "lstm")),
                use_nin_dec=bool(arch.get("linear_in_decoder", False)),
                information_bottleneck=True, device=dev),
            "regressor": RegressorFly(hid, n_kps, seq_len, device=dev),
            "cls_action": ClassifierAction(n_kps, n_actions, dim=512,
                                           device=dev),
            "cls_action2": SequenceDiscMichael(n_kps, seq_len - 1,
                                               layers=(2, 1, 1, 1),
                                               out_dim=n_actions,
                                               device=dev),
            "cls_beta": ClassifierActionBeta(hid, n_actions, device=dev),
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
        """Both stages; returns the modules, the train states and the path
        of the written behavior.npz."""
        cfg = self.config
        tr = cfg["training"]
        train_loader, meta = build_sequence_data(cfg, "train")
        test_loader, _ = build_sequence_data(cfg, "test")
        seq_len = meta["seq_len"]
        n_epochs = int(tr["n_epochs"])
        if self.debug:
            n_epochs = min(n_epochs, 2)
        steps_per_epoch = max(1, len(train_loader))

        modules = self._build_models(meta["n_kps"], meta["n_actions"],
                                     seq_len)
        net = modules["net"]
        state = BehaviorTrainState(
            modules, make_behavior_optimizers(modules, tr,
                                              n_epochs * steps_per_epoch),
            gamma=torch.full((), float(tr.get("gamma_init", 0.0)),
                             device=self.device))
        # a new epoch of the loader, as the JAX experiment's sample batch is
        sample_batch = self._prep_batch(next(iter(train_loader)), meta)
        mgr, start_step = self.restore(
            "reg_ckpt", lambda p: self._load(state, p))
        step_fn = make_behavior_train_step(
            cfg, seq_len, total_steps=max(1, (n_epochs - 10)
                                          * steps_per_epoch))
        eval_fn = make_behavior_eval_step(net, seq_len)
        n_epoch_eval = int(cfg.get("logging", {}).get("n_epoch_eval", 1))
        for epoch in range(start_step // steps_per_epoch, n_epochs):
            enable = epoch < n_epochs - 10 or n_epochs <= 10
            for batch in prefetch_iter(iter(train_loader),
                                       lambda b: self._prep_batch(b, meta)):
                self.collect(step_fn(state, batch, enable,
                                     generator=self.generator))
            self.log(state.step, prefix="train/")
            if (epoch + 1) % n_epoch_eval == 0:
                self._run_eval(eval_fn, test_loader, meta, state.step)
            mgr.save(state.step, self._payload(state))
        mgr.save(state.step, self._payload(state))   # no-op if saved
        self.export_behavior(net)

        flow = self._build_flow()
        flow.initialize_(self._infer_b(net, sample_batch))
        fstate = FlowTrainState(flow, make_flow_optimizer(flow, tr))
        fmgr, fstart = self.restore(
            "flow_ckpt", lambda p: self._load(fstate, p))
        flow_step = make_flow_train_step(net)
        n_flow_epochs = 1 if self.debug else N_FLOW_EPOCHS
        for epoch in range(fstart // steps_per_epoch, n_flow_epochs):
            for batch in prefetch_iter(iter(train_loader),
                                       lambda b: self._prep_batch(b, meta)):
                self.collect(flow_step(fstate, batch,
                                       generator=self.generator))
            with torch.no_grad():
                z, _ = flow(self._infer_b(net, sample_batch))
            self.log(fstate.step, prefix="flow/", extra={
                "flow_ks_p": ks_test_flow_gaussianity(z.cpu().numpy())})
            fmgr.save(fstate.step, self._payload(fstate))
        path = self.export_behavior(net, flow)
        return {"modules": modules, "state": state, "flow": flow,
                "flow_state": fstate, "behavior_params": path,
                "n_params": {k: sum(p.numel() for p in m.parameters())
                             for k, m in dict(modules, flow=flow).items()}}

    # -- helpers ------------------------------------------------------------
    def _payload(self, state) -> dict:
        return {"state": state.state_dict(),
                "generator": self.generator.get_state()}

    def _load(self, state, payload) -> None:
        state.load_state_dict(payload["state"])
        self.generator.set_state(payload["generator"])

    def _prep_batch(self, batch, meta):
        """The step's arrays as tensors on the device (copied from pinned
        memory without blocking)."""
        out = {"keypoints": np.asarray(batch["keypoints"], np.float32),
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
        return b

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
        """Write behavior.npz + behavior.json; returns the .npz path."""
        tree = {"net": convert.behavior_net_to_flax(net.state_dict())}
        if flow is not None:
            tree["flow"] = convert.latent_flow_to_flax(flow.state_dict())
        path = os.path.join(self.dirs["ckpt"], "behavior.npz")
        tmp = os.path.join(self.dirs["ckpt"], "behavior.tmp.npz")
        convert.save_flax_npz(tmp, tree)
        os.replace(tmp, path)
        with open(os.path.join(self.dirs["ckpt"], "behavior.json"), "w") as f:
            json.dump({k: self.config.get(k, {}) for k in
                       ("architecture", "data", "general")}, f, indent=1,
                      default=list)
        return path
