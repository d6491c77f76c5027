"""Experiment base: run directories, device, metric log, checkpoints.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/base.py``
for one device: no mesh.  Metrics are averaged over the steps since the
last log line, printed and appended to ``<log dir>/metrics.jsonl``.
Checkpoints of a role live in ``<ckpt dir>/<role>`` (``core/checkpoint.py``)
and are restored whenever they exist, as the JAX experiments do.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..core.checkpoint import CheckpointManager


class Experiment:
    def __init__(self, config: dict, dirs: Dict[str, str], device):
        self.config = config
        self.dirs = dirs
        self.device = torch.device(device)
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        self.debug = bool(config.get("general", {}).get("debug", False))
        self._window = []

    def collect(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Keep a step's metrics (device tensors: no sync here)."""
        self._window.append(metrics)

    def log(self, step: int, prefix: str = "train/",
            extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Average the collected metrics, add ``extra``, print them and
        append them to the metric log; returns the averages."""
        if not self._window and not extra:
            return {}
        keys = self._window[0].keys() if self._window else ()
        avg = {f"{prefix}{k}": float(torch.stack(
            [m[k].float() for m in self._window]).mean()) for k in keys}
        avg.update({f"{prefix}{k}": float(v)
                    for k, v in (extra or {}).items()})
        self._window = []
        with open(os.path.join(self.dirs["log"], "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **avg}) + "\n")
        print(f"step {step}: " + ", ".join(
            f"{k[len(prefix):]} {v:.5g}" for k, v in avg.items()))
        return avg

    def restore(self, role: str, load) -> Tuple[CheckpointManager, int]:
        """The role's checkpoint manager and the step of its newest save,
        which ``load(payload)`` has restored (0 and no call without
        one)."""
        mgr = CheckpointManager(os.path.join(self.dirs["ckpt"], role))
        out = mgr.restore_latest(map_location="cpu")
        if out is None:
            return mgr, 0
        payload, step = out
        load(payload)
        print(f"Restored {role} checkpoint at step {step}")
        return mgr, step

    def run_training(self):
        raise NotImplementedError
