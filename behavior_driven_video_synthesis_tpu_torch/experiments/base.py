"""Experiment base: run directories, device, metric log, checkpoints.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/base.py``.
Metrics are averaged over the steps since the last log line, printed and
appended to ``<log dir>/metrics.jsonl`` through
``core/logging_util.py:MetricLogger``.  Checkpoints of a role live in
``<ckpt dir>/<role>`` (``core/checkpoint.py``) and are restored whenever
they exist, as the JAX experiments do, unless ``general.fresh_start`` (the
answer "n" to the CLI's resume prompt) has the role's old saves deleted
first.

Under a process group (``parallel/mesh.py``; JAX shards the batch over a
``("data",)`` mesh here) every rank trains on its rows of each global
batch and restores every checkpoint; a log line averages the ranks'
metrics, and rank 0 alone prints and writes it and writes checkpoints
(:meth:`restore` gives the other ranks a manager that reads only).
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from ..core.checkpoint import CheckpointManager
from ..core.logging_util import MetricLogger
from ..parallel import mesh


class ReadingCheckpointManager(CheckpointManager):
    """A role's saves as a rank other than 0 sees them: it restores them
    and writes none."""

    def save(self, step: int, state) -> bool:
        return False


class Experiment:
    def __init__(self, config: dict, dirs: Dict[str, str], device):
        self.config = config
        self.dirs = dirs
        self.device = torch.device(device)
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        general = config.get("general", {})
        self.debug = bool(general.get("debug", False))
        self.logger = MetricLogger(
            dirs["log"], project=general.get("project_name"),
            use_wandb=bool(config.get("logging", {}).get("use_wandb",
                                                         False))
        ) if mesh.is_main() else None
        self._window = []

    def collect(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Keep a step's metrics (device tensors: no sync here)."""
        self._window.append(metrics)

    def log(self, step: int, prefix: str = "train/",
            extra: Optional[Dict[str, float]] = None,
            collected: bool = True) -> Dict[str, float]:
        """Average the collected metrics (not with ``collected=False``,
        which leaves them for a later line) over the steps and the ranks,
        add ``extra``, print them and append them to the metric log (rank
        0); returns the averages.  Every rank calls it."""
        window = self._window if collected else []
        if not window and not extra:
            return {}
        keys = list(window[0].keys()) if window else []
        avg = {}
        if keys:
            means = torch.stack([
                torch.stack([m[k].float().to(self.device)
                             for m in window]).mean() for k in keys])
            avg = dict(zip(keys, mesh.mean_over_ranks(means).tolist()))
        avg.update({k: float(v) for k, v in (extra or {}).items()})
        if collected:
            self._window = []
        if self.logger is None:
            return {prefix + k: v for k, v in avg.items()}
        avg = self.logger.log(avg, step, prefix=prefix)
        print(f"step {step}: " + ", ".join(
            f"{k[len(prefix):]} {v:.5g}" for k, v in avg.items()))
        return avg

    def restore(self, role: str, load) -> Tuple[CheckpointManager, int]:
        """The role's checkpoint manager and the step of its newest save,
        which ``load(payload)`` has restored (0 and no call without
        one)."""
        directory = os.path.join(self.dirs["ckpt"], role)
        if (self.config.get("general", {}).get("fresh_start", False)
                and mesh.is_main() and os.path.isdir(directory)
                and os.listdir(directory)):
            print(f"fresh start: clearing stale '{role}' checkpoints under "
                  f"{directory}")
            shutil.rmtree(directory)
        mesh.barrier()
        mgr = (CheckpointManager if mesh.is_main()
               else ReadingCheckpointManager)(directory)
        out = mgr.restore_latest(map_location="cpu")
        if out is None:
            return mgr, 0
        payload, step = out
        load(payload)
        print(f"Restored {role} checkpoint at step {step}")
        return mgr, step

    def run_training(self):
        raise NotImplementedError
