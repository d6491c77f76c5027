"""The metric log of a training run.

Counterpart of ``MetricLogger`` in
``behavior_driven_video_synthesis_tpu/core/logging_util.py``: one JSON
line ``{"step", "time", <prefix><name>: value, ...}`` a call, appended to
``<log dir>/metrics.jsonl``, and forwarded to wandb when
``logging.use_wandb`` is set and wandb imports.  The JAX package's
``RunningAverage`` (a window of the last 100 sampled steps) has no
counterpart: ``Experiment.log`` averages every step since its last line
(ROADMAP, "Recorded").
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, project: Optional[str] = None,
                 use_wandb: bool = False):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project or "bdvs_torch",
                           dir=self.log_dir, resume="allow")
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 — wandb is optional
                print(f"wandb not used: {e}")

    def log(self, metrics: Dict[str, float], step: int,
            prefix: str = "") -> Dict[str, float]:
        """Append one line of scalars; returns them by logged name."""
        clean = {prefix + k: float(v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), "time": time.time(),
                                **clean}) + "\n")
        if self._wandb is not None:
            self._wandb.log(clean, step=int(step))
        return clean
