"""Experiment base: run directories, device, metric log.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/base.py``
for one device: no mesh, no orbax checkpoints (resume is not ported yet).
Metrics are averaged over the steps since the last log line, printed and
appended to ``<log dir>/metrics.jsonl``.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import torch


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

    def log(self, step: int, prefix: str = "train/") -> Dict[str, float]:
        """Average the collected metrics, print them and append them to
        the metric log; returns the averages."""
        if not self._window:
            return {}
        keys = self._window[0].keys()
        avg = {f"{prefix}{k}": float(torch.stack(
            [m[k].float() for m in self._window]).mean()) for k in keys}
        self._window = []
        with open(os.path.join(self.dirs["log"], "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **avg}) + "\n")
        print(f"step {step}: " + ", ".join(
            f"{k[len(prefix):]} {v:.5g}" for k, v in avg.items()))
        return avg

    def run_training(self):
        raise NotImplementedError
