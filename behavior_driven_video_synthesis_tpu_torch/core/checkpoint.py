"""Checkpoints of a training run: one file per save, the newest kept.

Counterpart of ``behavior_driven_video_synthesis_tpu/core/checkpoint.py``
(orbax there).  A role ("reg_ckpt", "flow_ckpt") is a directory of
``step_<step>.pt`` files, each one ``torch.save`` of a dict of state dicts
(modules, optimizers, lr schedulers, generators) and scalars.  A save is
written to a temporary file and committed with ``os.replace``, so a crash
mid-write leaves the previous save as the newest.  Saves hold tensors,
numbers, strings and containers only, and load with ``weights_only``.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """One role's saves, indexed by step; the last ``max_to_keep`` stay."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as the save of ``step``; False if that step is
        already on disk (a save is never overwritten)."""
        step = int(step)
        if step in self.all_steps():
            return False
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore_latest(self, map_location=None
                       ) -> Optional[Tuple[Any, int]]:
        """(state, step) of the newest save, or None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location=map_location,
                           weights_only=True)
        return state, step
