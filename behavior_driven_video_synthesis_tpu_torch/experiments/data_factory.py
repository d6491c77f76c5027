"""The keypoint-sequence data of the behavior experiment.

Counterpart of the synthetic branch of
``behavior_driven_video_synthesis_tpu/experiments/data_factory.py``
(``SyntheticLoaderAdapter``, ``normalize_action_labels`` and
``build_sequence_data`` for ``dataset: synthetic``).  The Human3.6M
datasets are not ported yet (ROADMAP A6b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..data.synthetic import SyntheticSequenceDataset


class SyntheticLoaderAdapter:
    """Batches of a SyntheticSequenceDataset in a new order each epoch.

    Every ``iter()`` starts a new epoch (seed ``seed + epoch``, epochs
    counted from 1), also one that takes a single batch: an experiment
    keeps the JAX experiment's batches only by calling ``iter()`` exactly
    where that one does."""

    def __init__(self, ds: SyntheticSequenceDataset, batch_size: int,
                 seed: int = 0):
        self.ds = ds
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.ds) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        return self.ds.batches(self.batch_size,
                               seed=self.seed + self._epoch)


def normalize_action_labels(action: np.ndarray,
                            offset: Optional[int] = None) -> np.ndarray:
    """(B,) or (B, T) raw labels -> (B,) 0-based int labels (Human3.6M
    action ids start at 2)."""
    if action.ndim == 2:
        action = action[:, 0]
    if offset is None:
        offset = int(action.min())
    return (action - offset).astype(np.int64)


def build_sequence_data(config: dict, mode: str = "train"
                        ) -> Tuple[SyntheticLoaderAdapter, Dict]:
    """(loader, meta) of a run config's keypoint-sequence data; ``mode``
    "train" or "test" (another seed, 512 sequences by default)."""
    dcfg = config.get("data", {})
    batch_size = int(config["training"]["batch_size"])
    name = str(dcfg.get("dataset", "synthetic")).lower()
    if name != "synthetic":
        raise ValueError(f"dataset {name!r} is not ported yet (the Human3.6M "
                         "sequence path is ROADMAP A6b); use dataset: "
                         "synthetic")
    seq_length = tuple(dcfg.get("seq_length", (50, 51)))
    n_kps = int(dcfg.get("n_kps", 51))
    n_actions = int(dcfg.get("n_actions", 10))
    n_samples = int(dcfg.get("n_samples", 2048 if mode == "train" else 512))
    if config.get("general", {}).get("debug", False):
        n_samples = min(n_samples, 8 * batch_size)
    ds = SyntheticSequenceDataset(
        n_samples=n_samples, seq_length=seq_length[0] + 1, n_kps=n_kps,
        n_actions=n_actions, seed=0 if mode == "train" else 1)
    meta = {"n_kps": n_kps, "n_actions": n_actions, "dataset": ds,
            "norm_stats": None, "seq_len": seq_length[0],
            "action_offset": 0}
    return SyntheticLoaderAdapter(ds, batch_size), meta
