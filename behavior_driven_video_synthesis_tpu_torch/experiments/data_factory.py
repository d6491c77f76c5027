"""The keypoint-sequence data of the behavior experiment.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
data_factory.py`` (``SyntheticLoaderAdapter``, ``normalize_action_labels``
and ``build_sequence_data``, :17-110): ``dataset: synthetic``, and the
Human3.6M sequence path (``human3.6m``, ``human36m``, ``h36m``, and
``h36m_synthetic``, which fills the dataset from
``data/synthetic.py:synthetic_h36m_columns``) through a
``SequenceSampler`` over an unseeded ``RandomSampler`` and a ``Loader``,
as the JAX factory builds it.  One difference: for Human3.6M ``n_actions``
is the span of the action ids, not their count (ROADMAP C5).

With ``shard`` under data parallelism (``parallel/mesh.py``) the loader
yields this rank's rows of each global batch: the synthetic batches are
sliced, the Human3.6M loader fetches the rank's items alone, its samplers
seeded with ``general.seed`` on every rank so that all draw one order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..data.human36m import Human36mDataset
from ..data.loader import Loader
from ..data.samplers import RandomSampler, SequenceSampler, ShardSampler
from ..data.synthetic import (SyntheticSequenceDataset,
                              synthetic_h36m_columns)
from ..parallel import mesh

H36M_NAMES = ("human3.6m", "human36m", "h36m", "h36m_synthetic")


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


def build_sequence_data(config: dict, mode: str = "train",
                        shard: bool = False) -> Tuple[object, Dict]:
    """(loader, meta) of a run config's keypoint-sequence data; ``mode``
    "train" or "test" (for synthetic data another seed and 512 sequences
    by default; for Human3.6M the test split); with ``shard`` the rank's
    rows of each batch under data parallelism."""
    shard = shard and mesh.world_size() > 1
    dcfg = config.get("data", {})
    batch_size = int(config["training"]["batch_size"])
    name = str(dcfg.get("dataset", "synthetic")).lower()
    seq_length = tuple(dcfg.get("seq_length", (50, 51)))
    if name in H36M_NAMES:
        return _human36m_data(config, mode, name, seq_length, batch_size,
                              shard)
    if name != "synthetic":
        raise ValueError(f"unsupported sequence dataset: {name}")
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
    loader = SyntheticLoaderAdapter(ds, batch_size)
    return (mesh.ShardedBatches(loader) if shard else loader), meta


def _human36m_data(config: dict, mode: str, name: str, seq_length,
                   batch_size: int, shard: bool) -> Tuple[Loader, Dict]:
    dcfg = config.get("data", {})
    kwargs = {k: v for k, v in dcfg.items()
              if k not in ("dataset", "seq_length")}
    kwargs.setdefault("label_transfer", True)
    kwargs.setdefault("keypoint_type", "keypoints_3d_world")
    ds = Human36mDataset(
        transforms=None, data_keys=["keypoints", "paired_keypoints",
                                    "action", "sample_ids",
                                    "paired_sample_ids"],
        seq_length=seq_length,
        mode=mode, debug=config.get("general", {}).get("debug", False),
        **kwargs)
    if name == "h36m_synthetic":
        ds.populate_from_arrays(synthetic_h36m_columns(
            n_frames_per_video=int(dcfg.get("n_frames_per_video", 120)),
            seed=0 if mode == "train" else 1))
    if len(ds) == 0:
        raise FileNotFoundError(
            f"Human3.6M annot_export.h5 not found under "
            f"{dcfg.get('datapath')}: use dataset: synthetic or "
            f"h36m_synthetic, or provide the processed dataset")
    # unseeded as in JAX, but alike on every rank under data parallelism
    kw = ({"seed": int(config.get("general", {}).get("seed", 42))}
          if shard else {})
    sampler = SequenceSampler(ds, RandomSampler(ds, **kw), batch_size,
                              drop_last=True, **kw)
    if shard:
        sampler = ShardSampler(sampler, mesh.rank(), mesh.world_size())
    loader = Loader(ds, sampler,
                    num_workers=int(dcfg.get("n_data_workers", 8)))
    # the heads span the label range: the JAX factory counts the distinct
    # actions, which is fewer when the ids have gaps (h36m_synthetic's 2,
    # 4, 5), and its probes' losses are then NaN (ROADMAP C5)
    action = ds.datadict["action"]
    meta = {"n_kps": len(ds.dim_to_use),
            "n_actions": int(action.max() - action.min()) + 1,
            "dataset": ds, "norm_stats": ds.norm_stats,
            "seq_len": ds.seq_length[0],
            "action_offset": int(action.min())}
    return loader, meta
