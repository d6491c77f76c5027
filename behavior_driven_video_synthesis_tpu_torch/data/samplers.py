"""Samplers: index streams and batching policies over a BaseDataset.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/samplers.py:
26-181``, pure numpy, with the same ``np.random.RandomState`` draws:

  * SequenceSampler    — per batch, one seq_len shared by all items,
                         yielded as [idx, seq_len] pairs; resamples the
                         dataset's map_ids each epoch when paired keys are
                         requested
  * PerPersonSampler   — reshuffles per-person appearance map_ids each
                         epoch, optionally multinomial over a sampling
                         distribution
  * RandomSampler      — a permutation per epoch
  * ReconstructionSampler — map_ids = identity
  * WeightedDataSampler — motion-magnitude-proportional sampling
  * EntireSequenceSampler — one batch of evenly spaced anchors per video
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class PerPersonSampler:
    def __init__(self, dataset, sampling_dist: Optional[np.ndarray] = None,
                 seed: Optional[int] = None):
        if getattr(dataset, "person_ids", None) is None or \
                len(dataset.person_ids) == 0:
            raise ValueError("dataset.person_ids must be non-empty")
        self.dataset = dataset
        self.sampling_dist = sampling_dist
        self.rng = np.random.RandomState(seed)
        self._randomize_dataset()

    def __len__(self) -> int:
        return len(self.dataset)

    def _randomize_dataset(self):
        for pid in self.dataset.person_ids:
            valid = np.nonzero(self.dataset.datadict["p_ids"] == pid)[0]
            shuffled = valid.copy()
            self.rng.shuffle(shuffled)
            self.dataset.datadict["map_ids"][valid] = shuffled

    def __iter__(self) -> Iterator[int]:
        self._randomize_dataset()
        n = len(self.dataset)
        if self.sampling_dist is None:
            return iter(self.rng.permutation(n).tolist())
        p = np.asarray(self.sampling_dist, np.float64)
        p = p / p.sum()
        return iter(self.rng.choice(n, n, replace=True, p=p).tolist())


class RandomSampler:
    def __init__(self, dataset, seed: Optional[int] = None):
        self.dataset = dataset
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        return iter(self.rng.permutation(len(self.dataset)).tolist())


class ReconstructionSampler:
    """Identity appearance mapping: reconstruct the same person/frame."""

    def __init__(self, dataset, seed: Optional[int] = None):
        self.dataset = dataset
        self.rng = np.random.RandomState(seed)
        self._set_identity()

    def _set_identity(self):
        self.dataset.datadict["map_ids"] = np.arange(len(self.dataset))

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        self._set_identity()
        return iter(self.rng.permutation(len(self.dataset)).tolist())


class WeightedDataSampler:
    def __init__(self, dataset, motion_sampling: bool = False,
                 alpha_data: float = 1.0, seed: Optional[int] = None):
        self.dataset = dataset
        self.motion_sampling = motion_sampling
        self.alpha_data = alpha_data
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.dataset)

    def _get_motion_weights(self) -> np.ndarray:
        kps = self.dataset.datadict["keypoints"]
        lag = self.dataset.seq_length[1] * self.dataset.sequential_frame_lag
        n = len(self.dataset)
        w = np.zeros(n)
        valid = np.arange(n - lag) if lag < n else np.asarray([], np.int64)
        if valid.size:
            diff = kps[valid + lag] - kps[valid]
            w[valid] = np.linalg.norm(
                diff.reshape(valid.size, -1), axis=1) ** self.alpha_data
        s = w.sum()
        return w / s if s > 0 else np.full(n, 1.0 / n)

    def __iter__(self):
        n = len(self.dataset)
        if self.motion_sampling:
            p = self._get_motion_weights()
            return iter(self.rng.choice(n, n, replace=True, p=p).tolist())
        return iter(self.rng.permutation(n).tolist())


class EntireSequenceSampler:
    """Yields one batch per video: evenly spaced anchors across the video."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.v_ids = np.unique(dataset.datadict["v_ids"])

    def __len__(self):
        return len(self.v_ids)

    def __iter__(self):
        for v in self.v_ids:
            start = self.dataset.sequence_start_ids[int(v)]
            end = self.dataset.sequence_end_ids[int(v)]
            anchors = np.linspace(start, end, self.batch_size,
                                  dtype=np.int64)
            yield anchors.tolist()


class ShardSampler:
    """This rank's slice of each batch of a batch sampler, for data
    parallelism (``parallel/mesh.py``): every rank draws the same global
    order (samplers seeded alike) and fetches only its own rows.  A batch
    that does not split evenly raises."""

    def __init__(self, batch_sampler, rank: int, world_size: int):
        self.batch_sampler = batch_sampler
        self.rank, self.world_size = rank, world_size

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for batch in self.batch_sampler:
            if len(batch) % self.world_size:
                raise ValueError(f"batch of {len(batch)} items does not "
                                 f"split over {self.world_size} ranks")
            per = len(batch) // self.world_size
            yield batch[self.rank * per:(self.rank + 1) * per]


class SequenceSampler:
    """Batch sampler yielding lists of [idx, seq_len] with one seq_len per
    batch (keeps shapes static within a batch for scan/jit)."""

    def __init__(self, dataset, sampler, batch_size: int,
                 drop_last: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.seq_lengths = dataset.seq_length
        self.randomize_map_ids = any(
            k in dataset.datakeys
            for k in ("paired_keypoints", "paired_sample_ids",
                      "paired_change"))

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _draw_len(self) -> int:
        lo, hi = self.seq_lengths
        if hi <= lo:  # single-frame datasets use seq_length=(0, 0)
            return int(lo)
        return int(self.rng.randint(lo, hi))  # [lo, hi) like the reference

    def __iter__(self) -> Iterator[List[List[int]]]:
        if self.randomize_map_ids:
            self.dataset.resample_map_ids()
        batch: List[List[int]] = []
        seq_len = self._draw_len()
        for idx in self.sampler:
            batch.append([idx, seq_len])
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                seq_len = self._draw_len()
        if batch and not self.drop_last:
            yield batch
