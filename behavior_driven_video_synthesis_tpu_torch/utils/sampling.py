"""Sampling distributions and a parallel host map.

Counterpart of ``behavior_driven_video_synthesis_tpu/utils/sampling.py``,
host numpy and scipy: ``get_area_sampling_dist`` (weights 1 / hull area
^ w, which oversample poses of small extent), ``get_pid_sampling_dist``
(inverse person frequency, the cvbae config's ``data.sampling: pid``) and
``parallel_data_prefetch`` (a thread-pool map over chunks, results in
order).  As in the JAX package, no driver reads ``data.sampling``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np


def get_area_sampling_dist(kps: np.ndarray, exp_weight: float = 1.0,
                           kp_subset: Optional[Sequence[int]] = None
                           ) -> np.ndarray:
    """(N, K, 2+) keypoints -> unnormalized weights 1 / hull_area ^ w (1
    for a degenerate pose)."""
    from scipy.spatial import ConvexHull, QhullError

    out = np.empty(len(kps), np.float64)
    sub = None if kp_subset is None else np.asarray(kp_subset)
    for i, kp in enumerate(kps):
        pts = kp[:, :2] if sub is None else kp[sub, :2]
        try:
            area = ConvexHull(pts).area
        except (QhullError, ValueError):     # a degenerate pose
            area = 1.0
        out[i] = (1.0 / max(area, 1e-8)) ** exp_weight
    return out


def get_pid_sampling_dist(p_ids: np.ndarray) -> np.ndarray:
    """Inverse person-frequency weights, normalized."""
    uniq, counts = np.unique(p_ids, return_counts=True)
    freq = dict(zip(uniq.tolist(), counts.tolist()))
    w = np.asarray([1.0 / freq[int(p)] for p in p_ids], np.float64)
    return w / w.sum()


def parallel_data_prefetch(func: Callable, data: Sequence,
                           n_proc: int = 8) -> list:
    """``[func(x) for x in data]`` over ``n_proc`` threads, in order."""
    n_proc = max(1, min(n_proc, len(data)))
    chunks = np.array_split(np.arange(len(data)), n_proc)

    def run(chunk_ids):
        return [func(data[i]) for i in chunk_ids]

    with ThreadPoolExecutor(n_proc) as pool:
        results = list(pool.map(run, chunks))
    return [r for chunk in results for r in chunk]
