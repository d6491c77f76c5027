"""Paper-figure helpers of ``-m infer``: nearest-neighbour retrieval and
sample filmstrips.

Counterpart of ``behavior_driven_video_synthesis_tpu/viz/figures.py``
(``nearest_neighbours`` :18-37, ``sample_examples_grid`` :40-46,
``nearest_neighbour_figure`` :49-84), host numpy and cv2 as there.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .videos import (create_video_3d, make_enrollment_strip, save_png,
                     text_to_vid)


def nearest_neighbours(queries: np.ndarray, database: np.ndarray,
                       k: int = 5, metric: str = "l2"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Queries (Q, D) against a database (N, D) -> (indices (Q, k),
    distances (Q, k)): squared L2, or 1 - cosine with ``metric="cos"``."""
    q = np.asarray(queries, np.float32)
    db = np.asarray(database, np.float32)
    if metric == "cos":
        qn = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-8)
        dn = db / (np.linalg.norm(db, axis=1, keepdims=True) + 1e-8)
        dist = 1.0 - qn @ dn.T
    else:
        dist = (np.sum(q ** 2, 1, keepdims=True)
                - 2 * q @ db.T + np.sum(db ** 2, 1)[None])
    idx = np.argsort(dist, axis=1)[:, :k]
    return idx, np.take_along_axis(dist, idx, axis=1)


def sample_examples_grid(sample_videos: np.ndarray, n_frames: int = 6
                         ) -> np.ndarray:
    """(S, T, H, W, C) sample videos -> their filmstrips stacked, one row
    a sample."""
    return np.concatenate([make_enrollment_strip(v, n_frames=n_frames)
                           for v in sample_videos], axis=0)


def nearest_neighbour_figure(betas: np.ndarray, sequences: np.ndarray,
                             labels: np.ndarray, out_path: str,
                             n_queries: int = 4, k: int = 3,
                             n_frames: int = 5) -> str:
    """For the first ``n_queries`` sequences, their ``k`` nearest other
    sequences in beta space; each row of the PNG is the query's 3-D
    skeleton filmstrip and then its neighbours', each with its action
    label burned in.  Returns the path written."""
    betas = np.asarray(betas, np.float32)
    seqs = np.asarray(sequences, np.float32)
    labels = np.asarray(labels).reshape(len(betas), -1)[:, 0]
    n_queries = min(n_queries, len(betas))
    idx, _ = nearest_neighbours(betas[:n_queries], betas, k=k + 1)

    def strip(i):
        world = seqs[i].reshape(seqs[i].shape[0], -1, 3)
        # only the frames the strip keeps (the view's bounds come from
        # them, as in the JAX package)
        sel = np.linspace(0, world.shape[0] - 1, n_frames).astype(int)
        frames = text_to_vid(create_video_3d(world[sel]),
                             f"a{int(labels[i])}", (5, 20))
        return make_enrollment_strip(frames, n_frames=n_frames)

    rows = []
    for q in range(n_queries):
        neighbours = [i for i in idx[q] if i != q][:k]
        rows.append(np.concatenate([strip(q)]
                                   + [strip(i) for i in neighbours], axis=1))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return save_png(np.concatenate(rows, axis=0).astype(np.uint8), out_path)
