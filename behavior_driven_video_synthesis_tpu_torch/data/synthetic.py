"""Synthetic keypoint-sequence dataset.

A copy of ``behavior_driven_video_synthesis_tpu/data/synthetic.py``
(pure numpy), kept here so that this package imports nothing of the
JAX package.

A stand-in for Human3.6M with the same batch contract as the real loader
(keys: keypoints, paired_keypoints, action, sample_ids), used by tests and
benchmarks (SURVEY.md §4 recommends a synthetic in-memory dataset since the
reference has no test suite and the real h5 is not shipped).

Sequences are mixtures of per-action sinusoidal joint trajectories with
random phase/amplitude, so "behavior" (action-specific frequency pattern) is
genuinely separable from the start posture — the cVAE can reach low recon
loss and the action probes have signal.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticSequenceDataset:
    def __init__(self, n_samples: int = 512, seq_length: int = 51,
                 n_kps: int = 51, n_actions: int = 10, seed: int = 0):
        self.n_samples = n_samples
        self.seq_length = seq_length
        self.n_kps = n_kps
        self.n_actions = n_actions
        rng = np.random.RandomState(seed)

        # per-action frequency/coupling signature
        self.action_freqs = rng.uniform(0.05, 0.45, (n_actions, n_kps))
        self.action_coupling = rng.randn(n_actions, n_kps, 4) * 0.4

        self.actions = rng.randint(0, n_actions, n_samples)
        base_pose = rng.randn(n_samples, n_kps).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, (n_samples, 4))
        amps = rng.uniform(0.5, 1.5, (n_samples, 1))

        t = np.arange(seq_length)[None, :, None]  # (1, T, 1)
        osc = np.stack(
            [np.sin(self.action_freqs[self.actions][:, None, :] * t
                    + phases[:, None, k:k + 1]) for k in range(4)],
            axis=-1,
        )  # (N, T, K, 4)
        motion = np.einsum(
            "ntkc,nkc->ntk", osc, self.action_coupling[self.actions]
        )
        self.keypoints = (
            base_pose[:, None, :] + amps[:, None, :] * motion
        ).astype(np.float32)

        # paired sample: same action, different start pose
        self.map_ids = np.empty(n_samples, np.int64)
        for a in range(n_actions):
            idx = np.where(self.actions == a)[0]
            self.map_ids[idx] = rng.permutation(idx)

        self.dim_to_use = np.arange(n_kps)
        self.action_id_to_action = {i: f"action_{i}" for i in range(n_actions)}

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {
            "keypoints": self.keypoints[idx],
            "paired_keypoints": self.keypoints[self.map_ids[idx]],
            "action": np.int32(self.actions[idx]),
            "sample_ids": np.int64(idx),
        }

    def batches(self, batch_size: int, seed: int = 0,
                n_batches: Optional[int] = None,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed)
        order = rng.permutation(self.n_samples)
        count = 0
        for start in range(0, self.n_samples - (batch_size - 1 if drop_last
                                                else 0), batch_size):
            idx = order[start:start + batch_size]
            yield {
                "keypoints": self.keypoints[idx],
                "paired_keypoints": self.keypoints[self.map_ids[idx]],
                "action": self.actions[idx].astype(np.int32),
                "sample_ids": idx.astype(np.int64),
            }
            count += 1
            if n_batches is not None and count >= n_batches:
                return


def synthetic_h36m_columns(n_frames_per_video: int = 120,
                           subjects=(1, 5, 9), actions=(2, 4, 5),
                           image_size: int = 1000,
                           seed: int = 0):
    """Synthetic Human3.6M-like columns (smooth 3D world trajectories,
    camera tables) for tests/demos of the full H36M pipeline without the
    real dataset.  Feed to Human36mDataset.populate_from_arrays."""
    rng = np.random.RandomState(seed)
    N = n_frames_per_video
    cols = {k: [] for k in ["keypoints_3d_world", "p_ids", "f_ids",
                            "action", "subaction", "camera_id",
                            "image_size", "intrinsics_univ",
                            "extrinsics_univ", "img_paths"]}
    vid = 0
    for pid in subjects:
        for act in actions:
            base = rng.randn(17, 3) * 0.3 + np.array([0, 0, 4.0])
            freq = rng.uniform(0.05, 0.3, (17, 3))
            phase = rng.uniform(0, 2 * np.pi, (17, 3))
            t = np.arange(N)[:, None, None]
            kps = base + 0.2 * np.sin(freq * t + phase)
            cols["keypoints_3d_world"].append(kps)
            cols["p_ids"].append(np.full(N, pid))
            cols["f_ids"].append(np.arange(N) + 1)
            cols["action"].append(np.full(N, act))
            cols["subaction"].append(np.full(N, 1))
            cols["camera_id"].append(np.full(N, 54138969))
            cols["image_size"].append(np.tile([image_size, image_size],
                                              (N, 1)))
            cols["intrinsics_univ"].append(
                np.tile([1145.0, image_size / 2, 1143.0, image_size / 2],
                        (N, 1)))
            extr = np.hstack([np.eye(3), np.zeros((3, 1))])
            cols["extrinsics_univ"].append(np.tile(extr, (N, 1, 1)))
            cols["img_paths"].append(np.asarray(
                [f"video_{vid}/frame_{i:06d}.jpg" for i in range(N)]))
            vid += 1
    return {k: np.concatenate(v, axis=0) for k, v in cols.items()}
