"""Column-store sequence dataset: windowing, pairing, keypoint fetchers.

Counterpart of the sequence part of ``BaseDataset`` in
``behavior_driven_video_synthesis_tpu/data/base.py:36-307``: a dict of
parallel numpy arrays (``datadict``) with per-key fetchers in
``_output_dict``.

  * ``__getitem__`` takes ``idx`` or ``[idx, seq_len]`` (the sampler passes
    the batch's sequence length);
  * ``_sample_valid_seq_ids`` windows from an anchor with
    ``sequential_frame_lag``, clamped at the video's ends with the lag
    reduced;
  * ``resample_map_ids`` per epoch: label-transfer pairs drawn from other
    actions, otherwise shuffled within the action;
  * the lag and length are corrected against the shortest video;
  * the 80/20 overall split uses its own RandomState(42);
  * the per-action tables and ``_match_subsequence`` pair a sequence with
    its nearest same-action window under pose encodings.

The image, stickman and part fetchers (JAX ``:310-452``) raise
``NotImplementedError``: the image fetchers come with the real image
datasets (ROADMAP A10c), the stickman and synthesis-weight fetchers with
the figures (A12).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..geometry.stickman import JointModel


def _unported(what: str, item: str) -> Callable:
    def fetch(ids):
        raise NotImplementedError(f"the {what} fetcher is not ported yet "
                                  f"(ROADMAP {item})")
    return fetch


class BaseDataset:
    def __init__(self, transforms, mode: str, seq_length, datakeys,
                 joint_model: JointModel, **kwargs):
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        self.mode = mode
        self.transforms = transforms
        self.datakeys = list(datakeys)
        self.joint_model = joint_model
        self.seq_length = tuple(seq_length)

        self.spatial_size = int(kwargs.get("spatial_size", 256))
        self.box_factor = int(kwargs.get("box_factor", 2))
        self.sequential_frame_lag = int(kwargs.get("sequential_frame_lag", 1))
        self.label_transfer = bool(kwargs.get("label_transfer", False))
        self.train_reg = bool(kwargs.get("train_regressor", False))
        self.rng = np.random.RandomState(kwargs.get("data_seed", None))

        self.datadict: Dict[str, np.ndarray] = {
            "img_paths": np.asarray([]),
            "keypoints": np.asarray([]),
            "v_ids": np.asarray([], np.int64),
            "p_ids": np.asarray([], np.int64),
            "f_ids": np.asarray([], np.int64),
            "map_ids": np.asarray([], np.int64),
            "action": np.asarray([], np.int64),
        }
        self.complete_datadict: Optional[Dict[str, np.ndarray]] = None
        self.matched_map_ids: Optional[np.ndarray] = None
        self.pose_encodings: Optional[np.ndarray] = None
        self.sequence_start_ids: Dict[int, int] = {}
        self.sequence_end_ids: Dict[int, int] = {}

        self._output_dict: Dict[str, Callable] = {
            "keypoints": self._get_keypoints,
            "paired_keypoints": lambda ids: self._get_paired(
                self._get_keypoints, ids),
            "matched_keypoints": lambda ids: self._get_paired(
                self._get_keypoints, ids, matched=True),
            "sample_ids": lambda ids: np.asarray(ids, np.int64),
            "paired_sample_ids": lambda ids: np.asarray(
                self.datadict["map_ids"][np.asarray(ids)], np.int64),
            "action": lambda ids: self.datadict["action"][
                np.asarray(ids)].astype(np.int64),
            "img_size": lambda ids: np.asarray(
                [self.spatial_size, self.spatial_size]),
            "stickman": _unported("stickman", "A12"),
            "paired_stickman": _unported("stickman", "A12"),
            "synth_weights": _unported("synthesis-weight", "A12"),
            "pose_img": _unported("image", "A10c"),
            "app_img": _unported("image", "A10c"),
            "pose_img_inplane": _unported("in-plane part", "A10c"),
        }
        self.reg_steps = int(kwargs.get("reg_steps", 5))

    # -- population hooks (called by subclasses after filling datadict) ----
    def _finalize(self):
        self.datadict = {k: np.asarray(v) for k, v in self.datadict.items()
                         if np.asarray(v).size != 0}
        self._get_sequence_start_ids()
        self._get_sequence_end_ids()
        if self.seq_length[1] > 0:
            self._check_seq_len_and_frame_lag()
        if "map_ids" not in self.datadict or \
                self.datadict["map_ids"].size != len(self):
            self.datadict["map_ids"] = np.arange(len(self))
        self.resample_map_ids()

    def __len__(self) -> int:
        key = "img_paths" if "img_paths" in self.datadict else "keypoints"
        return int(self.datadict[key].shape[0])

    # -- windowing ----------------------------------------------------------
    def _sample_valid_seq_ids(self, input_data):
        if self.seq_length[0] == 0 and self.seq_length[1] == 0:
            idx = input_data if isinstance(input_data, (int, np.integer)) \
                else input_data[0]
            return np.asarray([idx])

        if isinstance(input_data, (int, np.integer)):
            idx = int(input_data)
            seq_len = int(self.rng.randint(self.seq_length[0],
                                           self.seq_length[1] + 1))
        else:
            idx = int(input_data[0])
            seq_len = int(input_data[-1])

        v_id = int(self.datadict["v_ids"][idx])
        seq_end_id = self.sequence_end_ids[v_id]
        frame_lag = self.sequential_frame_lag
        idx_start = idx
        idx_end = idx_start + frame_lag * seq_len + 1  # anchor + seq_len

        if idx_end > seq_end_id:
            seq_start_id = self.sequence_start_ids[v_id]
            idx_start = idx_start - (idx_end - seq_end_id) + 1
            idx_end = seq_end_id + 1
            if idx_start < seq_start_id:
                frame_lag = max(1, int((idx_end - seq_start_id) / seq_len))
                idx_start = idx_end - frame_lag * seq_len - 1

        return np.arange(idx_start, idx_end, frame_lag)

    def _get_sequence_end_ids(self):
        v = self.datadict["v_ids"]
        self.sequence_end_ids = {int(k): int(np.max(np.where(v == k)[0]))
                                 for k in np.unique(v)}

    def _get_sequence_start_ids(self):
        v = self.datadict["v_ids"]
        self.sequence_start_ids = {int(k): int(np.min(np.where(v == k)[0]))
                                   for k in np.unique(v)}

    def _check_seq_len_and_frame_lag(self):
        seq_lengths = [self.sequence_end_ids[v] - self.sequence_start_ids[v]
                       for v in self.sequence_end_ids]
        min_seq_len = int(np.min(seq_lengths))
        if self.seq_length[1] * self.sequential_frame_lag > min_seq_len:
            self.sequential_frame_lag = max(
                1, int(min_seq_len / self.seq_length[1]))
            if self.seq_length[1] > min_seq_len:
                self.seq_length = (self.seq_length[0], min_seq_len)
                if self.seq_length[0] >= self.seq_length[1]:
                    self.seq_length = (self.seq_length[1] - 1,
                                       self.seq_length[1])

    # -- pairing ------------------------------------------------------------
    def resample_map_ids(self):
        self.__resample_map(self.datadict, use_matched=True)
        if self.complete_datadict is not None:
            self.__resample_map(self.complete_datadict)

    def __resample_map(self, ddict, use_matched: bool = False):
        if ddict["action"].size == 0:
            return
        if "map_ids" not in ddict or ddict["map_ids"].size != \
                ddict["action"].size:
            ddict["map_ids"] = np.arange(ddict["action"].size)
        unique_aids = np.unique(ddict["action"])
        if self.label_transfer:
            for aid in unique_aids:
                same = np.nonzero(ddict["action"] == aid)[0]
                diff = np.nonzero(ddict["action"] != aid)[0]
                if diff.size == 0:
                    continue
                replace = same.size > diff.size
                ddict["map_ids"][same] = self.rng.choice(
                    diff, same.size, replace=replace)
                if self.matched_map_ids is not None and use_matched:
                    shuffled = same.copy()
                    self.rng.shuffle(shuffled)
                    self.matched_map_ids[same] = shuffled
        else:
            for aid in unique_aids:
                valid = np.nonzero(ddict["action"] == aid)[0]
                shuffled = valid.copy()
                self.rng.shuffle(shuffled)
                ddict["map_ids"][valid] = shuffled

    def _make_overall_split(self):
        """The first 80 % of a RandomState(42) permutation: the same split
        in every process, whatever ``data_seed`` is."""
        n = len(self)
        rng = np.random.RandomState(42)
        ids = rng.permutation(n)
        target = ids[:int(0.8 * n)]
        self.datadict = {k: v[target] for k, v in self.datadict.items()
                         if v.size != 0}

    # -- item assembly -------------------------------------------------------
    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        if self.train_reg or "reg_imgs" in self.datakeys:
            raise NotImplementedError("the regressor's probe images are not "
                                      "ported yet (ROADMAP A10c)")
        ids = self._sample_valid_seq_ids(idx)
        return {key: self._output_dict[key](ids) for key in self.datakeys}

    # -- fetchers ------------------------------------------------------------
    def _get_paired(self, fetch, ids, matched: bool = False):
        ids = np.asarray(ids)
        if matched and getattr(self, "pose_encodings", None) is not None:
            return fetch(self._match_subsequence(ids))
        table = (self.matched_map_ids if matched and
                 self.matched_map_ids is not None
                 else self.datadict["map_ids"])
        anchor = int(table[ids[0]])
        new_ids = self._sample_valid_seq_ids([anchor, len(ids) - 1])
        return fetch(new_ids)

    # -- pose-encoding sequence matching -------------------------------------
    def set_pose_encodings(self, encodings: np.ndarray):
        """Per-frame pose embeddings, which turn on nearest-neighbour
        sequence matching for ``matched_keypoints``."""
        if len(encodings) != len(self):
            raise ValueError(f"{len(encodings)} encodings for {len(self)} "
                             f"frames")
        self.pose_encodings = np.asarray(encodings, np.float32)
        self._build_seqs_per_action()

    def _build_seqs_per_action(self):
        self.seqs_per_action = {}
        v = self.datadict["v_ids"]
        for vid in np.unique(v):
            idx = np.where(v == vid)[0]
            aid = int(self.datadict["action"][idx[0]])
            self.seqs_per_action.setdefault(aid, []).append(idx)

    def get_action_sequence(self, action_label: int) -> np.ndarray:
        seqs = self.seqs_per_action[int(action_label)]
        return seqs[int(self.rng.randint(len(seqs)))]

    def _match_subsequence(self, ids: np.ndarray) -> np.ndarray:
        """The nearest window (stride 5, mean L2 under the pose encodings)
        of a random video of the same action."""
        action_id = int(self.datadict["action"][ids[0]])
        ids_target = np.asarray(self.get_action_sequence(action_id))
        base = self.pose_encodings[ids]
        target = self.pose_encodings[ids_target]
        L1 = len(ids)
        lag = self.sequential_frame_lag
        span = lag * L1
        if len(ids_target) < span:
            # target too short: fall back to matched map ids
            anchor = int((self.matched_map_ids
                          if self.matched_map_ids is not None
                          else self.datadict["map_ids"])[ids[0]])
            return self._sample_valid_seq_ids([anchor, L1 - 1])
        starts = np.arange(0, len(ids_target) - span + 1, 5)
        best, best_k = np.inf, 0
        for k in starts:
            win = target[k:k + span:lag]
            d = float(np.mean(np.linalg.norm(win - base, axis=-1)))
            if d < best:
                best, best_k = d, k
        return ids_target[best_k:best_k + span:lag]

    def _get_keypoints(self, ids):
        return self.datadict["keypoints"][np.asarray(ids)].astype(np.float32)
