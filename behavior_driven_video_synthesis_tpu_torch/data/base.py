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

The image half (JAX ``:220-246``, ``:310-452``): ``_load_image_rgb``
decodes a JPEG through the port's libjpeg binding (``data/native.py``,
DCT-scaled to the smallest size not below ``spatial_size``) unless the
library is missing or the file carries an EXIF orientation, else with
cv2 (BGR to RGB); ``_prep_image`` resizes to ``spatial_size`` (cv2
``INTER_LINEAR``); the pose, appearance and in-plane fetchers give float32
[-1, 1] HWC images, the appearance of the item's ``map_ids`` frame, with
``inplane_normalize`` the part stacks of ``data/parts.py``; the stickman
is the host cv2 raster (``geometry/stickman.py:make_joint_img``) of
``_get_kps_for_rendering``; with ``train_regressor`` an item also holds
``reg_imgs`` and ``reg_targets``, the probe images of its first frame and
``reg_steps - 1`` random frames and their keypoints over
``spatial_size``.  The part stacks are left to the device: an item holds
what they are made from (``data/parts.py:PartStackSource``), which
``data/parts.py:finish_part_stacks`` turns into the stacks of a batch.
The synthesis-weight fetcher (JAX ``:329-345``) gives per-pixel loss
weights: 10 inside the convex hull of a frame's rendering keypoints, 1
elsewhere.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np

from ..geometry.stickman import JointModel, get_line_colors, make_joint_img
from . import native
from .parts import PART_SUFFIXES, PartStackSource, part_stack_source

# images decoded by each route since the process started (or the last
# reset by the caller): "native" (libjpeg) or "cv2"
DECODES: Counter = Counter()
_DECODES_LOCK = threading.Lock()


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the image datasets read, resize and warp images "
                          "with OpenCV, and cv2 is not installed") from e
    return cv2


def _count(route: str) -> None:
    with _DECODES_LOCK:
        DECODES[route] += 1


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
        self.use_crops = bool(kwargs.get("use_crops", False))
        self.inplane_normalize = bool(kwargs.get("inplane_normalize", False))
        self.label_transfer = bool(kwargs.get("label_transfer", False))
        self.train_reg = bool(kwargs.get("train_regressor", False))
        self.rng = np.random.RandomState(kwargs.get("data_seed", None))
        self.line_colors = None
        if kwargs.get("diff_line_colors", False):
            self.line_colors = get_line_colors(
                (len(joint_model.left_lines), len(joint_model.right_lines),
                 len(joint_model.head_lines) + len(joint_model.face)))

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
            "stickman": self._get_stickman,
            "paired_stickman": lambda ids: self._get_paired(
                self._get_stickman, ids),
            "synth_weights": self._get_synth_weights,
            "pose_img": self._get_pose_img,
            "app_img": self._get_app_img,
            "pose_img_inplane": self._get_pose_img_inplane,
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
        ids = self._sample_valid_seq_ids(idx)
        data = {}
        for key in self.datakeys:
            if key not in ("reg_imgs", "reg_targets"):
                _put(data, key, self._output_dict[key](ids))
        if self.train_reg or "reg_imgs" in self.datakeys:
            self._add_reg_imgs(ids, data)
        return data

    def _add_reg_imgs(self, ids, data):
        """The regressor's probe images and their keypoints over
        ``spatial_size``: the window's first frame and ``reg_steps - 1``
        frames drawn without replacement."""
        ids = list(np.asarray(ids))
        reg_ids = [int(ids[0])]
        if self.reg_steps > 1:
            reg_ids += [int(e) for e in self.rng.choice(
                len(self), self.reg_steps - 1, replace=False)]
        fetch = (self._get_pose_img_inplane if self.inplane_normalize
                 else self._get_pose_img)
        imgs = fetch(np.asarray(reg_ids))
        if isinstance(imgs, PartStackSource):
            if imgs.src.ndim == 3:
                imgs = PartStackSource(*(a[None] for a in imgs))
        elif imgs.ndim == 3:
            imgs = imgs[None]
        _put(data, "reg_imgs", imgs)
        data["reg_targets"] = np.stack(
            [self._get_kps_for_rendering(i) / self.spatial_size
             for i in reg_ids]).astype(np.float32)
        return data

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

    def _get_kps_for_rendering(self, idx: int) -> np.ndarray:
        """The 2D pixel keypoints (K, 2) of one frame (subclass hook)."""
        return self.datadict["keypoints"][idx].reshape(-1, 2)

    def _get_stickman(self, ids):
        size = (self.spatial_size, self.spatial_size, 3)
        out = [self._to_float(make_joint_img(
            size, self._get_kps_for_rendering(int(i)), self.joint_model,
            line_colors=self.line_colors,
            scale_factor=self.stickman_scale_factor()))
            for i in np.asarray(ids)]
        return self._squeeze_seq(np.stack(out))

    def _get_synth_weights(self, ids, weight: float = 10.0):
        """(S, S, 1) float32 loss-weight maps: ``weight`` inside the convex
        hull of the frame's keypoints that are not negative (at least 3),
        1 elsewhere."""
        cv2 = _cv2()
        S = self.spatial_size
        out = []
        for i in np.asarray(ids):
            kps = self._get_kps_for_rendering(int(i))
            valid = kps[np.all(kps >= 0, axis=1)]
            wmap = np.ones((S, S, 1), np.float32)
            if len(valid) >= 3:
                mask = np.zeros((S, S), np.uint8)
                cv2.fillConvexPoly(mask, cv2.convexHull(
                    valid.astype(np.int32)), 1)
                wmap[mask > 0] = weight
            out.append(wmap)
        return self._squeeze_seq(np.stack(out))

    def stickman_scale_factor(self):
        return None

    # -- images ------------------------------------------------------------
    def _load_image(self, idx: int) -> np.ndarray:
        """The uint8 HWC BGR image of frame idx, read by cv2."""
        img = _cv2().imread(str(self.datadict["img_paths"][idx]))
        if img is None:
            raise FileNotFoundError(self.datadict["img_paths"][idx])
        return img

    def _load_image_rgb(self, idx: int, min_dim=None) -> np.ndarray:
        """The uint8 HWC RGB image of frame idx: a JPEG without an EXIF
        orientation through libjpeg, at the largest DCT downscale that
        keeps both dims >= ``min_dim``; anything else (or a stream the
        library refuses) through cv2."""
        p = str(self.datadict["img_paths"][idx])
        if p.lower().endswith((".jpg", ".jpeg")) and \
                native.decode_available():
            try:
                with open(p, "rb") as f:
                    data = f.read()
                if native.jpeg_orientation(data) in (None, 1):
                    denom = 1
                    if min_dim:
                        denom = native.pick_scale_denom(
                            *native.jpeg_dims(data), min_dim)
                    img = native.decode_jpeg(data, denom)
                    _count("native")
                    return img
            except (ValueError, OSError):
                pass            # a stream the library refuses: cv2 reads it
        img = self._load_image(idx)
        _count("cv2")
        if img.ndim == 3 and img.shape[-1] == 3:
            img = _cv2().cvtColor(img, _cv2().COLOR_BGR2RGB)
        return img

    def _prep_image(self, idx: int) -> np.ndarray:
        img = self._load_image_rgb(idx, min_dim=self.spatial_size)
        if img.shape[:2] != (self.spatial_size, self.spatial_size):
            cv2 = _cv2()
            img = cv2.resize(img, (self.spatial_size, self.spatial_size),
                             interpolation=cv2.INTER_LINEAR)
        return img

    def _to_float(self, img: np.ndarray) -> np.ndarray:
        """uint8 [0, 255] -> float32 [-1, 1]."""
        return (img.astype(np.float32) / 127.5) - 1.0

    def _squeeze_seq(self, arr):
        """A single-frame dataset (seq_length (0, 0)) gives the frame, not
        a sequence of one."""
        if isinstance(arr, PartStackSource):
            return PartStackSource(*(self._squeeze_seq(a) for a in arr))
        if self.seq_length == (0, 0) and arr.shape[0] == 1:
            return arr[0]
        return arr

    def _part_stacks(self, ids) -> PartStackSource:
        """What the part stacks of frames ``ids`` are made from."""
        return self._squeeze_seq(part_stack_source(
            [self._prep_image(int(i)) for i in ids],
            [self._get_kps_for_rendering(int(i)) for i in ids],
            self.joint_model, self.spatial_size // 2 ** self.box_factor))

    def _get_pose_img(self, ids):
        out = []
        for i in np.asarray(ids):
            img = self._prep_image(int(i))
            if self.use_crops:
                from ..utils.boxes import crop_with_bbox

                cv2 = _cv2()
                img = cv2.resize(
                    crop_with_bbox(img, self._get_kps_for_rendering(int(i))),
                    (self.spatial_size, self.spatial_size),
                    interpolation=cv2.INTER_LINEAR)
            out.append(self._to_float(img))
        return self._squeeze_seq(np.stack(out))

    def _get_app_img(self, ids):
        mapped = self.datadict["map_ids"][np.asarray(ids)]
        if self.inplane_normalize:
            return self._part_stacks(mapped)
        return self._squeeze_seq(np.stack(
            [self._to_float(self._prep_image(int(i))) for i in mapped]))

    def _get_pose_img_inplane(self, ids):
        ids = np.asarray(ids)
        if self.inplane_normalize:
            return self._part_stacks(ids)
        return self._squeeze_seq(np.stack(
            [self._to_float(self._prep_image(int(i))) for i in ids]))


def _put(data: Dict, key: str, value) -> None:
    """``data[key] = value``, a :class:`PartStackSource` as its three
    arrays."""
    if isinstance(value, PartStackSource):
        for suffix, a in zip(PART_SUFFIXES, value):
            data[key + suffix] = a
    else:
        data[key] = value
