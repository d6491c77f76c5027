"""Human3.6M: the joint models and the keypoint-sequence dataset.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/human36m.py``
(the constants and joint models :46-131, ``Human36mDataset`` :135-440),
numpy only; the constants are copied because that module pulls in the JAX
geometry stack.

  * ``annot_export.h5``'s columns (``H5_ATTRIBUTE_MAPPING``) fill the column
    store (``_load_h36m_full``: h5py where it is installed, else
    ``data/h5lite.py``);
    ``populate_from_arrays`` fills it from arrays instead;
  * composite video ids ``1e6*cam + 1e4*action + 1e3*subaction + pid`` are
    remapped to dense ints;
  * world keypoints and the extrinsics' translation go from mm to m, the
    17 keypoints of the joint model are kept and flattened to 51-d and
    z-scored with degenerate dims dropped (``norm_stats``);
  * world-coordinate runs that do not train synthesis keep one camera;
  * the person split S1,5,6,7,8 / S9,11, the action splits (incl.
    generalize_sitting/walking), the overall 80/20 split and the action
    filters;
  * ``--debug`` keeps 100 frames per (person, action);
  * the keypoint fetcher, with the reprojection to normalized image
    coordinates for the regressor; the intrinsics and extrinsics fetchers.

The frames' images come through the base dataset's image fetchers on
``img_paths`` (joined onto ``datapath``); ``_get_kps_for_rendering`` gives
a frame's pixel keypoints (the world keypoints projected into the image,
for ``keypoints_3d_world``), which the stickman, the part stacks and the
probe targets read; with ``use_3d_for_stickman`` the stickman is drawn
from the 3D keypoints through the frame's camera
(``_get_stickman_from_3d``), which for ``angle_world_expmap`` come from
the joint angles through ``geometry/kinematics.py:forward_kinematics``.
"""
from __future__ import annotations

from copy import deepcopy
from functools import partial
from os import path
from typing import Dict, List, Optional

import numpy as np

import torch

from ..geometry.kinematics import forward_kinematics
from ..geometry.normalization import (NormStats, normalization_stats,
                                      unnormalize)
from ..geometry.stickman import JointModel, make_joint_img
from .base import BaseDataset
from .parts import t2p, t3p, t4p, t5p

ACTION_ID_TO_ACTION = {
    2: "Directions", 3: "Discussion", 4: "Eating", 5: "Greeting",
    6: "Phoning", 7: "Posing", 8: "Purchases", 9: "Sitting",
    10: "SittingDown", 11: "Smoking", 12: "TakingPhoto", 13: "Waiting",
    14: "Walking", 15: "WalkingDog", 16: "WalkTogether",
}

VALID_KEYPOINT_TYPES = [
    "angle_euler", "norm_keypoints", "keypoints_3d", "keypoints_3d_univ",
    "angle_expmap", "angle_world_euler", "angle_world_expmap",
    "keypoints_3d_world",
]

H5_ATTRIBUTE_MAPPING = {
    "frame_path": "img_paths",
    "pose_2d": "keypoints",
    "subject": "p_ids",
    "frame": "f_ids",
    "action": "action",
    "subaction": "subaction",
    "pose_normalized_2d": "norm_keypoints",
    "camera": "camera_id",
    "image_size": "image_size",
    "intrinsics_univ": "intrinsics_univ",
    "pose_3d": "keypoints_3d",
    "pose_3d_world": "keypoints_3d_world",
    "extrinsics_univ": "extrinsics_univ",
}


def small_joint_model() -> JointModel:
    """13-keypoint model."""
    return JointModel(
        body=[25, 17, 6, 1],
        right_lines=[(3, 2), (2, 1), (1, 25), (25, 26), (26, 30)],
        left_lines=[(8, 7), (7, 6), (6, 17), (17, 18), (18, 22)],
        head_lines=[], face=[],
        rshoulder=25, lshoulder=17, headup=15,
        kps_to_use=[1, 2, 3, 6, 7, 8, 15, 17, 18, 22, 25, 26, 30],
        total_relative_joints=[
            [0, 1], [1, 2], [3, 4], [4, 5], [0, 3], [3, 7], [0, 10],
            [7, 10], [7, 8], [8, 9], [10, 11], [11, 12]],
        kp_to_joint=["r_hip", "r_knee", "r_foot", "l_hip", "l_knee",
                     "l_foot", "head", "l_shoulder", "l_elbow", "l_hand",
                     "r_shoulder", "r_elbow", "r_hand"],
        kps_to_change=[1, 2, 3, 6, 7, 8, 15, 17, 18, 22, 25, 26, 30],
        kps_to_change_rel=list(range(13)),
        norm_T=[t3p, t4p,
                partial(t2p, ids=[25, 26]), partial(t2p, ids=[26, 30]),
                partial(t2p, ids=[17, 18]), partial(t2p, ids=[18, 22]),
                partial(t2p, ids=[1, 2]), partial(t2p, ids=[2, 3]),
                partial(t2p, ids=[6, 7]), partial(t2p, ids=[7, 8])],
    )


def detailed_joint_model(world_coords: bool) -> JointModel:
    """17-keypoint model; with world 3D keypoints the line indices are in
    the reduced 17-keypoint layout."""
    return JointModel(
        body=[0, 14, 8, 11, 3] if world_coords else [1, 25, 13, 17, 6],
        right_lines=([(0, 1), (1, 2), (0, 14), (14, 15), (15, 16)]
                     if world_coords
                     else [(3, 2), (2, 1), (1, 25), (25, 26), (26, 27)]),
        left_lines=([(3, 4), (4, 5), (3, 11), (11, 12), (12, 13)]
                    if world_coords
                    else [(8, 7), (7, 6), (6, 17), (17, 18), (18, 19)]),
        head_lines=([(8, 9), (9, 10)] if world_coords
                    else [(13, 14), (14, 15)]),
        face=[],
        rshoulder=25, lshoulder=17, headup=15,
        kps_to_use=[1, 2, 3, 6, 7, 8, 11, 12, 13, 14, 15, 17, 18, 19,
                    25, 26, 27],
        total_relative_joints=[
            [0, 1], [1, 2], [3, 4], [4, 5], [3, 6], [0, 6], [6, 7],
            [7, 8], [8, 9], [9, 10], [8, 11], [8, 14], [11, 12],
            [12, 13], [14, 15], [15, 16]],
        kp_to_joint=["r_hip", "r_knee", "r_foot", "l_hip", "l_knee",
                     "l_foot", "pelvis", "thorax", "neck", "nose", "head",
                     "l_shoulder", "l_elbow", "l_wirst", "r_shoulder",
                     "r_elbow", "r_wrist"],
        norm_T=[t3p, t5p,
                partial(t2p, ids=[25, 26]), partial(t2p, ids=[26, 30]),
                partial(t2p, ids=[17, 18]), partial(t2p, ids=[18, 22]),
                partial(t2p, ids=[1, 2]), partial(t2p, ids=[2, 3]),
                partial(t2p, ids=[6, 7]), partial(t2p, ids=[7, 8])],
    )


class Human36mDataset(BaseDataset):
    def __init__(self, transforms, data_keys, seq_length, mode="train",
                 **kwargs):
        self.small_joint_model = bool(kwargs.get("small_joint_model", False))
        self.keypoint_key = kwargs.get("keypoint_type", None)
        if self.keypoint_key not in (None, *VALID_KEYPOINT_TYPES):
            raise ValueError(f"keypoint_type {self.keypoint_key!r} is not "
                             f"one of {VALID_KEYPOINT_TYPES}")
        self.action_split_type = kwargs.get("action_split_type", "default")
        self.use_person_split = bool(kwargs.get("use_person_split", True))
        self.train_synthesis = bool(kwargs.get("train_synthesis", False))
        self.use_3d_for_stickman = bool(
            kwargs.get("use_3d_for_stickman", False))
        self.overall_split = bool(kwargs.get("overall_split", False))
        self.actions_to_use = kwargs.get("actions_to_use", None)
        self.actions_to_discard = kwargs.get("actions_to_discard", None)
        self.all_actions = bool(kwargs.get("all_actions", True))
        self.debug = bool(kwargs.get("debug", False))
        self.stickman_scale = kwargs.get("stickman_scale", 50)

        world = self.keypoint_key == "keypoints_3d_world"
        jm = (small_joint_model() if self.small_joint_model
              else detailed_joint_model(world))
        if self.use_3d_for_stickman and (
                self.keypoint_key not in ("angle_world_expmap",
                                          "keypoints_3d_world")
                or (world and self.small_joint_model)
                or not self.train_synthesis):
            raise ValueError(
                "use_3d_for_stickman needs keypoint_type keypoints_3d_world "
                "(with the detailed joint model) or angle_world_expmap, and "
                "train_synthesis")
        super().__init__(transforms, mode, seq_length, data_keys, jm,
                         **kwargs)

        self._output_dict.update({
            "intrinsics": self._get_intrinsics,
            "intrinsics_paired": lambda ids: self._get_intrinsics(
                ids, use_map_ids=True),
            "extrinsics": self._get_extrinsics,
            "extrinsics_paired": lambda ids: self._get_extrinsics(
                ids, use_map_ids=True),
        })
        if self.use_3d_for_stickman:
            self._output_dict["stickman"] = self._get_stickman_from_3d

        self.label_type = "action"
        self.datapath = kwargs.get("datapath", "")
        self.norm_stats: Optional[NormStats] = None
        self.person_ids: List[int] = []

        if self.datapath and path.exists(
                path.join(self.datapath, "annot_export.h5")):
            self._load_h36m_full(self.datapath)
            self._finalize()
        # otherwise it stays empty until populate_from_arrays

        self.action_id_to_action = {
            i: ACTION_ID_TO_ACTION[a] for i, a in
            enumerate(sorted(ACTION_ID_TO_ACTION))
        } if self.all_actions else {}

    # -- population --------------------------------------------------------
    def _load_h36m_full(self, basepath: str):
        h5_file = path.join(basepath, "annot_export.h5")
        try:
            import h5py
        except ImportError:
            from .h5lite import read_columns
            columns = read_columns(h5_file)
        else:
            with h5py.File(h5_file, "r") as f:
                columns = {k: np.asarray(f[k]) for k in f.keys()}
        for k, v in columns.items():
            if k in H5_ATTRIBUTE_MAPPING:
                self.datadict[H5_ATTRIBUTE_MAPPING[k]] = v
        if self.keypoint_key and self.keypoint_key not in self.datadict:
            raise KeyError(f"{self.keypoint_key} not in h5 columns")

        if self.debug:
            self._debug_subset()

        self.person_ids = list(np.unique(self.datadict["p_ids"]))
        self.datadict["img_paths"] = np.asarray([
            path.join(basepath, p.decode("utf-8") if isinstance(p, bytes)
                      else str(p))
            for p in self.datadict["img_paths"]])
        self.datadict["f_ids"] = self.datadict["f_ids"] - 1
        self.complete_datadict = deepcopy(self.datadict)
        self.process_arrays()
        if self.keypoint_key not in (None, "norm_keypoints"):
            self.matched_map_ids = np.arange(len(self))

    def populate_from_arrays(self, columns: Dict[str, np.ndarray],
                             keep_complete: bool = True):
        """Fill the column store from arrays (tests, offline data)."""
        self.datadict.update({k: np.asarray(v) for k, v in columns.items()})
        self.person_ids = list(np.unique(self.datadict["p_ids"]))
        if keep_complete:
            self.complete_datadict = deepcopy(self.datadict)
        self.process_arrays()
        # 3D keypoint runs use matched (same-action) map ids for the
        # matched_keypoints fetcher
        if self.keypoint_key not in (None, "norm_keypoints"):
            self.matched_map_ids = np.arange(len(self))
        self._finalize()

    def _debug_subset(self):
        ids = []
        for pid in np.unique(self.datadict["p_ids"]):
            for aid in np.unique(self.datadict["action"]):
                sel = np.nonzero((self.datadict["action"] == aid)
                                 & (self.datadict["p_ids"] == pid))[0][:100]
                ids.extend(sel.tolist())
        ids = np.asarray(ids, np.int64)
        self.datadict = {k: v[ids] for k, v in self.datadict.items()
                         if v.size > 0}

    def process_arrays(self):
        """Composite video ids, units, keypoint selection, z-score, split,
        action filter."""
        dd = self.datadict
        kk = self.keypoint_key

        if kk and "world" in kk and not self.train_synthesis \
                and "camera_id" in dd:
            target_cam = np.unique(dd["camera_id"])[0]
            sel = dd["camera_id"] == target_cam
            for key in list(dd):
                if dd[key].size > 0:
                    dd[key] = dd[key][sel]
            # the complete dict keeps every camera
        self._assign_v_ids(dd)
        if self.complete_datadict is not None:
            self._assign_v_ids(self.complete_datadict)

        if kk == "keypoints_3d_world":
            for d in [dd] + ([self.complete_datadict]
                             if self.complete_datadict is not None else []):
                kps = d[kk].astype(np.float64)
                if kps.max() > 100.0:  # mm -> m (synthetic data is in m)
                    kps = kps / 1000.0
                    if "extrinsics_univ" in d:
                        d["extrinsics_univ"] = d["extrinsics_univ"].astype(
                            np.float64)
                        d["extrinsics_univ"][:, :, -1] /= 1000.0
                if kps.ndim == 3 and kps.shape[1] > len(
                        self.joint_model.kps_to_use):
                    kps = kps[:, np.asarray(self.joint_model.kps_to_use)]
                d[kk] = kps.reshape(kps.shape[0], -1).astype(np.float32)

        if kk and (kk == "keypoints_3d_world" or "angle" in kk):
            self.norm_stats = normalization_stats(dd[kk])
            dd[kk] = self._normalize_poses(dd[kk])
            if self.complete_datadict is not None:
                self.complete_datadict[kk] = self._normalize_poses(
                    self.complete_datadict[kk])

        if self.overall_split:
            self._make_overall_split()
        else:
            split = self._get_split_full()[self.mode]
            sel = np.asarray(sorted(split), np.int64)
            for k in list(dd):
                if dd[k].size > 0:
                    dd[k] = dd[k][sel]

        if self.actions_to_use is not None or \
                self.actions_to_discard is not None:
            if self.actions_to_use and self.actions_to_discard:
                raise ValueError("give actions_to_use or actions_to_discard, "
                                 "not both")
            names = {i: ACTION_ID_TO_ACTION.get(int(i), str(i))
                     for i in np.unique(dd["action"])}
            if self.actions_to_discard is not None:
                keep = [i for i, a in enumerate(dd["action"])
                        if names[int(a)] not in self.actions_to_discard]
            else:
                keep = [i for i, a in enumerate(dd["action"])
                        if names[int(a)] in self.actions_to_use]
            keep = np.asarray(keep, np.int64)
            for k in list(dd):
                if dd[k].size > 0:
                    dd[k] = dd[k][keep]

    @staticmethod
    def _assign_v_ids(dd):
        if "camera_id" not in dd:
            return
        pre = (1000000 * dd["camera_id"].astype(np.int64)
               + 10000 * dd["action"].astype(np.int64)
               + 1000 * dd["subaction"].astype(np.int64)
               + dd["p_ids"].astype(np.int64))
        uniq = {u: i for i, u in enumerate(np.unique(pre))}
        dd["v_ids"] = np.asarray([uniq[p] for p in pre], np.int64)

    def _get_split_full(self):
        if self.use_person_split:
            split = {"train": [1, 5, 6, 7, 8], "test": [9, 11]}
            target = self.datadict["p_ids"]
        else:
            if self.action_split_type == "generalize_sitting":
                split = {"train": [2, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 16],
                         "test": [9, 8, 10]}
            elif self.action_split_type == "generalize_walking":
                split = {"train": [2, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 16],
                         "test": [14, 15, 16]}
            else:
                split = {"train": [2, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 16],
                         "test": [8, 12, 13, 14]}
            target = self.datadict["action"]
        return {
            "train": [i for i, e in enumerate(target) if e in split["train"]],
            "test": [i for i, e in enumerate(target) if e in split["test"]],
        }

    # -- normalization -----------------------------------------------------
    def _normalize_poses(self, poses):
        s = self.norm_stats
        out = (poses - s.mean) / s.std
        return out[:, s.dim_to_use].astype(np.float32)

    @property
    def data_mean(self):
        return self.norm_stats.mean

    @property
    def data_std(self):
        return self.norm_stats.std

    @property
    def dim_to_use(self):
        return self.norm_stats.dim_to_use

    @property
    def dim_to_ignore(self):
        return self.norm_stats.dim_to_ignore

    # -- fetchers ----------------------------------------------------------
    def _unnorm_world_kps(self, flat_norm: np.ndarray) -> np.ndarray:
        """normalized 51-d -> (17, 3) world meters."""
        full = unnormalize(flat_norm[None], self.norm_stats)[0]
        return full.reshape(len(self.joint_model.kps_to_use), 3)

    def _project_to_pixels(self, idx: int, kps3d_w: np.ndarray) -> np.ndarray:
        extr = np.asarray(self.datadict["extrinsics_univ"][idx], np.float64)
        intr = np.asarray(self.datadict["intrinsics_univ"][idx], np.float64)
        imsize = np.asarray(self.datadict["image_size"][idx], np.float64)
        cam = kps3d_w @ extr[:, :3].T + extr[:, 3]
        p = cam / cam[:, -1:]
        K = np.array([[intr[0], 0, intr[1]], [0, intr[2], intr[3]],
                      [0, 0, 1.0]])
        px = (p @ K.T)[:, :2]
        scale = np.array([self.spatial_size / imsize[0],
                          self.spatial_size / imsize[1]])
        return px * scale

    def _get_keypoints(self, ids):
        key = self.keypoint_key or "norm_keypoints"
        ids = np.asarray(ids)
        kps = self.datadict[key][ids]
        if self.train_reg and self.keypoint_key == "keypoints_3d_world":
            # reprojected to normalized image coordinates for the regressor
            projected = [
                self._project_to_pixels(int(i), self._unnorm_world_kps(kps[j]))
                / self.spatial_size
                for j, i in enumerate(ids)
            ]
            return np.stack(projected).astype(np.float32).squeeze()
        return kps.astype(np.float32).squeeze() if kps.shape[0] == 1 \
            and self.seq_length == (0, 0) else kps.astype(np.float32)

    def _get_stickman_from_3d(self, ids):
        """The stickman of each frame drawn from its 3D keypoints through
        its camera, lines ``spatial_size // stickman_scale`` thick.  For
        joint angles the keypoints are the forward kinematics' 32 joints
        (float32, mm to m), whose numbering the angle keys' joint model
        uses; the JAX dataset keeps 17 of them there and fails (ROADMAP
        C14)."""
        size = (self.spatial_size, self.spatial_size, 3)
        out = []
        for i in np.asarray(ids):
            kps = self.datadict[self.keypoint_key][int(i)]
            if self.keypoint_key == "keypoints_3d_world":
                kps3d_w = self._unnorm_world_kps(kps)
            else:
                full = unnormalize(kps[None], self.norm_stats)
                kps3d_w = forward_kinematics(torch.from_numpy(
                    np.asarray(full, np.float32)))[0].numpy() / 1000.0
            img = make_joint_img(size, self._project_to_pixels(int(i),
                                                               kps3d_w),
                                 self.joint_model,
                                 line_colors=self.line_colors,
                                 scale_factor=self.stickman_scale)
            out.append(self._to_float(img))
        return self._squeeze_seq(np.stack(out))

    def _get_kps_for_rendering(self, idx: int) -> np.ndarray:
        if self.keypoint_key == "keypoints_3d_world":
            w = self._unnorm_world_kps(self.datadict[self.keypoint_key][idx])
            return self._project_to_pixels(idx, w)
        kps = self.datadict.get("keypoints", self.datadict.get(
            "norm_keypoints"))[idx]
        return np.asarray(kps).reshape(-1, 2)

    def _get_intrinsics(self, ids, use_map_ids=False):
        ids = np.asarray(ids)
        if use_map_ids:
            anchor = int(self.datadict["map_ids"][ids[0]])
            ids = self._sample_valid_seq_ids([anchor, len(ids) - 1])
        return np.squeeze(self.datadict["intrinsics_univ"][ids])

    def _get_extrinsics(self, ids, use_map_ids=False):
        ids = np.asarray(ids)
        if use_map_ids:
            anchor = int(self.datadict["map_ids"][ids[0]])
            ids = self._sample_valid_seq_ids([anchor, len(ids) - 1])
        return self.datadict["extrinsics_univ"][ids]
