"""DeepFashion: the 18-keypoint (OpenPose) joint model and the dataset of
single images.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/deepfashion.py``:
the joint model with its part warps (``norm_T``: the body, the head and
eight limb segments), and ``DeepFashionDataset``, which reads an
``index.p`` pickle (``imgs`` paths relative to ``datapath``, ``joints``
normalized to [0, 1], ``train`` flags), keeps the images whose four body
keypoints are all valid, gives every image person 0, shuffles the
appearance map uniformly (no label transfer) and, when in-plane
normalization is off, adds ``pose_img_inplane``: the pose image under a
random affine (cv2 ``warpAffine``, white fill).  The draws come from the
dataset's ``RandomState(data_seed)`` in the JAX dataset's order.
"""
from __future__ import annotations

import pickle
from functools import partial
from os import path

import numpy as np

from ..geometry.stickman import JointModel
from .base import BaseDataset, _cv2
from .parts import t2p, t3p, t4p


def deepfashion_joint_model() -> JointModel:
    return JointModel(
        body=[8, 2, 5, 11],
        right_lines=[(10, 9), (9, 8), (2, 3), (3, 4)],
        left_lines=[(13, 12), (12, 11), (5, 6), (6, 7)],
        head_lines=[],
        face=[(0, 14), (0, 15), (14, 16), (15, 17)],
        rshoulder=2, lshoulder=5, headup=0,
        kps_to_use=list(range(18)),
        total_relative_joints=[],
        kp_to_joint=["nose", "neck", "rshoulder", "relbow", "rwrist",
                     "lshoulder", "lelbow", "lwrist", "rhip", "rknee",
                     "rankle", "lhip", "lknee", "lfoot", "reye", "leye",
                     "rear", "lear"],
        norm_T=[t4p, t3p,
                partial(t2p, ids=[2, 3]), partial(t2p, ids=[3, 4]),
                partial(t2p, ids=[5, 6]), partial(t2p, ids=[6, 7]),
                partial(t2p, ids=[8, 9]), partial(t2p, ids=[9, 10]),
                partial(t2p, ids=[11, 12]), partial(t2p, ids=[12, 13])],
    )


class DeepFashionDataset(BaseDataset):
    native_size = 256

    def __init__(self, transforms, data_keys, seq_length, mode="train",
                 **kwargs):
        self.random_rotation = not kwargs.get("inplane_normalize", False)
        super().__init__(transforms, mode, seq_length, data_keys,
                         joint_model=self._joint_model(), **kwargs)
        self.label_transfer = False
        self.datapath = kwargs.get("datapath", "")
        if self.random_rotation:
            self._output_dict["pose_img_inplane"] = self._get_pose_image_rot
            if "pose_img_inplane" not in self.datakeys:
                self.datakeys.append("pose_img_inplane")
        if self.datapath and path.exists(path.join(self.datapath,
                                                   "index.p")):
            with open(path.join(self.datapath, "index.p"), "rb") as f:
                self.data = pickle.load(f)
            self.populate_from_index(self.data, self.datapath)

    def _joint_model(self) -> JointModel:
        return deepfashion_joint_model()

    def populate_from_index(self, data, datapath: str = ""):
        """Fill the columns from an ``index.p`` dict."""
        joints = np.asarray(data["joints"])
        indices = np.asarray(
            [i for i in range(len(data["train"]))
             if self._filter(joints[i])], np.int64)
        dd = self.datadict
        dd["img_paths"] = np.asarray(
            [path.join(datapath, p) for p in data["imgs"]],
            dtype=object)[indices]
        dd["norm_keypoints"] = joints[indices]
        dd["keypoints"] = joints[indices] * self.native_size
        dd["img_size"] = np.full((indices.size, 2), self.native_size)
        dd["p_ids"] = np.zeros(indices.size, np.int64)
        self.person_ids = [0]
        dd["train"] = np.asarray(data["train"], bool)[indices]
        dd["action"] = np.zeros(indices.size, np.int64)
        dd["v_ids"] = np.zeros(indices.size, np.int64)

        keep = dd["train"] if self.mode == "train" else ~dd["train"]
        self.datadict = {k: v[keep] for k, v in dd.items()
                         if np.asarray(v).size > 0}
        self.datadict["map_ids"] = np.arange(len(self))
        self._get_sequence_start_ids()
        self._get_sequence_end_ids()
        self.resample_map_ids()

    def _filter(self, joints) -> bool:
        body = np.float32(joints[np.asarray(self.joint_model.body)])
        return bool(np.all(body >= 0))

    def resample_map_ids(self):
        """A uniform shuffle of the appearance map (no label transfer)."""
        if "map_ids" in self.datadict and self.datadict["map_ids"].size:
            self.rng.shuffle(self.datadict["map_ids"])

    def _get_kps_for_rendering(self, idx: int) -> np.ndarray:
        return (self.datadict["norm_keypoints"][idx]
                * self.spatial_size).astype(np.float64)

    def _augment(self, img: np.ndarray) -> np.ndarray:
        """A random affine: rotation within +-30 degrees, scale 0.7-1,
        x-translation within 30 % of the width, white fill."""
        cv2 = _cv2()
        h, w = img.shape[:2]
        ang = self.rng.uniform(-30, 30)
        scale = self.rng.uniform(0.7, 1.0)
        tx = self.rng.uniform(-0.3, 0.3) * w
        M = cv2.getRotationMatrix2D((w / 2, h / 2), ang, scale)
        M[0, 2] += tx
        return cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(255, 255, 255))

    def _get_pose_image_rot(self, ids):
        return self._squeeze_seq(np.stack(
            [self._to_float(self._augment(self._prep_image(int(i))))
             for i in np.asarray(ids)]))
