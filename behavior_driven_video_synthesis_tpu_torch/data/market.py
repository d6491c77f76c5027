"""Market-1501: 128 px images, an 18-keypoint joint model in its own
order, and a reflect-pad, rotate and centre-crop augment.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/market.py``: the
``index.p`` dataset of ``data/deepfashion.py`` with ``market_joint_model``
and the augment: reflect-pad by half the size, rotate within +-90
degrees, crop the centre back.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from ..geometry.stickman import JointModel
from .base import _cv2
from .deepfashion import DeepFashionDataset
from .parts import t2p, t3p, t4p


def market_joint_model() -> JointModel:
    return JointModel(
        body=[8, 9, 3, 2],
        right_lines=[(0, 1), (1, 2), (6, 7), (7, 8)],
        left_lines=[(3, 4), (4, 5), (9, 10), (10, 11)],
        head_lines=[],
        face=[(13, 14), (13, 15), (14, 16), (15, 17)],
        rshoulder=8, lshoulder=9, headup=13,
        kps_to_use=list(range(18)),
        total_relative_joints=[],
        kp_to_joint=["rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
                     "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow",
                     "lwrist", "neck", "nose", "leye", "reye", "lear",
                     "rear"],
        norm_T=[t4p, t3p,
                partial(t2p, ids=[0, 1]), partial(t2p, ids=[1, 2]),
                partial(t2p, ids=[6, 7]), partial(t2p, ids=[7, 8]),
                partial(t2p, ids=[3, 4]), partial(t2p, ids=[4, 5]),
                partial(t2p, ids=[9, 10]), partial(t2p, ids=[10, 11])],
    )


class MarketDataset(DeepFashionDataset):
    native_size = 128

    def _joint_model(self) -> JointModel:
        return market_joint_model()

    def _augment(self, img: np.ndarray) -> np.ndarray:
        """Reflect-pad by half the size, rotate within +-90 degrees and
        crop the centre back to the image's size."""
        cv2 = _cv2()
        h, w = img.shape[:2]
        pad = self.spatial_size // 2
        img = cv2.copyMakeBorder(img, pad, pad, pad, pad,
                                 borderType=cv2.BORDER_REFLECT)
        ang = self.rng.uniform(-90, 90)
        hh, ww = img.shape[:2]
        M = cv2.getRotationMatrix2D((ww / 2, hh / 2), ang, 1.0)
        img = cv2.warpAffine(img, M, (ww, hh), flags=cv2.INTER_LINEAR)
        y0, x0 = (hh - h) // 2, (ww - w) // 2
        return img[y0:y0 + h, x0:x0 + w]
