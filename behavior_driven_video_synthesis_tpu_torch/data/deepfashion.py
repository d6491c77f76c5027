"""The DeepFashion 18-keypoint (OpenPose) joint model.

Counterpart of ``deepfashion_joint_model`` in
``behavior_driven_video_synthesis_tpu/data/deepfashion.py``, with its part
warps (``norm_T``: the body, the head and eight limb segments).
"""
from functools import partial

from ..geometry.stickman import JointModel
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
