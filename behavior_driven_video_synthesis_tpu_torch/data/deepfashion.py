"""The DeepFashion 18-keypoint (OpenPose) joint model.

Counterpart of ``deepfashion_joint_model`` in
``behavior_driven_video_synthesis_tpu/data/deepfashion.py``, without the
part warps (``norm_T``), which this package does not port yet.
"""
from ..geometry.stickman import JointModel


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
    )
