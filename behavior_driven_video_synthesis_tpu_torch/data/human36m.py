"""Human3.6M joint-model constants of the serving path.

Counterpart of ``detailed_joint_model`` in
``behavior_driven_video_synthesis_tpu/data/human36m.py``, without the
``norm_T`` part-warp specs (the inplane part stacks are not ported).  The
constants are copied rather than imported because that module pulls in
the JAX geometry stack.
"""
from __future__ import annotations

from ..geometry.stickman import JointModel


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
    )
