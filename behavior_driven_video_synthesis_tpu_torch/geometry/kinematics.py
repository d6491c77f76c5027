"""Forward kinematics over the 32-joint Human3.6M skeleton, on torch
tensors.

Counterpart of ``behavior_driven_video_synthesis_tpu/geometry/
kinematics.py``: the tree constants (parents, the Euler channels'
layout, the bone offsets in mm, which are H3.6M skeleton data) are copied,
since that module imports JAX.  ``forward_kinematics`` walks the static
tree once, batched over any leading axes; ``revert_coordinate_space`` is
a loop over frames carrying the root's rotation and translation (the JAX
package's ``lax.scan``).
"""
from __future__ import annotations

import numpy as np
import torch

from .rotations import euler_to_rotmat, expmap_to_rotmat, rotmat_to_expmap

# Parent of each of the 32 joints (-1 = root), topologically ordered.
H36M_PARENTS = np.array(
    [-1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 0, 11, 12, 13, 14, 12, 16, 17, 18,
     19, 20, 19, 22, 12, 24, 25, 26, 27, 28, 27, 30], dtype=np.int32)

# Bone offsets in millimetres, (32, 3).
H36M_OFFSETS = np.array(
    [[0.0, 0.0, 0.0], [-132.948591, 0.0, 0.0], [0.0, -442.894612, 0.0],
     [0.0, -454.206447, 0.0], [0.0, 0.0, 162.767078],
     [0.0, 0.0, 74.999437], [132.948826, 0.0, 0.0],
     [0.0, -442.894413, 0.0], [0.0, -454.206590, 0.0],
     [0.0, 0.0, 162.767426], [0.0, 0.0, 74.999948], [0.0, 0.1, 0.0],
     [0.0, 233.383263, 0.0], [0.0, 257.077681, 0.0],
     [0.0, 121.134938, 0.0], [0.0, 115.002227, 0.0],
     [0.0, 257.077681, 0.0], [0.0, 151.034226, 0.0],
     [0.0, 278.882773, 0.0], [0.0, 251.733451, 0.0], [0.0, 0.0, 0.0],
     [0.0, 0.0, 99.999627], [0.0, 100.000188, 0.0], [0.0, 0.0, 0.0],
     [0.0, 257.077681, 0.0], [0.0, 151.031437, 0.0],
     [0.0, 278.892924, 0.0], [0.0, 251.728680, 0.0], [0.0, 0.0, 0.0],
     [0.0, 0.0, 99.999888], [0.0, 137.499922, 0.0], [0.0, 0.0, 0.0]],
    dtype=np.float32)

# Per-joint indices into the 78-d Euler (bvh) channel vector; [] = fixed.
H36M_ROT_IND = [
    [4, 5, 3], [7, 8, 6], [10, 11, 9], [13, 14, 12], [16, 17, 15], [],
    [19, 20, 18], [22, 23, 21], [25, 26, 24], [28, 29, 27], [],
    [31, 32, 30], [34, 35, 33], [37, 38, 36], [40, 41, 39], [],
    [43, 44, 42], [46, 47, 45], [49, 50, 48], [52, 53, 51], [55, 56, 54],
    [], [58, 59, 57], [], [61, 62, 60], [64, 65, 63], [67, 68, 66],
    [70, 71, 69], [73, 74, 72], [], [76, 77, 75], [],
]

# Expmap layout of the 99-d angle vector: [:3] root translation, [3:99] 32
# consecutive (3,) exponential maps.
H36M_EXPMAP_IND = [list(range(3 + 3 * i, 6 + 3 * i)) for i in range(32)]
H36M_POS_IND = [0, 1, 2]

N_JOINTS = 32


def _local_rotations_euler(angles):
    """angles (..., 78) in degrees (bvh) -> local rotations (..., 32, 3,
    3)."""
    zeros = torch.zeros(angles.shape[:-1] + (3,), dtype=angles.dtype,
                        device=angles.device)
    eul = [angles[..., ind] if ind else zeros for ind in H36M_ROT_IND]
    return euler_to_rotmat(torch.stack(eul, dim=-2), deg=True, order="zxy")


def forward_kinematics(angles, use_euler: bool = False,
                       use_pos: bool = True):
    """Joint angles -> 3D joint positions (..., 32, 3) in mm.

    ``angles``: (..., 99) expmap channels (the root translation, then 32
    expmaps), or (..., 78) bvh Euler channels in degrees with
    ``use_euler``.  ``use_pos`` adds the root translation (expmap only).
    Row-vector convention: a joint sits at offset @ R_parent + its
    parent's position, and R_global = R_local @ R_parent.
    """
    angles = torch.as_tensor(angles)
    if use_euler:
        local_R = _local_rotations_euler(angles)
    else:
        local_R = expmap_to_rotmat(angles[..., 3:99].reshape(
            angles.shape[:-1] + (N_JOINTS, 3)))
    if use_pos and not use_euler:
        root_pos = angles[..., :3]
    else:
        root_pos = torch.zeros(angles.shape[:-1] + (3,), dtype=angles.dtype,
                               device=angles.device)
    offsets = torch.as_tensor(H36M_OFFSETS, dtype=angles.dtype,
                              device=angles.device)
    xyz = [offsets[0] + root_pos]
    glob_R = [local_R[..., 0, :, :]]
    for i in range(1, N_JOINTS):
        p = int(H36M_PARENTS[i])
        xyz.append(torch.einsum("k,...kj->...j", offsets[i], glob_R[p])
                   + xyz[p])
        glob_R.append(local_R[..., i, :, :] @ glob_R[p])
    return torch.stack(xyz, dim=-2)


def revert_coordinate_space(channels, R0=None, T0=None):
    """(T, 99) expmap channels with the root's rotation and translation
    accumulated frame by frame from ``R0`` (identity) and ``T0`` (zeros):
    the sequence placed for visualization."""
    channels = torch.as_tensor(channels)
    kw = dict(dtype=channels.dtype, device=channels.device)
    R = torch.eye(3, **kw) if R0 is None else torch.as_tensor(R0, **kw)
    T = torch.zeros(3, **kw) if T0 is None else torch.as_tensor(T0, **kw)
    out = []
    for ch in channels:
        R_prev = R
        R = expmap_to_rotmat(ch[3:6]) @ R_prev
        T = T + R_prev.T @ ch[:3]
        out.append(torch.cat([T, rotmat_to_expmap(R), ch[6:]]))
    return torch.stack(out)
