"""Camera transforms: world->camera affine + pinhole projection.

Counterpart of ``behavior_driven_video_synthesis_tpu/geometry/camera.py``.
The 3x3/3x4 products are written as broadcast multiply-adds in f32, so no
TF32 path can touch them.
"""
from __future__ import annotations

import torch


def apply_affine_transform(x, M):
    """R x + t with M = [R | t]: x (..., 3), M (..., 3, 4) -> (..., 3)."""
    R = M[..., :, :3]
    t = M[..., :, 3]
    return torch.sum(R * x[..., None, :], dim=-1) + t


def intrinsics_matrix(camera_parameters):
    """(f_x, x_0, f_y, y_0) -> 3x3 intrinsic matrix, batched."""
    cp = camera_parameters
    f_x, x_0, f_y, y_0 = cp[..., 0], cp[..., 1], cp[..., 2], cp[..., 3]
    zero, one = torch.zeros_like(f_x), torch.ones_like(f_x)
    return torch.stack([
        torch.stack([f_x, zero, x_0], -1),
        torch.stack([zero, f_y, y_0], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)


def camera_projection(poses, camera_parameters):
    """Pinhole projection: poses (..., K, 3) camera-frame points,
    camera_parameters (..., 4) -> (..., K, 2) pixel coordinates."""
    K = intrinsics_matrix(camera_parameters)
    poses3d = poses / poses[..., -1:]
    proj = torch.sum(K[..., None, :, :] * poses3d[..., None, :], dim=-1)
    return proj[..., :2]


def project_world_to_image(world_points, extrinsics, camera_parameters):
    """world (..., K, 3) -> pixels (..., K, 2) via [R|t] then pinhole."""
    cam = apply_affine_transform(world_points, extrinsics[..., None, :, :])
    return camera_projection(cam, camera_parameters)
