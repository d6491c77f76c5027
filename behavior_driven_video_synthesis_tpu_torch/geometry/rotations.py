"""Batched 3D rotation algebra on torch tensors.

Counterpart of ``behavior_driven_video_synthesis_tpu/geometry/rotations.py``:
every function broadcasts over any leading axes and branches with
``torch.where``, in the conventions of the H3.6M lineage (row vectors,
"zxy" Euler order, expmap = axis * angle).  The dtype is the input's.
"""
from __future__ import annotations

import math

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def _norm(x, dim=-1, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def _matrix(rows):
    """Nested lists of (...) tensors -> (..., len(rows), len(rows[0]))."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_to_rotmat(angles, deg: bool = True, order: str = "zxy"):
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3); ``"zxy"``
    is the H36M bvh convention, ``"xyz"`` Rz @ Ry @ Rx."""
    if deg:
        angles = torch.deg2rad(angles)
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, cy, cz = torch.cos(ax), torch.cos(ay), torch.cos(az)
    sx, sy, sz = torch.sin(ax), torch.sin(ay), torch.sin(az)
    if order == "zxy":
        return _matrix([
            [cy * cz - sx * sy * sz, cy * sz + sx * sy * cz, -sy * cx],
            [-cx * sz, cx * cz, sx],
            [sy * cz + cy * sx * sz, sy * sz - cy * sx * cz, cy * cx]])
    if order == "xyz":
        zero, one = torch.zeros_like(cx), torch.ones_like(cx)
        rz = _matrix([[cz, sz, zero], [-sz, cz, zero], [zero, zero, one]])
        ry = _matrix([[cy, zero, -sy], [zero, one, zero], [sy, zero, cy]])
        rx = _matrix([[one, zero, zero], [zero, cx, sx], [zero, -sx, cx]])
        return rz @ ry @ rx
    raise NotImplementedError(f"euler order {order}")


def rotmat_to_euler(R):
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3) in radians;
    where |R[0, 2]| is 1 (gimbal lock) the third angle is 0."""
    r02 = torch.clamp(R[..., 0, 2], -1.0, 1.0)
    locked = torch.abs(torch.abs(r02) - 1.0) < 1e-12
    e2 = -torch.asin(r02)
    c2 = torch.cos(e2)
    safe_c2 = torch.where(torch.abs(c2) < _EPS, torch.ones_like(c2), c2)
    e1 = torch.atan2(R[..., 1, 2] / safe_c2, R[..., 2, 2] / safe_c2)
    e3 = torch.atan2(R[..., 0, 1] / safe_c2, R[..., 0, 0] / safe_c2)
    dlta = torch.atan2(R[..., 0, 1], R[..., 0, 2])
    half_pi = torch.full_like(r02, math.pi / 2)
    e1 = torch.where(locked, dlta, e1)
    e2 = torch.where(locked, torch.where(r02 < 0, half_pi, -half_pi), e2)
    e3 = torch.where(locked, torch.zeros_like(e3), e3)
    return torch.stack([e1, e2, e3], dim=-1)


def rotmat_to_quat(R):
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) as (w, x, y,
    z), from the skew-symmetric part (stable for angles in [0, pi])."""
    rotdiff = R - R.transpose(-1, -2)
    r = torch.stack([-rotdiff[..., 1, 2], rotdiff[..., 0, 2],
                     -rotdiff[..., 0, 1]], dim=-1)
    sintheta = _norm(r) / 2.0
    r0 = r / (_norm(r, keepdim=True) + _EPS)
    costheta = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    theta = torch.atan2(sintheta, costheta)
    w = torch.cos(theta / 2.0)[..., None]
    return torch.cat([w, r0 * torch.sin(theta / 2.0)[..., None]], dim=-1)


def quat_to_expmap(q):
    """Quaternions (..., 4) -> exponential maps (..., 3), angle in [0,
    pi]."""
    sinhalf = _norm(q[..., 1:])
    r0 = q[..., 1:] / (_norm(q[..., 1:], keepdim=True) + _EPS)
    theta = 2.0 * torch.atan2(sinhalf, q[..., 0])
    theta = torch.remainder(theta + 2.0 * math.pi, 2.0 * math.pi)
    flip = theta > math.pi
    theta = torch.where(flip, 2.0 * math.pi - theta, theta)
    r0 = torch.where(flip[..., None], -r0, r0)
    return r0 * theta[..., None]


def expmap_to_rotmat(r):
    """Exponential maps (..., 3) -> rotation matrices (..., 3, 3)
    (Rodrigues)."""
    theta = _norm(r)
    r0 = r / (theta[..., None] + _EPS)
    zero = torch.zeros_like(theta)
    K = _matrix([[zero, -r0[..., 2], r0[..., 1]],
                 [r0[..., 2], zero, -r0[..., 0]],
                 [-r0[..., 1], r0[..., 0], zero]])
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    st = torch.sin(theta)[..., None, None]
    ct = (1.0 - torch.cos(theta))[..., None, None]
    return eye + st * K + ct * (K @ K)


def rotmat_to_expmap(R):
    return quat_to_expmap(rotmat_to_quat(R))
