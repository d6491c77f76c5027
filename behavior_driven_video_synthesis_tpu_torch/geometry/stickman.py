"""Stickman rasterization on the device.

Counterpart of the device rasterizer of
``behavior_driven_video_synthesis_tpu/geometry/stickman.py``: a distance
field thresholded at half the line thickness for the limbs, a
crossing-number test for the body polygon, the reference's colour scheme
(right limbs channel 1, left limbs channel 0, head channels 0+1 at 127,
body (0, 127, 255) under the lines).  Joints with a negative coordinate are
invalid and skipped.

Frames render in chunks and lines one at a time, so the intermediates are
(chunk, S, S) rather than the (frames, lines, S, S) that a direct
translation of the vmapped JAX code would hold (3 GB each at 1000 frames
of 256 px).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence, Tuple

import torch


@dataclass(frozen=True)
class JointModel:
    """Skeleton topology + rendering metadata; ``norm_T`` lists the part
    homography builders of the in-plane part stack (``data/parts.py``)."""

    body: Sequence[int]
    right_lines: Sequence[Tuple[int, int]]
    left_lines: Sequence[Tuple[int, int]]
    head_lines: Sequence[Tuple[int, int]]
    face: Sequence[Tuple[int, int]]
    rshoulder: int
    lshoulder: int
    headup: int
    kps_to_use: Sequence[int]
    total_relative_joints: Sequence[Tuple[int, int]]
    kp_to_joint: Sequence[str]
    kps_to_change: Sequence[int] = field(default_factory=list)
    kps_to_change_rel: Sequence[int] = field(default_factory=list)
    norm_T: Sequence[Callable] = field(default_factory=list)


def _segment_coverage(px, py, a, b, half_thickness):
    """px, py: (S, S) pixel centres; a, b: (N, 2) segment ends.  Returns
    (N, S, S) coverage in {0, 1}."""
    ax, ay = a[:, 0, None, None], a[:, 1, None, None]
    abx = (b[:, 0] - a[:, 0])[:, None, None]
    aby = (b[:, 1] - a[:, 1])[:, None, None]
    pa_x = px[None] - ax
    pa_y = py[None] - ay
    denom = abx * abx + aby * aby + 1e-8
    t = torch.clamp((pa_x * abx + pa_y * aby) / denom, 0.0, 1.0)
    dx = pa_x - t * abx
    dy = pa_y - t * aby
    dist = torch.sqrt(dx * dx + dy * dy)
    return (dist <= half_thickness).float()


def lines_coverage(j, lines, px, py, half):
    """Union of the valid segments ``lines`` of joints j (N, K, 2)."""
    cov = torch.zeros((j.shape[0],) + px.shape, dtype=torch.float32,
                      device=j.device)
    for ia, ib in lines:
        a, b = j[:, ia], j[:, ib]
        valid = ((a >= 0.0).all(-1) & (b >= 0.0).all(-1)).float()
        cov = torch.maximum(cov, _segment_coverage(px, py, a, b, half)
                            * valid[:, None, None])
    return cov


def polygon_mask(px, py, verts, valid):
    """Crossing-number point-in-polygon; verts (N, V, 2), valid (N, V).
    An edge touching an invalid vertex is skipped."""
    V = verts.shape[1]
    inside = torch.zeros((verts.shape[0],) + px.shape, dtype=torch.bool,
                         device=verts.device)
    for i in range(V):
        j = (i - 1) % V
        xi, yi = verts[:, i, 0, None, None], verts[:, i, 1, None, None]
        xj, yj = verts[:, j, 0, None, None], verts[:, j, 1, None, None]
        cond = ((yi > py) != (yj > py)) & (
            px < (xj - xi) * (py - yi) / (yj - yi + 1e-8) + xi)
        edge_ok = (valid[:, i] & valid[:, j])[:, None, None]
        inside = inside ^ (cond & edge_ok)
    return inside


def _render_frames(j, joint_model: JointModel, px, py, half):
    r_cov = lines_coverage(j, joint_model.right_lines, px, py, half)
    l_cov = lines_coverage(j, joint_model.left_lines, px, py, half)
    if len(joint_model.head_lines):
        h_cov = lines_coverage(j, joint_model.head_lines, px, py, half)
    else:
        rs, ls = j[:, joint_model.rshoulder], j[:, joint_model.lshoulder]
        cn = j[:, joint_model.headup]
        neck = 0.5 * (rs + ls)
        ok = (torch.stack([rs, ls, cn], 1) >= 0.0).flatten(1).all(-1)
        h_cov = (_segment_coverage(px, py, neck, cn, half)
                 * ok.float()[:, None, None])
    verts = j[:, list(joint_model.body)]
    bvalid = (verts >= 0.0).all(-1)
    poly = (polygon_mask(px, py, verts, bvalid)
            & (bvalid.sum(-1) > 2)[:, None, None]).float()
    ch0 = torch.maximum(l_cov * 255.0, h_cov * 127.0)
    ch1 = torch.maximum(r_cov * 255.0, h_cov * 127.0)
    # the body polygon goes under the lines (cv2 draws it first)
    ch1 = torch.maximum(ch1, poly * 127.0)
    ch2 = poly * 255.0
    return torch.stack([ch0, ch1, ch2], dim=-1)


def render_stickman(joints, joint_model: JointModel, spatial_size: int,
                    thickness: float = 1.0, frames_per_chunk: int = 128):
    """joints (..., K, 2) pixel coordinates -> (..., S, S, 3) f32 image on a
    0..255 scale, rendered ``frames_per_chunk`` frames at a time."""
    flat = joints.reshape((-1,) + tuple(joints.shape[-2:])).float()
    grid = torch.arange(spatial_size, dtype=torch.float32,
                        device=joints.device) + 0.5
    py, px = torch.meshgrid(grid, grid, indexing="ij")
    out = torch.empty((flat.shape[0], spatial_size, spatial_size, 3),
                      dtype=torch.float32, device=joints.device)
    for s in range(0, flat.shape[0], frames_per_chunk):
        out[s:s + frames_per_chunk] = _render_frames(
            flat[s:s + frames_per_chunk], joint_model, px, py,
            thickness / 2.0)
    return out.reshape(tuple(joints.shape[:-2]) + out.shape[1:])
