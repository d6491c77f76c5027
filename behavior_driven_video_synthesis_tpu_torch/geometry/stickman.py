"""Stickman rasterization: on the device, and on the host with cv2.

Counterpart of the device rasterizer of
``behavior_driven_video_synthesis_tpu/geometry/stickman.py``: a distance
field thresholded at half the line thickness for the limbs, a
crossing-number test for the body polygon, the reference's colour scheme
(right limbs channel 1, left limbs channel 0, head channels 0+1 at 127,
body (0, 127, 255) under the lines).  Joints with a negative coordinate are
invalid and skipped.

On a CUDA device :func:`render_stickman` is one launch of the raster
kernel (``ops/cuda/stickman.py``, ``csrc/stickman.cu``) over all frames,
bit-equal to :func:`render_stickman_plain` run on the card.  The plain
version, the CPU path, renders frames in chunks and lines one at a time,
so the intermediates are (chunk, S, S) rather than the (frames, lines, S,
S) that a direct translation of the vmapped JAX code would hold (3 GB each
at 1000 frames of 256 px).

The host stickman (:func:`make_joint_img`, :func:`get_line_colors`) is
the JAX package's cv2 rendering (``geometry/stickman.py:58-150``), line
for line, so the image datasets' stickmen are bit-equal to the JAX
package's; it needs OpenCV (``cv2``), imported when it runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda import stickman as stickman_kernel


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
                    thickness: float = 1.0, frames_per_chunk: int = 128,
                    normalized: bool = False):
    """joints (..., K, 2) pixel coordinates -> (..., S, S, 3) f32 image on a
    0..255 scale, or with ``normalized`` the VUNet's bf16 input (stick -
    127.5) / 127.5.  CUDA joints launch the raster kernel once; others
    take :func:`render_stickman_plain` (``frames_per_chunk`` frames at a
    time)."""
    if joints.device.type == "cuda":
        return stickman_kernel.stickman_raster(
            joints, joint_model, spatial_size, thickness, normalized)
    return render_stickman_plain(joints, joint_model, spatial_size,
                                 thickness, frames_per_chunk, normalized)


def render_stickman_plain(joints, joint_model: JointModel,
                          spatial_size: int, thickness: float = 1.0,
                          frames_per_chunk: int = 128,
                          normalized: bool = False):
    """:func:`render_stickman` in eager PyTorch on any device, rendered
    ``frames_per_chunk`` frames at a time."""
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
    if normalized:
        # The JAX package writes stick / 127.5 - 1; for stick = 127 that
        # lies within an f32 rounding error of a bf16 rounding midpoint, and
        # CUDA divides by a scalar as a reciprocal multiply, which lands on
        # the other side.  (stick - 127.5) / 127.5 gives the same bf16
        # values as the JAX package either way.
        out = ((out - 127.5) / 127.5).to(torch.bfloat16)
    return out.reshape(tuple(joints.shape[:-2]) + out.shape[1:])


# -- the host stickman -------------------------------------------------------
def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the host stickman (make_joint_img) draws with "
                          "OpenCV, and cv2 is not installed") from e
    return cv2


def get_line_colors(n_lines_per_channel):
    """One colour per line: for channel i with n lines, line j gets
    ``(j + 1) * (255 // (n + 1))`` in channel i and 0 elsewhere (a
    dataset's ``diff_line_colors``)."""
    line_colors = []
    for channel, nr_lines in enumerate(n_lines_per_channel):
        interval = int(255 // (nr_lines + 1))
        line_colors.append(
            [[(i + 1) * interval if c == channel else 0 for c in range(3)]
             for i in range(nr_lines)])
    return line_colors


def make_joint_img(img_shape, joints, joint_model: JointModel,
                   line_colors=None, color_channel=None,
                   scale_factor=None) -> np.ndarray:
    """The stickman of ``joints`` (K, 2) pixel coordinates drawn with cv2
    into a uint8 image of ``img_shape``: the body polygon filled (0, 127,
    255), right limbs in channel 1, left limbs in channel 0, head lines in
    channels 0 and 1 at 127, lines ``img_shape[1] // scale_factor`` thick
    (1 without a factor); a joint with a negative coordinate is skipped.
    ``line_colors`` from :func:`get_line_colors` colours lines one by one
    (group 0 the right lines, 1 the left, 2 the head); ``color_channel``
    draws everything at 255 into that channel alone."""
    cv2 = _cv2()
    thickness = (int(img_shape[1] // scale_factor)
                 if scale_factor is not None else 1)
    imgs = [np.zeros(img_shape[:2], dtype="uint8") for _ in range(3)]

    def draw_line(a_idx, b_idx, channel_colors):
        pts = joints[[a_idx, b_idx], :]
        if np.all(pts >= 0.0):
            a = tuple(int(v) for v in pts[0])
            b = tuple(int(v) for v in pts[1])
            for ch, col in channel_colors:
                cv2.line(imgs[ch], a, b, color=col, thickness=thickness)

    def colours(group, line_nr, default):
        if color_channel is not None:
            return [(color_channel, 255)]
        if line_colors is None:
            return default
        col = line_colors[group][line_nr]
        ch = int(np.nonzero(col)[0][0])
        return [(ch, col[ch])]

    if len(joint_model.body) > 2:
        body_pts = np.array([[joints[p, :] for p in joint_model.body]])
        valid = np.all(body_pts >= 0.0, axis=-1)
        if np.count_nonzero(valid) > 2:
            poly = np.int_([body_pts[valid]])
            if color_channel is None:
                for i, c in enumerate((0, 127, 255)):
                    cv2.fillPoly(imgs[i], poly, c)
            else:
                cv2.fillPoly(imgs[color_channel], poly, 255)

    for line_nr, line in enumerate(joint_model.right_lines):
        draw_line(line[0], line[1], colours(0, line_nr, [(1, 255)]))
    for line_nr, line in enumerate(joint_model.left_lines):
        draw_line(line[0], line[1], colours(1, line_nr, [(0, 255)]))

    if len(joint_model.head_lines) == 0:
        rs = joints[joint_model.rshoulder, :]
        ls = joints[joint_model.lshoulder, :]
        cn = joints[joint_model.headup, :]
        if np.all(rs >= 0) and np.all(ls >= 0):
            neck = 0.5 * (rs + ls)
            if np.all(neck >= 0) and np.all(cn >= 0):
                a = tuple(int(v) for v in neck)
                b = tuple(int(v) for v in cn)
                if color_channel is None:
                    cv2.line(imgs[0], a, b, color=127, thickness=thickness)
                    cv2.line(imgs[1], a, b, color=127, thickness=thickness)
                else:
                    cv2.line(imgs[color_channel], a, b, color=255,
                             thickness=thickness)
    else:
        for line_nr, line in enumerate(joint_model.head_lines):
            draw_line(line[0], line[1],
                      colours(2, line_nr, [(0, 127), (1, 127)]))

    img = np.stack(imgs, axis=-1)
    if img_shape[-1] == 1:
        img = np.mean(img, axis=-1)[:, :, None]
    return img
