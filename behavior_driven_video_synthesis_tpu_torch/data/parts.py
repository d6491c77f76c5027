"""In-plane part stacks: each body part warped to a square, 10 parts x 3
channels stacked into the original VUNet's 30-channel appearance.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/parts.py``.  The
homography builders ``t5p``, ``t4p``, ``t3p`` and ``t2p`` take the same
points in the same float32 casts; the 8x8 system of OpenCV's
``getPerspectiveTransform`` is solved here in float64 numpy
(:func:`perspective_transform`), so nothing needs cv2.  A part whose
transform is undefined (invisible keypoints, a degenerate body, or a
singular system) comes out black.

The warp runs on the device for all frames and parts at once
(:func:`warp_parts`): each output pixel maps to the source through M^-1,
samples bilinearly with the coordinates clamped to the image (OpenCV's
``BORDER_REPLICATE``), and rounds to uint8.  :func:`warp_parts_plain` is
the same warp as a float64 numpy loop over frames and parts, the
reference the device warp is held against.

The image datasets (``data/base.py``) stack the parts of real images the
same way (the JAX package's ``normalize_parts``): a dataset leaves each
item's uint8 image and homographies in the batch under
``<key>:parts_src``, ``:parts_mats`` and ``:parts_valid``, which
:func:`finish_part_stacks` turns into the stacks with one device gather
per batch.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

_UNIT_SQUARE = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
_UNIT_SQUARE_T = np.float32([[0, 0], [0, 1], [1, 1], [1, 0]])


def perspective_transform(src, dst) -> Optional[np.ndarray]:
    """The 3x3 homography taking 4 points ``src`` to ``dst`` (float32
    (4, 2) each), solved as ``cv2.getPerspectiveTransform`` sets up its
    8x8 system, in float64; None if the system is singular."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = np.zeros((8, 8))
    a[:4, 0:2] = a[4:, 3:5] = src
    a[:4, 2] = a[4:, 5] = 1.0
    a[:4, 6:8] = -src * dst[:, :1]
    a[4:, 6:8] = -src * dst[:, 1:]
    try:
        x = np.linalg.solve(a, np.concatenate([dst[:, 0], dst[:, 1]]))
    except np.linalg.LinAlgError:
        return None
    return np.append(x, 1.0).reshape(3, 3)


def _valid(pts) -> bool:
    return bool(np.all(np.asarray(pts) >= 0))


def t5p(kps, jm, wh, oh):
    """The body quadrangle of a 5-point body (the neck's intersections
    with the hip-shoulder lines); None when either is parallel."""
    part_kps = kps[np.asarray(jm.body), :2]
    neck = part_kps[2]
    ls_to_rs = part_kps[1] - part_kps[3]
    rh_to_rs = part_kps[1] - part_kps[0]
    lh_to_ls = part_kps[3] - part_kps[-1]
    rhip, lhip = part_kps[0], part_kps[-1]

    den_l = ls_to_rs[1] * lh_to_ls[0] - ls_to_rs[0] * lh_to_ls[1]
    den_r = ls_to_rs[1] * rh_to_rs[0] - ls_to_rs[0] * rh_to_rs[1]
    if abs(den_l) < 1e-8 or abs(den_r) < 1e-8:
        return None
    lambda_l = ((lhip[1] - neck[1]) * lh_to_ls[0]
                + (neck[0] - lhip[0]) * lh_to_ls[1]) / den_l
    lambda_r = ((rhip[1] - neck[1]) * rh_to_rs[0]
                + (neck[0] - rhip[0]) * rh_to_rs[1]) / den_r

    p1 = (neck + lambda_r * ls_to_rs).astype(np.float32)
    p2 = (neck + lambda_l * ls_to_rs).astype(np.float32)
    points_src = np.float32([p1, p2, lhip, rhip])
    return perspective_transform(points_src, _UNIT_SQUARE * np.float32(wh))


def t4p(kps, jm, wh, oh):
    """The body of a 4-point body."""
    points_src = np.float32(kps[np.asarray(jm.body)])
    return perspective_transform(points_src, _UNIT_SQUARE * np.float32(wh))


def t3p(kps, jm, wh, oh):
    """The head box from the shoulders and the head point; from the
    shoulder segment alone when a head point is invalid."""
    head_pts = np.asarray([kps[jm.rshoulder], kps[jm.lshoulder],
                           kps[jm.headup]])
    if not _valid(head_pts):
        part_src = np.float32(kps[[jm.lshoulder, jm.rshoulder,
                                   jm.rshoulder]])
        if not _valid(part_src):
            return None
        segment = part_src[1] - part_src[0]
        normal = np.array([-segment[1], segment[0]])
        if normal[1] > 0.0:
            normal = -normal
        a = part_src[0] + normal
        b = part_src[0]
        c = part_src[1]
        d = part_src[1] + normal
    else:
        neck = 0.5 * (kps[jm.rshoulder] + kps[jm.lshoulder])
        neck_to_nose = kps[jm.headup] - neck
        part_src = np.float32([neck + 2 * neck_to_nose, neck])
        segment = part_src[1] - part_src[0]
        normal = np.array([-segment[1], segment[0]])
        alpha = 0.5
        a = part_src[0] + alpha * normal
        b = part_src[0] - alpha * normal
        c = part_src[1] - alpha * normal
        d = part_src[1] + alpha * normal
    points_src = np.float32([b, c, d, a])
    return perspective_transform(points_src,
                                 _UNIT_SQUARE_T * np.float32(wh))


def t2p(kps, ids, wh, oh, jm=None):
    """A limb box from two keypoints; from the one visible point down to
    the image's bottom row when the other is invalid.  The destination
    square is offset by -1."""
    pts = kps[np.asarray(ids)]
    if np.any(np.all(pts <= 0.0, axis=1)):
        nni = np.nonzero(np.all(pts > 0.0, axis=1))[0]
        if nni.size == 0:
            return None
        a0 = kps[ids[int(nni[0])]]
        b0 = np.float32([a0[0], oh - 1])
        ends = np.asarray([a0, b0], dtype=np.float32)
    else:
        ends = kps[np.asarray(ids[:2])]
    segment = ends[1] - ends[0]
    normal = np.array([-segment[1], segment[0]])
    alpha = 0.25
    points_src = np.float32([ends[0] + alpha * normal,
                             ends[0] - alpha * normal,
                             ends[1] - alpha * normal,
                             ends[1] + alpha * normal])
    points_dst = _UNIT_SQUARE_T * np.float32(wh) - 1.0
    return perspective_transform(points_src, points_dst)


def default_norm_T(jm) -> List[Callable]:
    """The 10 parts of the detailed Human3.6M joint model: head, body and
    8 limb segments, indexed in the 32-joint layout."""
    return [
        t3p,
        t5p,
        partial(t2p, ids=[25, 26]),
        partial(t2p, ids=[26, 30]),
        partial(t2p, ids=[17, 18]),
        partial(t2p, ids=[18, 22]),
        partial(t2p, ids=[1, 2]),
        partial(t2p, ids=[2, 3]),
        partial(t2p, ids=[6, 7]),
        partial(t2p, ids=[7, 8]),
    ]


def part_transforms(kps_frames: Sequence[np.ndarray], joint_model,
                    part_size: int, image_height: int):
    """The homographies of every part of every frame: (N, P, 3, 3)
    float64 (identity where undefined) and validity (N, P) bool."""
    wh = (part_size, part_size)
    n, p = len(kps_frames), len(joint_model.norm_T)
    mats = np.tile(np.eye(3), (n, p, 1, 1))
    valid = np.zeros((n, p), bool)
    for i, kps in enumerate(kps_frames):
        for j, t_fn in enumerate(joint_model.norm_T):
            T = t_fn(kps, jm=joint_model, wh=wh, oh=image_height)
            if T is not None:
                mats[i, j], valid[i, j] = T, True
    return mats, valid


def _inverse(mats):
    """M^-1 of each homography, float64; a singular M maps to zeros."""
    out = np.zeros_like(mats)
    ok = np.abs(np.linalg.det(mats)) > 0
    out[ok] = np.linalg.inv(mats[ok])
    return out


def warp_parts(imgs: torch.Tensor, mats: np.ndarray, valid: np.ndarray,
               part_size: int) -> torch.Tensor:
    """imgs (N, H, W, 3) uint8 on any device, mats (N, P, 3, 3) and valid
    (N, P) from :func:`part_transforms` -> (N, part_size, part_size, 3P)
    uint8 on imgs' device, all frames and parts in one pass: bilinear taps
    at M^-1 (u, v, 1) of each output pixel, coordinates clamped to the
    image, rounded half up; undefined parts black."""
    N, H, W, C = imgs.shape
    P, dev = mats.shape[1], imgs.device
    minv = torch.as_tensor(_inverse(mats), dtype=torch.float32, device=dev)
    r = torch.arange(part_size, dtype=torch.float32, device=dev)
    v, u = torch.meshgrid(r, r, indexing="ij")
    dst = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    src = torch.einsum("npij,kj->npki", minv, dst)       # (N, P, ps², 3)
    w = src[..., 2]
    w = torch.where(w != 0, 1.0 / w, torch.zeros_like(w))
    x = (src[..., 0] * w).clamp(0, W - 1)
    y = (src[..., 1] * w).clamp(0, H - 1)
    x0, y0 = x.floor(), y.floor()
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = imgs.reshape(N, H * W, C).float()

    def tap(yy, xx):
        idx = (yy * W + xx).reshape(N, -1, 1).expand(-1, -1, C)
        return flat.gather(1, idx).reshape(N, P, -1, C)
    val = ((tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx) * (1 - fy)
           + (tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx) * fy)
    out = torch.floor(val + 0.5).clamp(0, 255)
    out = out * torch.as_tensor(valid, device=dev)[:, :, None, None]
    out = out.reshape(N, P, part_size, part_size, C)
    return out.permute(0, 2, 3, 1, 4).reshape(
        N, part_size, part_size, P * C).to(torch.uint8)


def warp_parts_plain(imgs: np.ndarray, mats: np.ndarray, valid: np.ndarray,
                     part_size: int) -> np.ndarray:
    """:func:`warp_parts` as a float64 numpy loop over frames and parts,
    on the host."""
    imgs = np.asarray(imgs)
    N, H, W, C = imgs.shape
    r = np.arange(part_size, dtype=np.float64)
    v, u = np.meshgrid(r, r, indexing="ij")
    dst = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3)
    out = np.zeros((N, part_size, part_size, C * mats.shape[1]), np.uint8)
    for i in range(N):
        img = imgs[i].astype(np.float64)
        for j in range(mats.shape[1]):
            if not valid[i, j]:
                continue
            src = dst @ _inverse(mats[i, j][None])[0].T
            w = np.where(src[:, 2] != 0, 1.0 / np.where(
                src[:, 2] != 0, src[:, 2], 1.0), 0.0)
            x = np.clip(src[:, 0] * w, 0, W - 1)
            y = np.clip(src[:, 1] * w, 0, H - 1)
            x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
            x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
            fx, fy = (x - x0)[:, None], (y - y0)[:, None]
            val = ((img[y0, x0] * (1 - fx) + img[y0, x1] * fx) * (1 - fy)
                   + (img[y1, x0] * (1 - fx) + img[y1, x1] * fx) * fy)
            out[i, :, :, C * j:C * (j + 1)] = np.clip(
                np.floor(val + 0.5), 0, 255).reshape(part_size, part_size,
                                                     C)
    return out


class PartStackSource(NamedTuple):
    """What a part stack is made from: uint8 images (..., S, S, 3) and
    their homographies (..., P, 3, 3) and validity (..., P)."""
    src: np.ndarray
    mats: np.ndarray
    valid: np.ndarray


PART_SUFFIXES = (":parts_src", ":parts_mats", ":parts_valid")


def part_stack_source(imgs: Sequence[np.ndarray], kps: Sequence[np.ndarray],
                      joint_model, part_size: int) -> PartStackSource:
    """The images (N, S, S, 3) uint8 with their parts' homographies."""
    mats, valid = part_transforms(kps, joint_model, part_size,
                                  imgs[0].shape[0])
    return PartStackSource(np.stack(imgs), mats, valid)


def finish_part_stacks(batch: Dict, part_size: int) -> Dict:
    """Replace each ``<key>:parts_*`` triple of a batch (the source on the
    device, the homographies in numpy) by ``<key>``, its part stacks in
    [-1, 1] float32 on the source's device, all items in one gather."""
    for key in [k[:-len(PART_SUFFIXES[0])] for k in batch
                if k.endswith(PART_SUFFIXES[0])]:
        src, mats, valid = (batch.pop(key + s) for s in PART_SUFFIXES)
        lead = tuple(src.shape[:-3])
        mats, valid = np.asarray(mats), np.asarray(valid)
        stacks = warp_parts(src.reshape((-1,) + tuple(src.shape[-3:])),
                            mats.reshape((-1,) + mats.shape[-3:]),
                            valid.reshape(-1, valid.shape[-1]), part_size)
        batch[key] = (stacks.float() / 127.5 - 1.0).reshape(
            lead + tuple(stacks.shape[1:]))
    return batch
