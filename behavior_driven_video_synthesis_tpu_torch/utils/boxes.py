"""Bounding boxes and keypoint-centred crops.

Counterpart of ``behavior_driven_video_synthesis_tpu/utils/boxes.py``.  On
the host (numpy and cv2): ``get_bounding_box``, a square box around the
keypoints with ``relax`` padding and the padding it needs outside the
image, and ``crop_with_bbox`` (the datasets' ``use_crops``).  On the
device (torch): ``bounding_box_batch``, a square crop around each item's
keypoints resampled to ``out_size`` with four bilinear taps at indices
clamped to the image, as the JAX code gathers them (``F.grid_sample``
treats the border differently), and ``part_crops_batch`` around a subset
of the keypoints.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def get_bounding_box(pts: np.ndarray, img_shape, relax: float = 0.1
                     ) -> Dict[str, np.ndarray]:
    """Square box [x_tl, x_br, y_tl, y_br] around ``pts`` (K, 2+) and the
    reflect padding [left, right, top, bottom] it needs; the box is in the
    padded image's coordinates."""
    pts = np.asarray(pts[:, :2], np.float32)
    x, y = pts[:, 0].min(), pts[:, 1].min()
    w = pts[:, 0].max() - x
    h = pts[:, 1].max() - y
    x, y, w, h = int(x), int(y), int(np.ceil(w)), int(np.ceil(h))
    if w >= h:
        x_tl = int(x - relax * w)
        x_br = int(x + (1.0 + relax) * w)
        y_tl = int((2 * y + h - (x_br - x_tl)) / 2)
        y_br = int((2 * y + h + (x_br - x_tl)) / 2)
    else:
        y_tl = int(y - relax * h)
        y_br = int(y + (1.0 + relax) * h)
        x_tl = int((2 * x + w - (y_br - y_tl)) / 2)
        x_br = int((2 * x + w + (y_br - y_tl)) / 2)
    bbox = [x_tl, x_br, y_tl, y_br]
    pad_left = abs(min(0, bbox[0]))
    pad_right = abs(max(0, bbox[1] - img_shape[1]))
    pad_top = abs(min(0, bbox[2]))
    pad_bottom = abs(max(0, bbox[3] - img_shape[0]))
    bbox[0] += pad_left
    bbox[1] += pad_left + pad_right
    bbox[2] += pad_top
    bbox[3] += pad_top + pad_bottom
    return {"bbox": bbox,
            "pads": np.asarray([pad_left, pad_right, pad_top, pad_bottom],
                               np.int64)}


def crop_with_bbox(img: np.ndarray, kps: np.ndarray,
                   relax: float = 0.1) -> np.ndarray:
    """The square keypoint-centred crop of ``img``, reflect-padded (cv2)
    where the box leaves the image."""
    crop = get_bounding_box(kps, img.shape, relax)
    bbox, pads = crop["bbox"], crop["pads"]
    if np.any(pads > 0):
        import cv2

        img = cv2.copyMakeBorder(img, pads[2], pads[3], pads[0], pads[1],
                                 borderType=cv2.BORDER_REFLECT)
    return img[bbox[2]:bbox[3], bbox[0]:bbox[1]]


def bounding_box_batch(kps: torch.Tensor, imgs: torch.Tensor, out_size: int,
                       relax: float = 0.1) -> torch.Tensor:
    """kps (B, K, 2) pixel coordinates, imgs (B, H, W, C) float -> (B,
    out_size, out_size, C): each item's square box of side max(w, h) (1 +
    2 relax) about its keypoints' centre, sampled at ``out_size`` points a
    side with the coordinates clamped to the image."""
    B, H, W, C = imgs.shape
    kps = kps.to(imgs.dtype)
    lo, hi = kps.amin(dim=1), kps.amax(dim=1)                  # (B, 2)
    side = (hi - lo).amax(dim=1) * (1.0 + 2 * relax)           # (B,)
    centre = (lo + hi) / 2
    lin = (torch.arange(out_size, dtype=imgs.dtype, device=imgs.device)
           + 0.5) / out_size - 0.5
    gx = (centre[:, :1] + side[:, None] * lin).clamp(0.0, W - 1.0)
    gy = (centre[:, 1:] + side[:, None] * lin).clamp(0.0, H - 1.0)
    x0, y0 = gx.floor(), gy.floor()
    fx, fy = (gx - x0)[:, None, :, None], (gy - y0)[:, :, None, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = imgs.reshape(B, H * W, C)

    def tap(yy, xx):
        idx = (yy[:, :, None] * W + xx[:, None, :]).reshape(B, -1, 1)
        return flat.gather(1, idx.expand(-1, -1, C)).reshape(
            B, out_size, out_size, C)
    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x1) * fx * (1 - fy)
            + tap(y1, x0) * (1 - fx) * fy + tap(y1, x1) * fx * fy)


def part_crops_batch(kps: torch.Tensor, imgs: torch.Tensor,
                     part_indices: Sequence[int], out_size: int,
                     relax: float = 0.3) -> torch.Tensor:
    """:func:`bounding_box_batch` about the keypoints ``part_indices``
    (the head, the hands) alone."""
    sub = torch.as_tensor(np.asarray(part_indices), device=kps.device)
    return bounding_box_batch(kps[:, sub], imgs, out_size, relax=relax)
