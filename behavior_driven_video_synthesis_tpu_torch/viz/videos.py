"""Host-side video and image output of the CLIs.

Counterpart of ``frames_to_uint8``, ``write_video`` and ``make_img_grid``
in ``behavior_driven_video_synthesis_tpu/viz/videos.py``.  Writes an mp4
(a PNG for an image) where cv2 is importable and a uint8 ``.npy``
otherwise; the caller records which.
"""
from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # machines without OpenCV write .npy instead
    cv2 = None

VIDEO_FORMAT = "mp4" if cv2 is not None else "npy"


def frames_to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8 [0, 255]."""
    arr = np.asarray(frames, np.float32)
    arr = (np.clip(arr, -1.0, 1.0) + 1.0) * 127.5
    return arr.astype(np.uint8)


def write_video(frames: np.ndarray, path: str, fps: int = 25) -> str:
    """frames (T, H, W, 3) uint8 RGB -> ``path`` with the extension of
    VIDEO_FORMAT (mp4, or npy without cv2).  Returns the path written."""
    path = os.path.splitext(path)[0] + "." + VIDEO_FORMAT
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if cv2 is None:
        np.save(path, np.asarray(frames, np.uint8))
        return path
    T, H, W = frames.shape[:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (W, H))
    try:
        for t in range(T):
            writer.write(cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return path


def make_img_grid(imgs: np.ndarray, n_cols: int = 8,
                  pad: int = 2) -> np.ndarray:
    """(N, H, W, C) uint8 -> one grid image, ``pad`` black pixels between
    cells."""
    n, h, w, c = imgs.shape
    n_rows = (n + n_cols - 1) // n_cols
    grid = np.zeros((n_rows * (h + pad) - pad,
                     n_cols * (w + pad) - pad, c), imgs.dtype)
    for i in range(n):
        r, col = divmod(i, n_cols)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = imgs[i]
    return grid


def write_image(img: np.ndarray, path: str) -> str:
    """img (H, W, 3) uint8 RGB -> ``path`` as a PNG, or a ``.npy`` without
    cv2.  Returns the path written."""
    path = os.path.splitext(path)[0] + (".png" if cv2 is not None
                                        else ".npy")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if cv2 is None:
        np.save(path, np.asarray(img, np.uint8))
    else:
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return path
