"""Host-side video output of the serving CLI.

Counterpart of ``frames_to_uint8`` and ``write_video`` in
``behavior_driven_video_synthesis_tpu/viz/videos.py``.  Writes an mp4 where
cv2 is importable and a uint8 ``.npy`` of the frames otherwise; the caller
records which in its manifest.
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
