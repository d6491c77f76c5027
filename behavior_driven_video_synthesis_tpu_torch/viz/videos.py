"""Host-side video and image output of the CLIs and the figures.

Counterpart of ``behavior_driven_video_synthesis_tpu/viz/videos.py``.
Writes an mp4 (a PNG for an image) where cv2 is importable and a uint8
``.npy`` otherwise; the caller records which.  The 3-D skeleton videos of
:func:`create_video_3d` are drawn with cv2 and numpy (the JAX package draws
them with matplotlib, which the card's machine does not have): the poses
are projected orthographically under matplotlib's default 3-D view
(elevation 30 degrees, azimuth -60) into the frame size of the JAX default
(4 x 4 inches at 100 dpi), every frame in one numpy call, and only the
lines are drawn frame by frame.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

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


def save_png(img: np.ndarray, path: str) -> str:
    """(H, W, 3) uint8 RGB -> a PNG at ``path`` (a ``.npy`` without cv2).
    Returns the path written."""
    return write_image(np.ascontiguousarray(img), path)


def make_enrollment_strip(video: np.ndarray, n_frames: int = 8,
                          pad: int = 2) -> np.ndarray:
    """(T, H, W, C) -> a horizontal filmstrip of ``n_frames`` evenly
    spaced frames."""
    idx = np.linspace(0, video.shape[0] - 1, n_frames).astype(int)
    return make_img_grid(video[idx], n_cols=n_frames, pad=pad)


def make_eval_grid(videos: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    """Videos (T_i, H, W, C) stacked into one (T, rows * (H + pad), W, C)
    grid video of their shortest length."""
    T = min(v.shape[0] for v in videos)
    return np.concatenate(
        [np.pad(v[:T], ((0, 0), (0, pad), (0, 0), (0, 0))) for v in videos],
        axis=1)


def filmstrip(video: np.ndarray, disc_step: int = 6,
              pad: int = 2) -> np.ndarray:
    """(T, H, W, C) -> a horizontal strip of every ``disc_step``-th
    frame."""
    sel = video[::disc_step]
    return make_img_grid(sel, n_cols=sel.shape[0], pad=pad)


def _cv2():
    if cv2 is None:
        raise ImportError("the figures draw with OpenCV, and cv2 is not "
                          "installed")
    return cv2


def text_to_vid(vid: np.ndarray, text: str, org: tuple,
                font_size: float = 0.7, font_thickness: int = 2):
    """Burn ``text`` into every frame of ``vid`` at pixel ``org``, in
    place; returns ``vid``."""
    c = _cv2()
    for k in range(vid.shape[0]):
        vid[k] = c.putText(vid[k], text, org, c.FONT_HERSHEY_SIMPLEX,
                           font_size, (0, 0, 0), font_thickness)
    return vid


def add_joints_to_img(img: np.ndarray, kps: np.ndarray, joints,
                      color_joints=((0, 0, 255),)):
    """Limb lines between the keypoint pairs ``joints`` drawn onto
    ``img``; returns the image."""
    c = _cv2()
    color_joints = list(color_joints)
    if len(color_joints) == 1:
        color_joints = [color_joints[0]] * len(joints)
    for i, jo in enumerate(joints):
        img = c.line(img, (int(kps[jo[0], 0]), int(kps[jo[0], 1])),
                     (int(kps[jo[1], 0]), int(kps[jo[1], 1])),
                     color=color_joints[i], thickness=3)
    return img


# -- 3D skeleton videos -----------------------------------------------------

_H36M_17_LINES = [
    (0, 1), (1, 2), (0, 14), (14, 15), (15, 16),   # right leg / arm
    (3, 4), (4, 5), (3, 11), (11, 12), (12, 13),   # left leg / arm
    (8, 9), (9, 10), (0, 6), (3, 6), (6, 7), (7, 8),
]
VIEW_ELEVATION, VIEW_AZIMUTH = 30.0, -60.0
_LINE_RGB = (31, 119, 180)      # matplotlib's "tab:blue"
_CUBE_HALF_EXTENT = 1.8         # the data cube's half width, in radii


def project_view(poses: np.ndarray, size: int) -> np.ndarray:
    """(..., 3) points in a cube of half width 1 -> (..., 2) pixels of a
    ``size`` square frame: orthographic under the fixed 3-D view, z up."""
    el, az = np.deg2rad(VIEW_ELEVATION), np.deg2rad(VIEW_AZIMUTH)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                   np.cos(el)])
    scale = size / (2.0 * _CUBE_HALF_EXTENT)
    x = size / 2.0 + scale * (poses @ right)
    y = size / 2.0 - scale * (poses @ up)
    return np.stack([x, y], axis=-1)


def create_video_3d(poses: np.ndarray, out_path: Optional[str] = None,
                    fps: int = 25, lines=None,
                    figsize=(4, 4)) -> np.ndarray:
    """(T, K, 3) world poses -> (T, H, W, 3) uint8 frames of the skeleton
    on white (and an mp4 at ``out_path`` when given).  The view's centre
    and cube radius come from all frames' extent, as in the JAX
    package."""
    c = _cv2()
    poses = np.asarray(poses, np.float64)
    lines = [(a, b) for a, b in (lines or _H36M_17_LINES)
             if a < poses.shape[1] and b < poses.shape[1]]
    flat = poses.reshape(-1, 3)
    mins, maxs = flat.min(0), flat.max(0)
    center = (mins + maxs) / 2
    radius = max((maxs - mins).max() / 2, 1e-3)
    h, w = int(figsize[1] * 100), int(figsize[0] * 100)
    px = np.rint(project_view((poses - center) / radius, min(h, w)))
    px = px.astype(np.int32) + [(w - min(h, w)) // 2, (h - min(h, w)) // 2]
    frames = np.full((poses.shape[0], h, w, 3), 255, np.uint8)
    for t in range(poses.shape[0]):
        for a, b in lines:
            c.line(frames[t], tuple(px[t, a]), tuple(px[t, b]), _LINE_RGB,
                   thickness=2, lineType=c.LINE_AA)
    if out_path is not None:
        write_video(frames, out_path, fps=fps)
    return frames
