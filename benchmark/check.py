"""The comparison that decides ``correct``.

A served request is judged stage by stage against the plain reference
(``reference/model.py``), which works everything out again from the
weights and the request's inputs:

- ``poses``: the widest gap, in metres, between the served world joints
  and the reference's flow inverse, rollout and unnormalize of the same
  codes and start postures;
- ``keypoints_px``: the widest gap, in stickman pixels, between the served
  keypoints and the reference's projection of the served joints;
- ``stickman_share``: the share of stickman values that differ from the
  reference's raster of the served keypoints;
- ``frames_off_share``: the largest share, in one frame, of values that
  lie more than two 8-bit levels from the reference's VUNet of the served
  stickmen (with the posterior means it works out itself from the
  appearance and the noise), both clipped to [-1, 1] as a video shows
  them.  The share is of the values that the clipping leaves free to
  differ: a value that both sides clip to the same end agrees by the
  clipping alone and is left out of it.  (A frame's relative L2 gap does
  not separate the program's bfloat16 from its own int8 path by the
  factor a limit needs; the share of values two levels off does, by two
  orders of magnitude.)

So every stage is held to the reference on the program's own input to it,
and the first, from the codes to the joints, on the request's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import model as R

NUMBERS = ("poses", "keypoints_px", "stickman_share", "frames_off_share")
# reported beside them, not compared: the share of the reference's frame
# values that the clipping to [-1, 1] changes
CLIPPED = "frames_clipped_share"
# two 8-bit levels of a frame in [-1, 1]
FRAME_TOLERANCE = 2 / 127.5


def _finite(v: torch.Tensor) -> float:
    v = float(v)
    return v if math.isfinite(v) else math.inf


def _shape_ok(out: dict, cfg: dict, traffic: dict) -> bool:
    V, T = int(traffic["videos"]), int(traffic["frames"])
    size = int(cfg["synthesis_net"]["spatial_size"])
    joints = len(cfg["assumed"]["norm_mean"]) // 3
    want = {"poses_3d": (V, T, joints, 3), "keypoints_2d": (V, T, joints, 2),
            "stickman": (V, T, size, size, 3),
            "frames": (V, T, size, size, 3)}
    return all(k in out and tuple(out[k].shape) == s for k, s in want.items())


def frames_off(served: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, T): each frame's share of values more than two 8-bit levels
    apart once both sides are clipped to [-1, 1], among the values that
    the clipping does not bring to the same end on both sides."""
    both = (((served > 1) & (ref > 1))
            | ((served < -1) & (ref < -1))).flatten(2)
    off = ((served.clamp(-1, 1) - ref.clamp(-1, 1)).abs()
           > FRAME_TOLERANCE).flatten(2)
    return off.sum(-1) / (~both).sum(-1).clamp_min(1)


@torch.no_grad()
def judge(P, cfg: dict, traffic: dict, request: dict,
          out: dict) -> Dict[str, float]:
    """The numbers of one served request (inputs ``request``, outputs
    ``out``)."""
    if not _shape_ok(out, cfg, traffic):
        return {k: math.inf for k in NUMBERS + (CLIPPED,)}
    T = int(traffic["frames"])
    size = int(cfg["synthesis_net"]["spatial_size"])
    world = out["poses_3d"].float()
    ref = R.poses(P, cfg, request["z"], request["x_start"], T)
    poses = (world - ref).abs().max()
    del ref

    kp = out["keypoints_2d"].float()
    ref_kp = R.project(world, request["extrinsics"], request["intrinsics"],
                       request["image_size"], size)
    keypoints = (kp - ref_kp).abs().max()

    stick = out["stickman"]
    ref_stick = R.stickman_input(R.raster(cfg, kp))
    share = ((stick.float() - ref_stick.float()).abs() > 0.01).float().mean()
    if not bool(torch.isfinite(stick.float()).all()):
        share = torch.tensor(math.inf)
    del ref_stick

    means = R.encode_means(P, cfg, request["app"], request["eps"])
    ref_frames = R.frames(P, cfg, means, stick)
    served = out["frames"].float()
    off = frames_off(served, ref_frames).max()
    clipped = (ref_frames.abs() > 1).float().mean()
    if not bool(torch.isfinite(served).all()):
        off = torch.tensor(math.inf)
    return {"poses": _finite(poses), "keypoints_px": _finite(keypoints),
            "stickman_share": _finite(share),
            "frames_off_share": _finite(off), CLIPPED: _finite(clipped)}


def worst(readings) -> Dict[str, float]:
    """The largest reading of each number over several requests."""
    readings = list(readings)
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)
