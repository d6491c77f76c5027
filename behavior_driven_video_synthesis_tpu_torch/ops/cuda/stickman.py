"""The stickman raster kernel: one launch over all frames of a
``render_stickman`` call; its wrapper and its topology table.

``geometry/stickman.py:render_stickman`` sends CUDA joints here and keeps
``render_stickman_plain`` (the chunked eager version) for the CPU.  The
kernel (``csrc/stickman.cu``) is bit-equal to that eager version run on
the card, in both of its outputs: f32 on a 0..255 scale, or the VUNet's
bf16 input ``(stick - 127.5) / 127.5``.

The joint model's topology goes to the kernel as a small int32 table on
the device, built once per joint model and device and cached, so a call
copies nothing from the host and never waits for the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .build import launch, load_library

# Launches of the kernel since import (or since a caller last reset it).
stickman_launches = 0

# table kinds, as csrc/stickman.cu reads them
LEFT, RIGHT, HEAD, NECK, BODY = 0, 1, 2, 3, 4
MAX_JOINTS, MAX_ROWS = 128, 64

_tables: Dict[tuple, tuple] = {}


class Topology(NamedTuple):
    """A joint model's topology on a device: the int32 (rows, 4) table,
    its segment and body-vertex counts, and the largest joint index."""
    table: torch.Tensor
    n_seg: int
    n_body: int
    top: int


def topology_rows(joint_model) -> Tuple[List[Tuple[int, int, int, int]],
                                         int]:
    """The table's rows ``(kind, i0, i1, i2)`` and its segment count: the
    right, left and head lines (or the neck line from the shoulders'
    midpoint to ``headup`` without head lines), then the body polygon's
    vertices in order; unused indices are -1."""
    rows = [(RIGHT, a, b, -1) for a, b in joint_model.right_lines]
    rows += [(LEFT, a, b, -1) for a, b in joint_model.left_lines]
    if len(joint_model.head_lines):
        rows += [(HEAD, a, b, -1) for a, b in joint_model.head_lines]
    else:
        rows.append((NECK, joint_model.rshoulder, joint_model.lshoulder,
                     joint_model.headup))
    n_seg = len(rows)
    rows += [(BODY, v, -1, -1) for v in joint_model.body]
    return [tuple(int(i) for i in r) for r in rows], n_seg


def topology_table(joint_model, device) -> Topology:
    """``topology_rows`` on ``device``, built on first use (one copy to the
    device) and cached per joint model and device."""
    device = torch.device(device)
    key = (id(joint_model), str(device))
    hit = _tables.get(key)
    if hit is not None and hit[0] is joint_model:
        return hit[1]
    rows, n_seg = topology_rows(joint_model)
    if len(rows) > MAX_ROWS:
        raise ValueError(f"the joint model has {len(rows)} lines and body "
                         f"vertices; the kernel takes {MAX_ROWS}")
    used = [i for kind, *idx in rows
            for i in idx[:{NECK: 3, BODY: 1}.get(kind, 2)]]
    if min(used, default=0) < 0:
        raise ValueError(f"the joint model has a negative joint index: "
                         f"{rows}")
    topo = Topology(torch.tensor(np.asarray(rows, np.int32).reshape(-1, 4),
                                 device=device),
                    n_seg, len(rows) - n_seg, max(used, default=-1))
    _tables[key] = (joint_model, topo)
    return topo


@functools.cache
def _lib():
    lib = load_library("stickman")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bdvs_stickman.argtypes = [p, p, i, i, ll, i, i, ctypes.c_float, i, p,
                                  p]
    lib.bdvs_stickman.restype = i
    return lib


def stickman_raster(joints, joint_model, spatial_size: int,
                    thickness: float = 1.0, normalized: bool = False):
    """joints (..., K, 2) pixel coordinates on a CUDA device -> (..., S, S,
    3): f32 on a 0..255 scale, or with ``normalized`` bf16 (stick - 127.5)
    / 127.5.  One kernel launch; no host-device synchronization once the
    joint model's table is on the device."""
    global stickman_launches
    if joints.device.type != "cuda":
        raise ValueError(f"the stickman kernel runs on a CUDA device, got "
                         f"{joints.device}")
    K = joints.shape[-2] if joints.dim() >= 2 else 0
    if joints.shape[-1] != 2 or not 0 < K <= MAX_JOINTS:
        raise ValueError(f"joints must be (..., K, 2) with 0 < K <= "
                         f"{MAX_JOINTS}, got {list(joints.shape)}")
    S = int(spatial_size)
    if not 0 < S <= 32768:
        raise ValueError(f"spatial_size must be in 1..32768, got {S}")
    topo = topology_table(joint_model, joints.device)
    if topo.top >= K:
        raise ValueError(f"the joint model indexes joint {topo.top}, and "
                         f"joints has K={K}")
    flat = joints.reshape(-1, K, 2).float().contiguous()
    if flat.data_ptr() % 8:     # the kernel loads a joint as one float2
        flat = flat.clone()
    dtype = torch.bfloat16 if normalized else torch.float32
    out = torch.empty(tuple(joints.shape[:-2]) + (S, S, 3), dtype=dtype,
                      device=joints.device)
    if flat.shape[0] == 0:
        return out
    half = float(np.float32(float(thickness) / 2.0))
    launch(_lib().bdvs_stickman, "stickman kernel launch", joints.device,
           flat.data_ptr(), topo.table.data_ptr(), topo.n_seg, topo.n_body,
           flat.shape[0], K, S, half, int(normalized), out.data_ptr())
    stickman_launches += 1
    return out
