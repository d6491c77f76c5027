"""The one generator of requests: a traffic file gives the sizes and the
loop, the configuration gives the input distributions (``assumed``), the
seed gives the values.

Every request of a run is drawn on the device at set-up, as a pool of
``pool`` requests that the window cycles through in order, so each seed
makes the same sizes and the same amount of work.  A request of V videos
holds:

- ``z`` (V, H): the behavior codes, N(0, I);
- ``x_start`` (V, K): the start posture in normalized coordinates;
- ``app`` (V, h, w, c): the appearance in [-1, 1], an RGB image or the
  part stack;
- ``extrinsics`` (V, 3, 4), ``intrinsics`` (V, 4), ``image_size`` (V, 2):
  a camera turned about the vertical axis, at a drawn distance and focal
  length;
- ``eps``: the appearance posterior's noise, one bfloat16 tensor per latent
  scale, handed to the program so that the reference sees the same draws.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .reference import spec as S
from .weights import generator

KEYS = ("loop", "clients", "videos", "frames", "pool", "checked", "traced")


def check_traffic(traffic: dict) -> None:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError("the generator drives one closed-loop client")


def latent_sizes(cfg: dict) -> List[int]:
    """Side of each posterior mean's map, coarsest first."""
    s = cfg["synthesis_net"]
    bottleneck = int(s["spatial_size"]) // 2 ** (S.n_scales(cfg) - 1)
    return [bottleneck * 2 ** i for i in range(int(s["n_latent_scales"]))]


def _uniform(u, lo_hi):
    lo, hi = lo_hi
    return lo + (hi - lo) * u


@torch.no_grad()
def make_pool(cfg: dict, traffic: dict, seed: int,
              device) -> List[Dict[str, object]]:
    check_traffic(traffic)
    V, P = int(traffic["videos"]), int(traffic["pool"])
    n = V * P
    a = cfg["assumed"]
    cam = a["camera"]
    g = generator(device, seed, 1)
    H = int(cfg["behavior_net"]["dim_hidden_b"])
    K = S.n_kps_used(cfg)

    z = torch.randn(n, H, generator=g, device=device)
    x_start = torch.randn(n, K, generator=g, device=device) * float(
        a["x_start_std"])
    app = torch.rand((n,) + S.appearance_shape(cfg), generator=g,
                     device=device) * 2 - 1
    u = torch.rand(n, 5, generator=g, device=device)
    yaw = _uniform(u[:, 0], cam["yaw_rad"])
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    dist = _uniform(u[:, 1], cam["distance"])
    extrinsics = torch.stack([
        torch.stack([cos, zero, sin, zero], -1),
        torch.stack([zero, one, zero, zero], -1),
        torch.stack([-sin, zero, cos, dist], -1)], -2)
    focal = _uniform(u[:, 2], cam["focal_px"])
    cx = _uniform(u[:, 3], cam["centre_px"])
    cy = _uniform(u[:, 4], cam["centre_px"])
    intrinsics = torch.stack([focal, cx, focal, cy], -1)
    image_size = torch.full((n, 2), float(cam["image_size_px"]),
                            device=device)
    nf = int(cfg["synthesis_net"]["nf_max"])
    eps = [torch.randn(n, s, s, nf, generator=g, device=device,
                       dtype=torch.bfloat16) for s in latent_sizes(cfg)]

    pool = []
    for p in range(P):
        rows = slice(p * V, (p + 1) * V)
        pool.append(dict(z=z[rows], x_start=x_start[rows], app=app[rows],
                         extrinsics=extrinsics[rows],
                         intrinsics=intrinsics[rows],
                         image_size=image_size[rows],
                         eps=[e[rows] for e in eps]))
    return pool
