"""Seeded parameters on the device, made in a few large calls.

Every floating leaf of the configuration's networks is a view into one
float32 buffer drawn by a single ``torch.randn`` on a ``torch.Generator``
of the device, then scaled and shifted by kind with two ``_foreach``
calls; the flow's shuffles are the argsorts of one uniform draw.  The same
tensors load into the program by name and feed the reference, so both
sides see one set of weights.

The scales stand in for trained weights (the configuration file lists
them under ``assumed``): weights N(0, 1/fan_in), the last Linear of each
flow coupling MLP and the decoder's pose step at a tenth of that,
weight-norm magnitudes 0.6 + 0.1 N, gammas and ActNorm scales 1 + 0.1 N,
biases, betas and ActNorm shifts 0.1 N, the pose step's bias 0.01 N.  The
tenth keeps the flow near volume-preserving and the figure in the frame:
at the full scale the seeded rollout walks the joints metres from the
mean skeleton, most keypoints leave the frame by the last frames, and
the rollout's rounding grows with the walk (the configuration's
``assumed`` notes give the readings).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import spec as S

# kind -> (offset, factor on N(0, 1), divide the factor by sqrt(fan_in))
KINDS = {"weight": (0.0, 1.0, True), "head": (0.0, 0.1, True),
         "step": (0.0, 0.1, True), "step_bias": (0.0, 0.01, False),
         "direction": (0.0, 1.0, True), "magnitude": (0.6, 0.1, False),
         "gamma": (1.0, 0.1, False), "scale": (1.0, 0.1, False),
         "beta": (0.0, 0.1, False), "bias": (0.0, 0.1, False),
         "loc": (0.0, 0.1, False)}


def full_spec(cfg: dict) -> S.Spec:
    return S.behavior_spec(cfg) + S.flow_spec(cfg) + S.vunet_spec(cfg)


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one use of the run's seed (0: weights, 1: inputs)."""
    mixed = (int(seed) * 6364136223846793005 + 1442695040888963407
             * (stream + 1)) % 2 ** 63
    return torch.Generator(device=device).manual_seed(mixed)


@torch.no_grad()
def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = full_spec(cfg)
    g = generator(device, seed, 0)
    floats = [(n, shape, kind) for n, shape, kind in spec
              if kind != "permutation"]
    sizes = [math.prod(shape) for _, shape, _ in floats]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    views = [v.view(shape) for v, (_, shape, _)
             in zip(torch.split(flat, sizes), floats)]
    factors, offsets = [], []
    for _, shape, kind in floats:
        offset, factor, by_fan_in = KINDS[kind]
        if by_fan_in:
            factor /= math.sqrt(math.prod(shape[1:]))
        factors.append(factor)
        offsets.append(offset)
    torch._foreach_mul_(views, factors)
    torch._foreach_add_(views, offsets)
    params = {n: v for (n, _, _), v in zip(floats, views)}
    perms = [(n, shape) for n, shape, kind in spec if kind == "permutation"]
    if perms:
        width = perms[0][1][0]
        if any(shape != (width,) for _, shape in perms):
            raise ValueError("the shuffles differ in width")
        order = torch.argsort(torch.rand(len(perms), width, generator=g,
                                         device=device), dim=1)
        params.update({n: order[i] for i, (n, _) in enumerate(perms)})
    return params


def subset(params: Dict[str, torch.Tensor], spec: S.Spec):
    return {n: params[n] for n, _, _ in spec}
