"""A ConditionalTransformer stepped with and without the "model"-axis
placement of ``parallel/sharding_rules.py:shard_module_state``.

:func:`build` makes the module (a dense or an image conditioning), its
converter plan and its inputs from a numpy seed; :func:`train` runs its
forward, backward and Adam steps, optionally placing it first; and
:func:`run_ranks` runs :func:`train` with the placement on ``world``
spawned CPU processes joined by gloo through a ``file://`` store under the
caller's directory, rank 0 saving what it saw to ``<name>.pt`` there.
A job's mesh is one "model" dimension over every rank, or a ("data",
"model") mesh whose data dimension gives each of its coordinates a batch
of its own.  The workers import neither JAX nor the JAX package.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the placement's floor on a leaf's last flax axis at these small widths
MIN_DIM = 8
LR = 1e-2


def build(kind, parts=1, part=0):
    """The module, its plan and its inputs; with ``parts`` > 1 the
    inputs are batch ``part`` of ``parts`` batches of 4 rows each."""
    from behavior_driven_video_synthesis_tpu_torch.models import (
        convert, flows)
    from behavior_driven_video_synthesis_tpu_torch.models.init import (
        init_random_)
    rng = np.random.RandomState(3)
    if kind == "dense":
        module = flows.ConditionalTransformer(
            16, 32, 1, 2, conditioning_option="sequential",
            conditioning_in_channels=8)
        cond = rng.standard_normal((4 * parts, 8))
    else:
        module = flows.ConditionalTransformer(
            16, 32, 1, 2, conditioning_option="parallel",
            conditioning_spatial_size=16, conditioning_in_channels=3,
            embedder_down=2)
        cond = rng.standard_normal((4 * parts, 16, 16, 3))
    init_random_(module, np.random.RandomState(4))
    x = rng.standard_normal((4 * parts, 16))
    plan = convert.conditional_transformer_plan(
        2, 3, True, kind == "image", 2)
    inputs = [torch.from_numpy(a[4 * part:4 * part + 4].astype(np.float32))
              for a in (x, cond)]
    return module, plan, inputs


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _placement(t):
    return str(getattr(t, "placements", "plain"))


def train(kind, mesh=None, steps_before=0, steps_after=1, parts=1,
          part=None):
    """``steps_before`` Adam steps unplaced, then (with a mesh) the
    placement, with the optimizer moved over, then ``steps_after`` steps.
    Each step takes the gradient of batch ``part`` of ``parts``, or (with
    ``part`` None) the mean of the gradients of all ``parts`` batches.
    Returns the forward of the first placed step on its first batch, the
    gradients and parameters after the last step, and the placements of
    the parameters and of their Adam moments."""
    from behavior_driven_video_synthesis_tpu_torch.parallel import (
        sharding_rules)
    batches = range(parts) if part is None else [part]
    module, plan, _ = build(kind)
    data = [build(kind, parts, b)[2] for b in batches]
    opt = torch.optim.Adam(module.parameters(), lr=LR)
    dims = None
    out = {}
    for step in range(steps_before + steps_after):
        if step == steps_before and mesh is not None:
            dims = sharding_rules.shard_module_state(
                module, mesh, plan, optimizer=opt, min_dim=MIN_DIM)
        opt.zero_grad()
        for i, (x, cond) in enumerate(data):
            z, logdet = module(x, cond)
            if step == steps_before and i == 0:
                out["z"], out["logdet"] = z.detach(), logdet.detach()
                out["reverse"] = module.reverse(z, cond).detach()
            loss = 0.5 * (z ** 2).sum() - logdet.sum()
            loss.backward()
        if len(data) > 1:
            for p in module.parameters():
                p.grad /= len(data)
        opt.step()
    names = dict(module.named_parameters())
    out["grads"] = {k: _whole(p.grad).detach() for k, p in names.items()}
    out["params"] = {k: _whole(p).detach() for k, p in names.items()}
    out["placements"] = {k: _placement(p) for k, p in names.items()}
    out["moments"] = {k: {s: _placement(v) for s, v in opt.state[p].items()
                          if torch.is_tensor(v) and v.dim() > 0}
                      for k, p in names.items()}
    out["dims"] = dims
    return out


def _worker(rank, world, store, jobs):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}/pg",
                            rank=rank, world_size=world)
    try:
        for name, kind, before, shape in jobs:
            names = ("model",) if len(shape) == 1 else ("data", "model")
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            parts, part = ((1, None) if len(shape) == 1 else
                           (shape[0], mesh.get_local_rank("data")))
            out = train(kind, mesh, steps_before=before, parts=parts,
                        part=part)
            if rank == 0:
                torch.save(out, os.path.join(store, f"{name}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world, store, jobs, timeout=180.0):
    """Run ``jobs`` ((name, kind, steps_before, mesh shape), ...) on
    ``world`` spawned ranks, each mesh over all of them; returns {name:
    rank 0's :func:`train` output}."""
    os.makedirs(store, exist_ok=True)
    ctx = mp.start_processes(_worker, args=(world, store, jobs),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return {name: torch.load(os.path.join(store, f"{name}.pt"),
                             weights_only=False)
            for name, *_ in jobs}
