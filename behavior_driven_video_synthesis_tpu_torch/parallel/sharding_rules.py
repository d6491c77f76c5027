"""FSDP of a module's parameters and Adam moments over the ranks.

Counterpart of ``behavior_driven_video_synthesis_tpu/parallel/
sharding_rules.py`` (``_fsdp_leaf_spec``, ``infer_fsdp_shardings``,
``shard_module_state_fsdp``, :56-124), for ``training.fsdp``: the
behavior flow (630 M parameters at ``configs/behavior_net.yaml``'s
width; 2.5 GB of f32 parameters and 5 GB of Adam moments replicated).
:func:`fsdp_leaf_dim` is the JAX rule: a leaf of at least ``min_size``
elements is sharded on its largest dimension that the world size divides,
and JAX replicates the other leaves.  :func:`shard_fsdp` shards every
parameter with ``torch.distributed.fsdp.fully_shard`` instead (FSDP
all-gathers it for the forward and backward and reduce-scatters its
gradient, so the optimizer keeps 1/N of its moments), on the dimension of
:func:`placement_dim`.  FSDP has no replicated placement but leaving a
parameter out of its care, and PyTorch's multi-tensor Adam takes no mix
of sharded (DTensor) and whole parameters, while its per-tensor Adam
updates differently on the card (up to a few lr a parameter after 3 flow
steps, which the flow's loss then amplifies: PERF.md §6).  So there is no
size floor (``training.fsdp_min_size`` is ignored).  The layout changes
no value: a 1-rank FSDP flow step is bit-equal to an unsharded one on the
card.

Checkpoints hold full tensors (:func:`full_state`, written by rank 0), so
that a run of one process and the converters read them;
:func:`load_full_state` shards them again on restore.

Not ported: the "model"-axis rules (``infer_param_shardings``,
``shard_module_state``, ``place_with_shardings``), which no JAX
experiment, CLI or pipeline calls.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from . import mesh


def fsdp_leaf_dim(shape: Sequence[int], n: int,
                  min_size: int = 1 << 14) -> Optional[int]:
    """The dimension FSDP shards a leaf of ``shape`` on over ``n`` ranks
    (JAX ``_fsdp_leaf_spec``): its largest dimension that ``n`` divides,
    for leaves of at least ``min_size`` elements; None (replicated)
    otherwise.  Among equal sizes the first dimension wins, as in JAX."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return None
    cands = [d for d in range(len(shape)) if shape[d] >= n
             and shape[d] % n == 0]
    if not cands:
        return None
    return max(cands, key=lambda d: shape[d])


def placement_dim(shape: Sequence[int], n: int) -> int:
    """The dimension :func:`shard_fsdp` shards a parameter of ``shape`` on
    over ``n`` ranks: its largest dimension that ``n`` divides (JAX's rule
    without the size floor), else dimension 0, the one dimension FSDP
    splits unevenly (each rank takes ceil(size / n) rows, padded; the last
    ranks fewer or none, as a (1, 1024, 1, 1) ActNorm scale over 3
    ranks: ``tests/test_torch_parallel_edges.py`` trains that layout on 3
    gloo ranks)."""
    shape = tuple(shape)
    if not shape:
        raise ValueError("FSDP shards no 0-d parameter")
    d = fsdp_leaf_dim(shape, n, 0)
    return 0 if d is None else d


def shard_fsdp(module: nn.Module) -> None:
    """Shard every parameter of ``module`` in place over the process group
    (``fully_shard``), each on its :func:`placement_dim`.  Build the
    optimizer afterwards."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.world_size()
    place = {p: placement_dim(p.shape, n) for p in module.parameters()}
    fully_shard(module, shard_placement_fn=lambda p: Shard(place[p]))


def _full(t):
    return t.full_tensor() if mesh.is_dtensor(t) else t


def full_state(module: nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None):
    """(module state dict, optimizer state dict) with every sharded tensor
    gathered whole, in the layouts of an unsharded module and optimizer.
    A collective: every rank calls it."""
    msd = {k: _full(v).detach().cpu()
           for k, v in module.state_dict().items()}
    if optimizer is None:
        return msd, None
    osd = optimizer.state_dict()
    osd["state"] = {i: {k: _full(v).cpu() if torch.is_tensor(v) else v
                        for k, v in s.items()}
                    for i, s in osd["state"].items()}
    return msd, osd


def load_full_state(module: nn.Module, msd: dict,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    osd: Optional[dict] = None) -> None:
    """Load the full state of :func:`full_state` (or of an unsharded run)
    into a module sharded by :func:`shard_fsdp` and its optimizer, each
    rank keeping its shards."""
    from torch.distributed.tensor import distribute_tensor

    def like(ref, full):
        full = full.to(device=ref.device, dtype=ref.dtype)
        if mesh.is_dtensor(ref):
            return distribute_tensor(full, ref.device_mesh, ref.placements)
        return full

    current = module.state_dict()
    module.load_state_dict({k: like(current[k], v) for k, v in msd.items()})
    if optimizer is None:
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    osd = dict(osd)
    osd["state"] = {i: {k: (like(params[int(i)], v)
                            if torch.is_tensor(v) and v.dim() > 0 else v)
                        for k, v in s.items()}
                    for i, s in osd["state"].items()}
    optimizer.load_state_dict(osd)
