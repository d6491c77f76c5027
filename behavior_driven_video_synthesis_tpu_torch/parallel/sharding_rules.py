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

The "model"-axis rules (JAX ``infer_param_shardings``,
``place_with_shardings``, ``shard_module_state``, :29-53 and :127-177),
which no experiment, CLI or pipeline of either package calls, are
:func:`model_axis_dim`, :func:`infer_param_placements`,
:func:`place_with_shardings` and :func:`shard_module_state`: a parameter
whose flax leaf has >= 2 axes and a last axis of at least ``min_dim``
that the "model" mesh dimension's size divides is sharded on that axis,
the rest replicated; Adam's moments follow their parameters and buffers
are replicated.  The rule reads the flax shape through the module's
converter plan (``models/convert.py``): a Dense or conv kernel's last flax
axis is the torch weight's dim 0.  A placed module gathers its
parameters for each forward and computes it whole on every rank; the
placement shards storage and Adam's moments, not the compute, and the
backward averages the gradients over the mesh's other dimensions
(:func:`place_with_shardings`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

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


# -- the "model" axis: parameters and moments sharded, compute whole ---------

# For each converter layout (models/convert.py), the torch dimension that is
# the flax leaf's last axis, and the flax leaf's number of axes (None: as
# the torch tensor's).  "g", "c4" and "perm" leaves have one flax axis.
_FLAX_LAST = {"T": (0, 2), "dense_v": (0, 2), "fc_cmajor": (0, 2),
              "hwio": (0, 4), "conv1d": (0, 3), "id": (-1, None),
              "g": (None, 1), "c4": (None, 1), "perm": (None, 1)}


def model_axis_dim(shape: Sequence[int], kind: str, n: int,
                   min_dim: int = 128) -> Optional[int]:
    """The torch dimension on which the model-axis rule shards a tensor of
    ``shape`` stored by converter layout ``kind`` over ``n`` devices, or
    None (replicated).  JAX's rule on the flax leaf: >= 2 axes, the last
    axis >= ``min_dim`` and divisible by ``n``."""
    dim, flax_ndim = _FLAX_LAST[kind]
    if flax_ndim is None:
        flax_ndim = len(shape)
    if dim is None or flax_ndim < 2:
        return None
    dim %= len(shape)
    size = shape[dim]
    return dim if size >= min_dim and size % n == 0 else None


def infer_param_placements(module: nn.Module, plan, n: int,
                           min_dim: int = 128) -> Dict[str, Optional[int]]:
    """{parameter name: its :func:`model_axis_dim`} over ``n`` model-axis
    devices; ``plan`` is the module's converter plan, which names the
    flax layout of every parameter."""
    kinds = {key: kind for key, _, kind in plan}
    return {name: model_axis_dim(p.shape, kinds[name], n, min_dim)
            for name, p in module.named_parameters()}


def _placements(mesh, dim: Optional[int], model_axis: str):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dim) if name == model_axis and dim is not None
                 else Replicate() for name in mesh.mesh_dim_names)


def place_with_shardings(module: nn.Module, dims: Dict[str, Optional[int]],
                         mesh, model_axis: str = "model") -> Dict:
    """Make every parameter of ``module`` a DTensor on ``mesh``, sharded
    over ``model_axis`` on its dimension in ``dims`` (replicated over the
    other mesh dimensions, and where the dimension is None); buffers stay
    whole on every rank.  The module's forward gathers each parameter
    whole for the call (``redistribute`` to replicated, then
    ``to_local``) and computes on plain tensors, as FSDP does: the
    placement holds the parameters and their optimizer state sharded, and
    every rank computes the whole forward, what the unplaced module
    computes.  The compute is not split over the model dimension.

    The ranks of one model-dimension group must be given the same batch;
    the other mesh dimensions (a "data" dimension) may each give their
    ranks a batch of their own.  The backward averages each parameter's
    gradient over those other dimensions (a partial sum over them, each
    rank's gradient divided by their size) and keeps this rank's model
    shard of it, so every rank steps on the gradient of the whole batch,
    as GSPMD's sum does in JAX.  Leave these parameters out of any other
    gradient all-reduce (``mesh.sync_gradients`` skips DTensors).

    (DTensor's own operator rules, which would split the computation as
    GSPMD does, mis-shard a convolution whose weight is sharded on its
    output channels in torch 2.13 and fail on the backward of an indexed
    permutation in torch 2.11.)  Methods other than ``forward`` see the
    parameters as placed.  Returns {old parameter: new parameter}."""
    from torch.distributed.tensor import (Partial, Replicate,
                                          distribute_tensor)
    swapped, placed = {}, []
    for prefix, sub in module.named_modules():
        for key, p in list(sub._parameters.items()):
            if p is None:
                continue
            if p not in swapped:
                name = f"{prefix}.{key}" if prefix else key
                swapped[p] = nn.Parameter(distribute_tensor(
                    p.data, mesh, _placements(mesh, dims[name],
                                              model_axis)),
                    requires_grad=p.requires_grad)
            sub._parameters[key] = swapped[p]
            placed.append((sub, key, swapped[p]))
    whole = [Replicate()] * mesh.ndim
    # a rank's gradient of a gathered parameter is that of its own batch: a
    # partial sum over the mesh dimensions other than the model one
    grads = tuple(Replicate() if name == model_axis else Partial()
                  for name in mesh.mesh_dim_names)
    n_avg = math.prod(mesh.size(i) for i, name
                      in enumerate(mesh.mesh_dim_names) if name != model_axis)
    depth = [0]

    def gather(mod, args):
        depth[0] += 1
        if depth[0] == 1:
            for sub, key, p in placed:
                local = p.redistribute(mesh, whole).to_local(
                    grad_placements=grads)
                if n_avg > 1 and local.requires_grad:
                    local.register_hook(lambda g: g / n_avg)
                sub._parameters[key] = local

    def restore(mod, args, out):
        depth[0] -= 1
        if depth[0] == 0:
            for sub, key, p in placed:
                sub._parameters[key] = p
    module.register_forward_pre_hook(gather)
    module.register_forward_hook(restore, always_call=True)
    return swapped


def shard_module_state(module: nn.Module, mesh, plan,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       model_axis: str = "model", min_dim: int = 128):
    """Place ``module`` over the "model" dimension of ``mesh`` by the
    column rule (:func:`infer_param_placements` on its converter
    ``plan``), in place; a mesh without that dimension replicates every
    parameter, as in JAX.  An ``optimizer`` built on the module before
    now is moved over: its parameters become the placed ones and its
    per-parameter state (Adam's moments) takes their placements.  An
    optimizer built afterwards makes its moments in the parameters'
    placements itself.  Returns {parameter name: sharded dim or None}."""
    from torch.distributed.tensor import distribute_tensor
    names = mesh.mesh_dim_names or ()
    if model_axis in names:
        n = mesh.size(names.index(model_axis))
        dims = infer_param_placements(module, plan, n, min_dim)
    else:
        dims = {name: None for name, _ in module.named_parameters()}
    swapped = place_with_shardings(module, dims, mesh, model_axis)
    if optimizer is not None:
        for group in optimizer.param_groups:
            group["params"] = [swapped.get(p, p) for p in group["params"]]
        state = {}
        for p, st in optimizer.state.items():
            new = swapped.get(p, p)
            state[new] = {k: (distribute_tensor(v, new.device_mesh,
                                                new.placements)
                              if torch.is_tensor(v) and v.shape == p.shape
                              and v.dim() > 0 else v)
                          for k, v in st.items()}
        optimizer.state.clear()
        optimizer.state.update(state)
    return dims
