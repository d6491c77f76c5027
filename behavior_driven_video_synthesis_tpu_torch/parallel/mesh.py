"""Data parallelism over one process per device.

Counterpart of ``behavior_driven_video_synthesis_tpu/parallel/mesh.py``
(``make_mesh``, ``shard_batch``, ``replicate``).  The JAX package shards
every batch over a 1-D ``("data",)`` mesh of the local devices inside one
process, and XLA makes every reduction over the batch global.  The port
runs one process per GPU instead (``torchrun --nproc_per_node=N``), in a
``torch.distributed`` process group:

- every rank holds the same parameters (:func:`replicate` broadcasts them
  from rank 0) and takes its own rows of each global batch
  (:func:`shard_batch`, :func:`shard_slice`); the global batch stays
  ``training.batch_size``;
- each optimizer averages its parameters' gradients over the ranks in
  flattened buckets before it steps (:func:`sync_gradients`), so that the
  update is the one of the mean loss over the global batch;
- inside :func:`batch_shard` the step's draws (``ops/batch_draws.py``: latent
  noise, dropout masks, the ELU+dropout kernel's element offset) are made
  at the global batch's rows from a generator seeded alike on every rank,
  and the rank keeps its rows.  A step of N ranks therefore draws what one
  process draws for the joined batch.

Without a process group every function is the identity of one process;
in a group of one (``torchrun --nproc_per_node=1``) the collectives still
run, over one rank.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ..ops import batch_draws

# Bytes of one flattened all-reduce of gradients.
BUCKET_BYTES = 64 << 20

# True while rank 0 works alone (alone()): no collective is made.
_alone = False


def initialized() -> bool:
    return (not _alone and dist.is_available()
            and dist.is_initialized())


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Whether this process logs, writes checkpoints and draws figures."""
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def init_from_env(device: torch.device) -> Optional[torch.device]:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on CUDA, gloo on the CPU.  Returns this rank's
    device (``cuda:LOCAL_RANK``), or None when there is no ``WORLD_SIZE``
    or a group exists already (the caller's, which it keeps)."""
    if "WORLD_SIZE" not in os.environ or initialized():
        return None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return device


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def alone():
    """Within: this process acts as a run of one process (rank 0 alone
    evaluating, as JAX ``run_inference`` runs on one host), making no
    collective."""
    global _alone
    old = _alone
    _alone = True
    try:
        yield
    finally:
        _alone = old


def shard_slice(n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` rows; an uneven
    split raises, as an uneven JAX sharding does."""
    n = world_size()
    if n_global % n:
        raise ValueError(f"batch of {n_global} rows does not split over "
                         f"{n} ranks")
    per = n_global // n
    return slice(rank() * per, (rank() + 1) * per)


def shard_batch(batch: Dict) -> Dict:
    """This rank's rows of every array (tensor or numpy) of a global
    batch."""
    if world_size() == 1:
        return batch
    sl = None
    out = {}
    for k, v in batch.items():
        if sl is None:
            sl = shard_slice(len(v))
        out[k] = v[sl]
    return out


class ShardedBatches:
    """The rank's rows of each batch of ``loader`` (an iterable of global
    batches with a length)."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return (shard_batch(b) for b in self.loader)


def gather_rows(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch back from every rank's rows (tensors)."""
    if not initialized():
        return batch
    n = world_size()
    out = {}
    for k, v in batch.items():
        v = v.contiguous()
        full = v.new_empty((n * v.shape[0],) + tuple(v.shape[1:]))
        dist.all_gather_into_tensor(full, v)
        out[k] = full
    return out


def replicate(modules: Iterable[torch.nn.Module]) -> None:
    """Broadcast every parameter and buffer from rank 0, in place."""
    if not initialized():
        return
    for m in modules:
        if m is None:
            continue
        for t in list(m.parameters()) + list(m.buffers()):
            dist.broadcast(t.data, src=0)


def _reduce_bucket(bucket, n: int) -> None:
    flat = torch.cat([b.reshape(-1) for b in bucket])
    dist.all_reduce(flat)
    flat.div_(n)
    off = 0
    for b in bucket:
        b.copy_(flat[off:off + b.numel()].view_as(b))
        off += b.numel()


def allreduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place, in flattened buckets of
    one device and dtype of at most :data:`BUCKET_BYTES`."""
    if not initialized():
        return
    n = world_size()
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts:
            nbytes = t.numel() * t.element_size()
            if bucket and size + nbytes > BUCKET_BYTES:
                _reduce_bucket(bucket, n)
                bucket, size = [], 0
            bucket.append(t)
            size += nbytes
        if bucket:
            _reduce_bucket(bucket, n)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor: a parameter, gradient or moment sharded
    by FSDP (``sharding_rules.py``)."""
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def sync_gradients(optimizer: torch.optim.Optimizer) -> None:
    """Have ``optimizer`` average its parameters' gradients over the ranks
    before each step (a step pre-hook).  Parameters sharded by FSDP
    (DTensors) are left out: FSDP reduce-scatters their gradients."""
    if not initialized():
        return

    def hook(opt, args, kwargs):
        allreduce_mean_([p.grad for g in opt.param_groups
                         for p in g["params"]
                         if p.grad is not None and not is_dtensor(p)])
    optimizer.register_step_pre_hook(hook)


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (a new tensor)."""
    if not initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / world_size()


def batch_shard():
    """A context within which the batch in hand is this rank's rows of the
    global batch, and the step's draws (``ops/batch_draws.py``) follow it."""
    return batch_draws.batch_rows(rank(), world_size())
