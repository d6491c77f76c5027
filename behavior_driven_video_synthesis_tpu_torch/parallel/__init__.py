"""Multi-device training: data parallelism over one process per GPU
(``mesh.py``) and FSDP of the behavior flow (``sharding_rules.py``)."""
from .mesh import (allreduce_mean_, batch_shard, gather_rows, is_main,
                   rank, replicate, shard_batch, sync_gradients, world_size)
from .sharding_rules import fsdp_leaf_dim, shard_fsdp

__all__ = ["allreduce_mean_", "batch_shard", "fsdp_leaf_dim", "gather_rows",
           "is_main", "rank", "replicate", "shard_batch", "shard_fsdp",
           "sync_gradients", "world_size"]
