"""Multi-device training: data parallelism over one process per GPU
(``mesh.py``), FSDP of the behavior flow and the "model"-axis rules
(``sharding_rules.py``)."""
from .mesh import (allreduce_mean_, batch_shard, gather_rows, is_main,
                   rank, replicate, shard_batch, sync_gradients, world_size)
from .sharding_rules import (fsdp_leaf_dim, infer_param_placements,
                             model_axis_dim, place_with_shardings,
                             shard_fsdp, shard_module_state)

__all__ = ["allreduce_mean_", "batch_shard", "fsdp_leaf_dim", "gather_rows",
           "infer_param_placements", "is_main", "model_axis_dim",
           "place_with_shardings", "rank", "replicate", "shard_batch",
           "shard_fsdp", "shard_module_state", "sync_gradients",
           "world_size"]
