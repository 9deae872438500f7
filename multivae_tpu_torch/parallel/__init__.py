from .mesh import (
    DataMesh,
    broadcast_module,
    combined_state_sharding,
    fsdp_state_sharding,
    get_data_mesh,
    maybe_init_distributed,
    param_placements,
    shard_batch,
    tp_state_sharding,
)
from .shard import NO_SHARD, DataShard, sum_exact
from .state import ShardedState

__all__ = [
    "DataMesh",
    "DataShard",
    "NO_SHARD",
    "ShardedState",
    "broadcast_module",
    "combined_state_sharding",
    "fsdp_state_sharding",
    "get_data_mesh",
    "maybe_init_distributed",
    "param_placements",
    "shard_batch",
    "sum_exact",
    "tp_state_sharding",
]
