from .mesh import (
    DataMesh,
    GradientReducer,
    broadcast_module,
    get_data_mesh,
    maybe_init_distributed,
    shard_batch,
)
from .shard import NO_SHARD, DataShard, sum_exact

__all__ = [
    "DataMesh",
    "DataShard",
    "GradientReducer",
    "NO_SHARD",
    "broadcast_module",
    "get_data_mesh",
    "maybe_init_distributed",
    "shard_batch",
    "sum_exact",
]
