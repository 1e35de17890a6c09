"""Data-parallel training across processes, the counterpart of
``iswm_tpu/parallel``: process groups and the data layout."""

from .distributed import (
    destroy,
    is_initialized,
    local_device,
    maybe_initialize_distributed,
    process_local_batch_slice,
    rank,
    world_size,
)
from .mesh import SPATIAL_ITEM, Mesh, make_mesh, shard_batch

__all__ = [
    "Mesh",
    "SPATIAL_ITEM",
    "destroy",
    "is_initialized",
    "local_device",
    "make_mesh",
    "maybe_initialize_distributed",
    "process_local_batch_slice",
    "rank",
    "shard_batch",
    "world_size",
]
