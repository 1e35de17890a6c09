"""Training across processes, the counterpart of ``iswm_tpu/parallel``:
process groups, the (data, model) layout, and the image rows split over a
model group (``spatial``).  ``python -m iswm_tpu_torch.parallel.dryrun``
runs the multi-device dry run."""

from .distributed import (
    destroy,
    is_initialized,
    local_device,
    maybe_initialize_distributed,
    process_local_batch_slice,
    rank,
    world_size,
)
from .mesh import Mesh, make_mesh, shard_batch, spatial_rows

__all__ = [
    "Mesh",
    "destroy",
    "is_initialized",
    "local_device",
    "make_mesh",
    "maybe_initialize_distributed",
    "process_local_batch_slice",
    "rank",
    "shard_batch",
    "spatial_rows",
    "world_size",
]
