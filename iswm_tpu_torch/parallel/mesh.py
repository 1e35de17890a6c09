"""The data layout of a run, the counterpart of ``iswm_tpu/parallel/mesh.py``.

The JAX package builds a (data, model) ``Mesh`` of devices and shards the
batch over ``data``.  Here every rank of the process group is one replica on
the data axis: ``make_mesh`` checks the requested axes against the world
size with the JAX package's errors, and ``shard_batch`` gives this rank its
rows of a global batch.  The model axis (the JAX package's spatial H split,
``spatial_sharding``) has no counterpart yet and is refused.
"""

from __future__ import annotations

from dataclasses import dataclass

from .distributed import process_local_batch_slice, rank, world_size

SPATIAL_ITEM = "ROADMAP.md Queue 1, 'Spatial model axis'"


@dataclass(frozen=True)
class Mesh:
    """``data`` replicas times ``model`` shards (always 1 here)."""

    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data_axis: int = -1, model_axis: int = 1) -> Mesh:
    """The (data, model) layout over the default group's ranks;
    ``data_axis=-1`` puts every rank on the data axis."""
    n = world_size()
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"model_axis {model_axis} must divide device count {n}")
    if data_axis == -1:
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"data_axis*model_axis ({data_axis}*{model_axis}) != devices ({n})")
    if model_axis > 1:
        raise NotImplementedError(
            f"a model axis of {model_axis} (the spatial H split) is not ported yet "
            f"({SPATIAL_ITEM}); every rank is a data replica")
    return Mesh(data_axis, model_axis)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global batch (numpy arrays or tensors)."""
    if mesh.data != world_size():
        raise ValueError(f"a mesh of {mesh.data} replicas in a group of {world_size()}")
    out = []
    for a in arrays:
        rows = process_local_batch_slice(len(a))
        out.append(a[rank() * rows:(rank() + 1) * rows])
    return tuple(out) if len(out) > 1 else out[0]
