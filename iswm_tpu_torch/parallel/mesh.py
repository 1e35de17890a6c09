"""The data layout of a run, the counterpart of ``iswm_tpu/parallel/mesh.py``.

The JAX package builds a (data, model) ``Mesh`` of devices: the batch is
sharded over ``data`` and, with ``spatial_sharding``, the image rows over
``model``.  Here the ranks of the default process group form that grid:
rank ``= data_index * model + model_index``, as the JAX package's
``reshape(data_axis, model_axis)`` orders its devices.  ``shard_batch`` gives
a rank the rows of the global batch of its DATA index (every rank of a model
group gets the same rows, as ``batch_sharding`` ``P("data")`` replicates them
over ``model``), and ``spatial_rows`` its share of the image rows
(``P(data, model)``).  The model group of a rank (``Mesh.group``) is what the
spatial operators exchange halos over (``parallel/spatial.py``); its data
group (``Mesh.data_group``, the ranks of its model index) is what the fused
stem and blocks sum their BatchNorm statistics over under the split, where
every rank of a model group runs them on the group's whole map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .distributed import is_initialized, rank, world_size


@dataclass(frozen=True)
class Mesh:
    """``data`` replicas times ``model`` row shards, and where this rank
    sits in them; ``group`` is this rank's model group and ``data_group``
    the ranks that share its model index (both None when ``model`` is 1)."""

    data: int
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data_axis: int = -1, model_axis: int = 1) -> Mesh:
    """The (data, model) layout over the default group's ranks;
    ``data_axis=-1`` puts every remaining rank on the data axis.  With
    ``model_axis > 1`` every rank creates every model group, then every
    data group, in the same order (``torch.distributed.new_group`` is
    collective)."""
    n = world_size()
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"model_axis {model_axis} must divide device count {n}")
    if data_axis == -1:
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"data_axis*model_axis ({data_axis}*{model_axis}) != devices ({n})")
    r = rank()
    group = data_group = None
    if model_axis > 1:
        import torch.distributed as dist

        for d in range(data_axis):
            g = dist.new_group([d * model_axis + m for m in range(model_axis)])
            if d == r // model_axis:
                group = g
        for m in range(model_axis):
            g = dist.new_group([d * model_axis + m for d in range(data_axis)])
            if m == r % model_axis:
                data_group = g
    return Mesh(data_axis, model_axis, r // model_axis, r % model_axis, group, data_group)


def _check_layout(mesh: Mesh) -> None:
    n = world_size()
    if mesh.data * mesh.model != n or (mesh.model > 1 and not is_initialized()):
        raise ValueError(f"a mesh of {mesh.data} x {mesh.model} ranks in a group of {n}")


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global batch (numpy arrays or tensors): the
    rows of its data index, the same on every rank of a model group."""
    _check_layout(mesh)
    out = []
    for a in arrays:
        if len(a) % mesh.data:
            raise ValueError(f"global batch {len(a)} not divisible by {mesh.data} processes")
        rows = len(a) // mesh.data
        out.append(a[mesh.data_index * rows:(mesh.data_index + 1) * rows])
    return tuple(out) if len(out) > 1 else out[0]


def spatial_rows(mesh: Mesh, a, dim: int = 1):
    """This rank's image rows of ``a`` along ``dim`` (H of [B, H, W, C]
    images and [B, H, W] labels): ``[m * H / M, (m + 1) * H / M)`` for model
    index m of M, the counterpart of ``spatial_sharding``."""
    _check_layout(mesh)
    h = a.shape[dim]
    if h % mesh.model:
        raise ValueError(f"{h} image rows do not split evenly over a model axis of "
                         f"{mesh.model}")
    rows = h // mesh.model
    index = [slice(None)] * a.ndim
    index[dim] = slice(mesh.model_index * rows, (mesh.model_index + 1) * rows)
    return a[tuple(index)]
