"""Process groups, the counterpart of ``iswm_tpu/parallel/distributed.py``.

The JAX package runs one controller over every device of a mesh.  PyTorch
runs one process per device: each process holds a rank of a
``torch.distributed`` process group, trains on its own rows of the global
batch, and reduces BatchNorm statistics, loss denominators and gradients
over the group explicitly (``models/layers.py``, ``ops/losses.py``,
``train/step.py``).  :func:`group_sum` is the one differentiable sum over a
group they and the spatial split (``spatial.py``) use; the BatchNorm
statistics' sums go through :func:`statistics_sum`, and are counted.

Call ``maybe_initialize_distributed()`` before building the model.  It
opens a group when arguments or torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) configure one, and keeps
the process alone otherwise:

    torchrun --standalone --nproc_per_node=N -m iswm_tpu_torch.cli.train ...

The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU.  A
failed rendezvous raises: the process does not carry on alone.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

# all-reduces of BatchNorm statistics, forward and backward: the
# cross-replica BatchNorm's and the fused stem's and blocks'
cross_replica_all_reduces = 0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK``: the card of this process on its host."""
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def maybe_initialize_distributed(
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Open the default process group when one is configured; returns True
    if this process is in a group.

    Explicit arguments win over torchrun's variables.  ``device`` (default
    :func:`local_device`) picks the backend, ``nccl`` for CUDA and ``gloo``
    for the CPU, unless ``backend`` names one (``gloo`` also reduces CUDA
    tensors, and unlike ``nccl`` takes two ranks on one card)."""
    if is_initialized():
        return True
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is None and rank is None and world_size is None:
        return False
    if init_method is None or rank is None or world_size is None:
        raise ValueError(
            f"a process group needs an init method, a rank and a world size; got "
            f"init_method={init_method!r}, rank={rank}, world_size={world_size}")
    device = torch.device(device) if device is not None else local_device()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for, but no CUDA card is "
                               "available (pass device='cpu' for a gloo group on the CPU)")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def destroy() -> None:
    """Leave the default group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def process_local_batch_slice(global_batch: int) -> int:
    """This process's share of a global batch."""
    n = world_size()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def _summed(x: torch.Tensor, group, count: Callable) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    count(out)
    return out


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, count):
        ctx.group, ctx.count = group, count
        return _summed(x, group, count)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group, ctx.count), None, None


def group_sum(x: torch.Tensor, group=None, count: Callable = lambda t: None) -> torch.Tensor:
    """``x`` summed over ``group`` (None: the default group), into a new
    tensor.  Differentiable: each rank's loss holds its own rows only, so the
    gradient of a sum over the group is the sum of the ranks' gradients, and
    the backward is a sum over the group too.  ``count(t)`` is called with the
    output of each all-reduce, forward and backward."""
    return _GroupSum.apply(x, group, count)


def _count_statistics(_t: torch.Tensor) -> None:
    global cross_replica_all_reduces
    cross_replica_all_reduces += 1


def statistics_sum(t: torch.Tensor) -> torch.Tensor:
    """:func:`group_sum` over the default group of BatchNorm statistics,
    counted in ``cross_replica_all_reduces``."""
    return group_sum(t, None, _count_statistics)


def group_batch_sums(s: torch.Tensor, q: torch.Tensor, count: int):
    """(S, Q, N): per-channel float32 sums of y and y^2 over this process's
    ``count`` values a channel, summed over the default group with the
    counts in one all-reduce of ``cat([s, q, n])`` (N a 1-element tensor);
    the sums as given without a group.  S and Q carry gradients back to s
    and q (a second all-reduce, in the backward)."""
    if not is_initialized():
        return s, q, count
    n = torch.full((1,), count, dtype=torch.float32, device=s.device)
    c = s.shape[0]
    total = statistics_sum(torch.cat([s.float(), q.float(), n]))
    return total[:c], total[c:2 * c], total[2 * c:]
