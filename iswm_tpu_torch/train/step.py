"""Train and eval steps, the counterpart of ``iswm_tpu/train/step.py``.

One train step: uint8 -> /255 -> device augmentation (when given) ->
forward in train mode -> loss -> backward -> optimizer step -> scheduler
step.  PyTorch runs it eagerly; the step returns the loss as a device
tensor and reads nothing back, so it makes no host sync.  Images enter
channels last, [B, H, W, C], as in the JAX package; the NCHW view the model
takes is a permute (channels-last memory, no copy).

Under quantization-aware training the train forward (the model in train
mode) updates the delayed mode's running amaxes; the eval forward (eval mode)
quantizes with each tensor's own amax in either mode, as the JAX package's
eval step, which applies the model without its "quant" collection.

With ``remat`` the train forward rematerializes its activations block by
block (``models/remat.py``): each block keeps its input, and the backward
recomputes its forward, with the same arithmetic, so the step's results are
those of the plain step.  The forward kernels run twice a step then.

In a process group the step runs through ``data_parallel``'s
``DistributedDataParallel`` wrapper, whose gradient reduction SUMS over the
ranks (the JAX package's psum) where DDP's default averages: with the
cross-replica BatchNorm and the global loss denominators each rank's
gradient is its share of the global batch's, and the sum is that gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..data.transforms import AugmentConfig, augment_batch, val_transform_batch
from ..models.remat import rematerialized


@dataclass
class TrainState:
    """What a training run carries from step to step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    # the DistributedDataParallel wrapper of ``model`` the train step runs
    # through in a process group (``data_parallel``)
    replicated: Optional[torch.nn.Module] = None


def _sum_gradients(group, bucket):
    """DDP comm hook: all-reduce (sum) a ``dist.GradBucket``, without DDP's
    division by the world size; returns a future of the bucket's tensor.
    (DDP reads the hook's annotations at run time, so it has none.)"""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def data_parallel(model: torch.nn.Module) -> DistributedDataParallel:
    """Wrap ``model`` for the default process group: its gradients are
    summed over the ranks; buffers are not broadcast (the cross-replica
    BatchNorm gives every rank the same running statistics)."""
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)
    ddp.register_comm_hook(None, _sum_gradients)
    return ddp


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    augment: Optional[AugmentConfig] = None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], torch.Tensor]:
    """``train_step(state, images, labels) -> loss`` (0-d, on the device).

    With ``augment``, images are raw uint8 (or [0, 1] float) and go through
    scale/crop/flip/normalize drawn from ``generator`` (on the images'
    device); without it they are used as given.  ``remat`` recomputes the
    forward's activations in the backward, block by block.  Updates
    ``state`` in place."""
    if augment is not None and generator is None:
        raise ValueError("augmentation needs a torch.Generator")

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        if augment is not None:
            images, labels = augment_batch(images, labels, augment, generator)
        net = state.model if state.replicated is None else state.replicated
        net.train()
        with rematerialized(remat):
            logits = net(images.permute(0, 3, 1, 2))
        loss = loss_fn(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(
    model: torch.nn.Module,
    normalize_input: bool = True,
    want: Tuple[str, ...] = ("logits", "probs", "preds"),
) -> Callable[[torch.Tensor], dict]:
    """``eval_step(images [B, H, W, C]) -> dict``: ``logits`` and ``probs``
    [B, C, H, W] (the model's layout), ``preds`` [B, H, W] int32 (argmax,
    validation semantics), as ``want`` selects; uint8 images are
    normalized first."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor) -> dict:
        if normalize_input and images.dtype == torch.uint8:
            images = val_transform_batch(images)
        model.eval()
        logits = model(images.permute(0, 3, 1, 2))
        out = {}
        if "logits" in want:
            out["logits"] = logits
        if "probs" in want:
            out["probs"] = torch.softmax(logits.float(), dim=1)
        if "preds" in want:
            out["preds"] = logits.argmax(dim=1).to(torch.int32)
        return out

    return eval_step
