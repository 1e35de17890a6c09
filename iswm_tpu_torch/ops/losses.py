"""Segmentation losses, the counterpart of ``iswm_tpu/ops/losses.py``.

NCHW logits ``[B, C, H, W]`` (the model's layout), labels ``[B, H, W]``
integer with ``ignore_index`` (255) ignored; the loss math is float32
whatever the logits' dtype.

  - ``cross_entropy_loss``          — mean CE over non-ignored pixels
    (denominator ``max(sum w, 1.0)``);
  - ``weighted_cross_entropy_loss`` — per-class weights ("IWce_loss"),
    ``sum w[y] * ce / max(sum w[y], 1e-12)``;
  - ``focal_loss``                  — ``alpha * (1 - pt)^gamma * ce`` with a
    plain mean over ALL pixels, ignored ones included (as the reference's
    ``reduction='none'`` + ``.mean()``).

``make_loss_fn`` routes binary ``ce_loss`` / ``IWce_loss`` through the
fused CE kernel (``ops/kernels/fused_ce.py``) as the JAX package routes
them through its Pallas kernel.

In a process group each rank holds its rows of the global batch, and every
loss keeps the JAX package's global semantics (its jit sharded over the data
axis divides by the whole batch's weights or pixels): the fused path takes
the sharded CE, and the autograd losses (``sharded=True``) divide their
local numerator by the all-reduced denominator.  Every loss then returns the
global loss, the same value on every rank, with the gradient of this rank's
share of it: the gradient reduction sums the shares over the ranks.  A group
of one rank runs the same code as a group of many (and gives the numbers of
one process), as the cross-replica BatchNorm does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from ..parallel.distributed import is_initialized
from .kernels.fused_ce import fused_binary_ce, make_sharded_fused_ce


def _global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the default group (no gradient)."""
    t = t.detach().clone()
    torch.distributed.all_reduce(t)
    return t


class _GlobalValue(torch.autograd.Function):
    """The sum of a rank's share of a loss over the ranks as the value, with
    the gradient of the share alone (the gradient reduction adds the rest)."""

    @staticmethod
    def forward(ctx, share):
        return _global_sum(share)

    @staticmethod
    def backward(ctx, grad):
        return grad


def _mean(numerator, denominator, floor, sharded):
    """``numerator / max(denominator, floor)``, both summed over the ranks
    when ``sharded`` (only the numerator differentiable)."""
    if not sharded:
        return numerator / torch.clamp_min(denominator, floor)
    return _GlobalValue.apply(numerator / torch.clamp_min(_global_sum(denominator), floor))


def _per_pixel_ce(logits, labels, class_weights, ignore_index):
    """(ce, pixel weight) per pixel in f32; ignored pixels get weight 0."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lf = logits.float()
    ce = torch.logsumexp(lf, dim=1) - lf.gather(1, safe[:, None]).squeeze(1)
    if class_weights is not None:
        w = class_weights.to(device=logits.device, dtype=torch.float32)[safe]
    else:
        w = torch.ones_like(ce)
    return ce, torch.where(valid, w, torch.zeros_like(w))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = 255, sharded: bool = False) -> torch.Tensor:
    """Mean CE over non-ignored pixels ("ce_loss")."""
    ce, w = _per_pixel_ce(logits, labels, None, ignore_index)
    return _mean((ce * w).sum(), w.sum(), 1.0, sharded)


def weighted_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                                class_weights: torch.Tensor, *,
                                ignore_index: int = 255,
                                sharded: bool = False) -> torch.Tensor:
    """Class-weighted CE ("IWce_loss"): sum(w[y] * ce) / sum(w[y])."""
    ce, w = _per_pixel_ce(logits, labels, class_weights, ignore_index)
    return _mean((ce * w).sum(), w.sum(), 1e-12, sharded)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *, alpha: float = 1.0,
               gamma: float = 0.0, class_weights: Optional[torch.Tensor] = None,
               ignore_index: int = 255, size_average: bool = True,
               sharded: bool = False) -> torch.Tensor:
    """Focal loss; the mean runs over all pixels, ignored ones (0) included."""
    ce, w = _per_pixel_ce(logits, labels, class_weights, ignore_index)
    ce = ce * w
    fl = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    if not sharded:
        return fl.mean() if size_average else fl.sum()
    if not size_average:
        return _GlobalValue.apply(fl.sum())
    return _mean(fl.sum(), torch.tensor(float(fl.numel()), device=fl.device), 1.0, True)


def make_loss_fn(
    loss_type: str,
    *,
    class_weights=None,
    ignore_index: int = 255,
    focal_alpha: float = 1.0,
    focal_gamma: float = 0.0,
    fused: str = "auto",
    num_classes: int = 2,
    device="cpu",
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Loss factory, ``loss_fn(logits, labels) -> 0-d f32``.

    ``fused`` (binary ``ce_loss`` / ``IWce_loss`` only): ``auto`` takes the
    fused CE kernel when ``device`` is a CUDA device and the autograd path
    otherwise, as the JAX package takes its Pallas kernel on the
    accelerator only; ``always`` takes the fused path on any device;
    ``interpret`` is ``always`` (on a CPU tensor the fused path runs the
    kernel's plain version, the port's counterpart of the Pallas
    interpreter); ``never`` keeps the autograd path.

    In a process group the fused path is the sharded CE and the autograd
    losses divide by the global denominator.
    """
    if fused not in ("auto", "always", "never", "interpret"):
        raise ValueError(f"unknown fused mode {fused!r}")
    device = torch.device(device)
    cw = None
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32).to(device)
    want_fused = (
        loss_type in ("ce_loss", "IWce_loss") and num_classes == 2
        and (fused in ("always", "interpret")
             or (fused == "auto" and device.type == "cuda"))
    )
    sharded = is_initialized()
    if want_fused:
        fused_cw = cw if cw is not None else torch.ones(2, device=device)
        if sharded:
            return partial(make_sharded_fused_ce(ignore_index=ignore_index),
                           class_weights=fused_cw)
        return partial(fused_binary_ce, class_weights=fused_cw,
                       ignore_index=ignore_index)
    if loss_type == "ce_loss":
        return partial(cross_entropy_loss, ignore_index=ignore_index, sharded=sharded)
    if loss_type == "IWce_loss":
        if cw is None:
            raise ValueError("IWce_loss requires class_weights")
        return partial(weighted_cross_entropy_loss, class_weights=cw,
                       ignore_index=ignore_index, sharded=sharded)
    if loss_type == "focal_loss":
        return partial(focal_loss, alpha=focal_alpha, gamma=focal_gamma,
                       class_weights=cw, ignore_index=ignore_index, sharded=sharded)
    raise ValueError(f"unknown loss_type {loss_type!r}")
