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
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from .kernels.fused_ce import fused_binary_ce


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
                       ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over non-ignored pixels ("ce_loss")."""
    ce, w = _per_pixel_ce(logits, labels, None, ignore_index)
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1.0)


def weighted_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                                class_weights: torch.Tensor, *,
                                ignore_index: int = 255) -> torch.Tensor:
    """Class-weighted CE ("IWce_loss"): sum(w[y] * ce) / sum(w[y])."""
    ce, w = _per_pixel_ce(logits, labels, class_weights, ignore_index)
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *, alpha: float = 1.0,
               gamma: float = 0.0, class_weights: Optional[torch.Tensor] = None,
               ignore_index: int = 255, size_average: bool = True) -> torch.Tensor:
    """Focal loss; the mean runs over all pixels, ignored ones (0) included."""
    ce, w = _per_pixel_ce(logits, labels, class_weights, ignore_index)
    ce = ce * w
    fl = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    return fl.mean() if size_average else fl.sum()


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
    if want_fused:
        fused_cw = cw if cw is not None else torch.ones(2, device=device)
        return partial(fused_binary_ce, class_weights=fused_cw,
                       ignore_index=ignore_index)
    if loss_type == "ce_loss":
        return partial(cross_entropy_loss, ignore_index=ignore_index)
    if loss_type == "IWce_loss":
        if cw is None:
            raise ValueError("IWce_loss requires class_weights")
        return partial(weighted_cross_entropy_loss, class_weights=cw,
                       ignore_index=ignore_index)
    if loss_type == "focal_loss":
        return partial(focal_loss, alpha=focal_alpha, gamma=focal_gamma,
                       class_weights=cw, ignore_index=ignore_index)
    raise ValueError(f"unknown loss_type {loss_type!r}")
