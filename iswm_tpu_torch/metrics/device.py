"""Metric reductions on tensors (the fast in-training evaluation path), the
counterpart of ``iswm_tpu/metrics/device.py``.

The canonical metrics engine (``.stream``) reproduces the reference's
host-side evaluators exactly, quirks and all.  This module has plain
functions on tensors, run on the tensors' own device, for the pieces that
dominate evaluation time, so that a training-time quick-eval needs no host
round-trip per frame:

  - streaming confusion matrix (the hand-written CUDA kernel for the binary
    case on the card, an integer scatter-add of class pairs otherwise;
    reference stream_metrics.py:24-31);
  - MIoU/FIoU/precision/recall/F1 from the CM (stream_metrics.py:33-63);
  - wave presence ratios (mask_utils.py:138-143, without the morphological
    cleanup — documented approximation);
  - batched per-row front extraction (mask_utils.py:54-75 core) and a
    batched symmetric front-distance error (the O(P*G) double loop of
    front_tracking_metrics.py:48-86 as one [H, H] distance-matrix
    reduction per frame — without the preprocess/weighting quirks).

Use ``StreamMetrics`` for reported numbers; use these for cheap monitoring
on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.kernels.confusion import binary_confusion_matrix

EPS = 1e-7


def confusion_matrix(gts: torch.Tensor, preds: torch.Tensor,
                     n_classes: int = 2) -> torch.Tensor:
    """[...] int labels/preds -> [C, C] f32 CM (rows = true), 255 excluded.

    A prediction outside [0, C) is counted in no column (the JAX function's
    one-hot of it is all zeros).  The counts are summed as integers, so the
    matrix is exact while each entry is below 2**24."""
    gt = gts.reshape(-1).long()
    pred = preds.reshape(-1).long()
    valid = (gt >= 0) & (gt < n_classes) & (pred >= 0) & (pred < n_classes)
    index = gt[valid] * n_classes + pred[valid]
    cm = torch.zeros(n_classes * n_classes, dtype=torch.int64, device=gt.device)
    cm.scatter_add_(0, index, torch.ones_like(index))
    return cm.reshape(n_classes, n_classes).float()


def foreground_metrics_from_cm(cm: torch.Tensor) -> dict:
    """(miou, fiou, precision, recall, f1) as 0-d tensors on the CM's device
    (stream_metrics.py:33-63)."""
    tp = cm[1, 1]
    fp = cm[:, 1].sum() - tp
    fn = cm[1, :].sum() - tp
    fiou = tp / (tp + fp + fn + EPS)
    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)
    btp = cm[0, 0]
    bfp = cm[:, 0].sum() - btp
    bfn = cm[0, :].sum() - btp
    biou = btp / (btp + bfp + bfn + EPS)
    return {
        "miou": (biou + fiou) / 2.0,
        "fiou": fiou,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def wave_presence(masks: torch.Tensor, threshold: float = 0.005) -> torch.Tensor:
    """[B, H, W] masks -> [B] bool presence by foreground fraction."""
    ratio = (masks > 0).float().mean(dim=(1, 2))
    return ratio >= threshold


def front_positions_batch(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] binary masks -> ([B, H] leftmost col, [B, H] row-has-fg).

    The leftmost foreground column of a row, and 0 for a row without
    foreground (what an argmax of the boolean row gives where ties go to
    the first index), written as a masked minimum over column indices."""
    binary = masks > 0
    has_fg = binary.any(dim=-1)
    w = binary.shape[-1]
    index = torch.arange(w, device=masks.device)
    cols = torch.where(binary, index, w).amin(dim=-1)
    return torch.where(has_fg, cols, 0), has_fg


def _first_argmin(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise (first index of the minimum, minimum) of [N, M]; ``inf``
    everywhere gives index 0."""
    min_dist = dist.amin(dim=1)
    index = torch.arange(dist.shape[1], device=dist.device)
    first = torch.where(dist == min_dist[:, None], index, dist.shape[1]).amin(dim=1)
    return first, min_dist


def symmetric_front_error(pred_mask: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Batched symmetric nearest-front distance for one frame pair [H, W].

    The tensor counterpart of the reference's per-point double loop
    (front_tracking_metrics.py:48-86): fronts are (row, leftmost col)
    points; each direction takes the nearest-euclidean distance weighted by
    1/(|dx|+1e-6); the result is max of the two weighted means.  Empty
    cases return the reference's penalties (2*tau miss, 1.5*tau FA, 0).
    """
    h, w = pred_mask.shape
    tau = w * 0.1
    p_cols, p_valid = front_positions_batch(pred_mask[None])
    g_cols, g_valid = front_positions_batch(gt_mask[None])
    p_cols, p_valid = p_cols[0].float(), p_valid[0]
    g_cols, g_valid = g_cols[0].float(), g_valid[0]
    rows = torch.arange(h, dtype=torch.float32, device=pred_mask.device)
    inf = torch.tensor(float("inf"), device=pred_mask.device)
    zero = torch.zeros((), device=pred_mask.device)

    def directional(src_cols, src_valid, dst_cols, dst_valid):
        dy = rows[:, None] - rows[None, :]
        dx = src_cols[:, None] - dst_cols[None, :]
        dist = torch.sqrt(dy**2 + dx**2)
        dist = torch.where(dst_valid[None, :], dist, inf)
        nearest, min_dist = _first_argmin(dist)
        min_dx = torch.abs(src_cols - dst_cols[nearest])
        ok = src_valid & (min_dist < tau)
        wgt = torch.where(ok, 1.0 / (min_dx + 1e-6), zero)
        err_sum = torch.sum(torch.where(ok, min_dist, zero) * wgt)
        return err_sum, torch.sum(wgt), torch.sum(ok)

    p2g = directional(p_cols, p_valid, g_cols, g_valid)
    g2p = directional(g_cols, g_valid, p_cols, p_valid)

    has_p = p_valid.any()
    has_g = g_valid.any()

    pred_avg = p2g[0] / torch.clamp_min(p2g[1], 1e-12)
    gt_avg = g2p[0] / torch.clamp_min(g2p[1], 1e-12)
    n_g = torch.clamp_min(torch.sum(g_valid), 1)
    coverage = g2p[2] / n_g
    both = torch.maximum(pred_avg, gt_avg) + 0.5 * (1.0 - coverage) * tau
    miss = torch.full_like(both, 2.0 * tau)
    both = torch.where((p2g[2] == 0) | (g2p[2] == 0), miss, both)

    return torch.where(
        has_g & ~has_p,
        miss,
        torch.where(~has_g & has_p, torch.full_like(both, 1.5 * tau),
                    torch.where(~has_g & ~has_p, torch.zeros_like(both), both)),
    )


class DeviceEvalAccumulator:
    """Streaming CM accumulation over eval batches, on the batches' device.

    With two classes (the production configuration) each update goes
    through :func:`binary_confusion_matrix`, the hand-written kernel on the
    card; more classes take :func:`confusion_matrix`.  Only ``results``
    brings values to the host."""

    def __init__(self, n_classes: int = 2):
        self.n_classes = n_classes
        self.cm = None

    def update(self, gts: torch.Tensor, preds: torch.Tensor) -> None:
        if self.n_classes == 2:
            cm = binary_confusion_matrix(gts, preds)
        else:
            cm = confusion_matrix(gts, preds, self.n_classes)
        self.cm = cm if self.cm is None else self.cm + cm

    def results(self) -> dict:
        cm = self.cm if self.cm is not None else torch.zeros(
            (self.n_classes, self.n_classes))
        metrics = foreground_metrics_from_cm(cm)
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))

    def reset(self) -> None:
        self.cm = None
