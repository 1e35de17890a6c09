"""Front-tracking error evaluator.

Numpy-vectorized re-specification of the reference evaluator (reference
metrics/front_tracking_metrics.py:6-134).  Constants preserved exactly:
tau = 0.1 * image_width; miss penalty 2*tau; false-alarm penalty 1.5*tau;
both-empty 0; all-points-beyond-tau 2*tau; final error = max(directional
weighted mean errors) + 0.5 * (1 - gt coverage) * tau.

The reference's O(P*G) Python double loop (front_tracking_metrics.py:48-86)
becomes a single (P, G) distance-matrix reduction.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .mask_utils import find_front_positions, preprocess_mask


def _directional(
    src: np.ndarray, dst: np.ndarray, tau: float
) -> Tuple[float, float, int]:
    """For each src point: nearest dst point (euclidean); keep points with
    min_dist < tau; weight by 1/(|dx at argmin| + 1e-6).

    Returns (weighted error sum, weight sum, valid point count).
    """
    # (P, G) distances
    diff = src[:, None, :] - dst[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    nearest = dist.argmin(axis=1)
    min_dist = dist[np.arange(len(src)), nearest]
    min_dist_x = np.abs(src[:, 1] - dst[nearest, 1])

    valid = min_dist < tau
    w = 1.0 / (min_dist_x[valid] + 1e-6)
    return float((min_dist[valid] * w).sum()), float(w.sum()), int(valid.sum())


class FrontTrackingMetrics:
    """Streaming front-tracking error (reference front_tracking_metrics.py)."""

    def __init__(self):
        self.max_distance_threshold: Optional[float] = None
        self.tracking_errors: List[float] = []

    def set_max_distance_threshold(self, image_width: int) -> None:
        self.max_distance_threshold = image_width * 0.1

    def calculate_error(self, pred, gt) -> float:
        try:
            return self._calculate_error(pred, gt)
        except Exception:
            # safe_process(error_value=inf) (reference front_tracking_metrics.py:17)
            return float("inf")

    def _calculate_error(self, pred, gt) -> float:
        if self.max_distance_threshold is None:
            self.set_max_distance_threshold(np.asarray(pred).shape[1])
        tau = self.max_distance_threshold

        # The reference preprocesses here AND inside find_front_positions
        # (front_tracking_metrics.py:24-28 then mask_utils.py:58).  The double
        # pass re-binarizes a weighted multi-region mask (values 0.4-0.8 -> 1),
        # so fronts ARE found for masks that stability/presence treat as
        # empty.  Quirk preserved deliberately.
        pred_fronts = find_front_positions(preprocess_mask(pred))
        gt_fronts = find_front_positions(preprocess_mask(gt))

        if gt_fronts and not pred_fronts:
            return tau * 2.0  # miss
        if not gt_fronts and pred_fronts:
            return tau * 1.5  # false alarm
        if not gt_fronts and not pred_fronts:
            return 0.0

        p = np.asarray(pred_fronts, dtype=np.float64)
        g = np.asarray(gt_fronts, dtype=np.float64)

        p2g_sum, p2g_w, p_valid = _directional(p, g, tau)
        g2p_sum, g2p_w, g_valid = _directional(g, p, tau)

        if p_valid == 0 or g_valid == 0:
            return tau * 2.0

        pred_avg = p2g_sum / p2g_w if p2g_w > 0 else float("inf")
        gt_avg = g2p_sum / g2p_w if g2p_w > 0 else float("inf")
        gt_coverage = g_valid / len(g)

        max_error = max(pred_avg, gt_avg)
        coverage_penalty = (1.0 - gt_coverage) * tau
        return max_error + coverage_penalty * 0.5

    def update(self, pred, gt) -> float:
        if self.max_distance_threshold is None:
            self.set_max_distance_threshold(np.asarray(pred).shape[1])
        error = self.calculate_error(pred, gt)
        if error is not None:
            self.tracking_errors.append(error)
        return error

    def get_mean_error(self) -> float:
        valid = [x for x in self.tracking_errors if x is not None and not math.isinf(x)]
        if not valid:
            if self.max_distance_threshold is not None:
                return self.max_distance_threshold * 2.0
            return float("inf")
        return float(np.mean(valid))

    def reset(self) -> None:
        # threshold intentionally NOT reset (reference :131-134)
        self.tracking_errors = []
