"""Region-continuity evaluator.

Re-specification of the reference evaluator (reference
metrics/region_metrics.py:13-158).  Constants preserved: gap repair =
dilate x3 / erode x2 (3x3); min region area 50; fragmentation = largest
area ratio - 0.5 * rank-weighted penalty over the rest; final =
0.7 * fragmentation + 0.3 * IoU similarity; frames where either mask is
empty are skipped entirely (returns None, counted invalid).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ._morphology import connected_components, repair_small_gaps

MIN_AREA_THRESHOLD = 50  # reference region_metrics.py:18
FRAGMENTATION_WEIGHT = 0.7  # reference region_metrics.py:104-107
SIMILARITY_WEIGHT = 0.3


def _fragmentation_score(areas: np.ndarray) -> float:
    """Largest-area dominance with rank-weighted extra-region penalty
    (reference region_metrics.py:20-36)."""
    if len(areas) == 0:
        return 0.0
    sorted_areas = np.sort(areas)[::-1]
    total = sorted_areas.sum()
    ratios = sorted_areas / total
    score = float(ratios[0])
    if len(areas) > 1:
        n = len(areas)
        ranks = np.arange(2, n + 1)  # (i+1) for i starting at 1
        penalty = float((ratios[1:] * ranks / n).sum())
        score -= penalty * 0.5
    return max(0.0, min(1.0, score))


class RegionMetrics:
    def __init__(self):
        self.valid_scores: List[float] = []
        self.total_cases = 0
        self.invalid_cases = 0
        self.min_area_threshold = MIN_AREA_THRESHOLD

    def _shape_metrics(self, pred: np.ndarray) -> dict:
        try:
            _, _, areas = connected_components(pred)
            valid_areas = areas[areas >= self.min_area_threshold]
            if len(valid_areas) == 0:
                return {
                    "fragmentation_score": 0.0,
                    "similarity_score": 0.0,
                    "final_score": 0.0,
                    "num_regions": 0,
                }
            return {
                "fragmentation_score": _fragmentation_score(valid_areas),
                "num_regions": int(len(valid_areas)),
            }
        except Exception:
            # safe_process error sentinel (reference region_metrics.py:38-41)
            return {
                "fragmentation_score": 0.0,
                "similarity_score": 0.0,
                "final_score": 0.0,
                "num_regions": 0,
            }

    def calculate_region_metrics(self, pred, gt) -> Optional[dict]:
        pred = (np.asarray(pred) > 0).astype(np.uint8)
        gt = (np.asarray(gt) > 0).astype(np.uint8)

        if pred.sum() == 0 or gt.sum() == 0:
            return None  # skipped frames (reference :79-83)

        pred = repair_small_gaps(pred)

        intersection = np.logical_and(pred, gt).sum()
        union = np.logical_or(pred, gt).sum()
        similarity = float(intersection / union)

        shape = self._shape_metrics(pred)
        final = (
            FRAGMENTATION_WEIGHT * shape["fragmentation_score"]
            + SIMILARITY_WEIGHT * similarity
        )
        return {
            "fragmentation_score": shape["fragmentation_score"],
            "similarity_score": similarity,
            "num_regions": shape["num_regions"],
            "final_score": float(final),
        }

    def update(self, pred, gt) -> Optional[dict]:
        self.total_cases += 1
        metrics = self.calculate_region_metrics(pred, gt)
        if metrics is not None:
            self.valid_scores.append(metrics["final_score"])
        else:
            self.invalid_cases += 1
        return metrics

    def get_mean_score(self) -> float:
        if not self.valid_scores:
            return 0.0
        return float(np.mean(self.valid_scores))

    def get_statistics(self) -> dict:
        if not self.valid_scores:
            return {
                "mean_score": None,
                "total_cases": self.total_cases,
                "valid_cases": 0,
                "invalid_cases": self.invalid_cases,
                "valid_ratio": 0.0,
            }
        return {
            "mean_score": float(np.mean(self.valid_scores)),
            "total_cases": self.total_cases,
            "valid_cases": len(self.valid_scores),
            "invalid_cases": self.invalid_cases,
            "valid_ratio": len(self.valid_scores) / self.total_cases,
        }

    def reset(self) -> None:
        self.valid_scores = []
        self.total_cases = 0
        self.invalid_cases = 0
