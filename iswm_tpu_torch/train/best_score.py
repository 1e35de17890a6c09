"""Best-model gate, a copy of ``iswm_tpu/train/best_score.py`` (the JAX
package's ``train`` package imports jax).

Replicates the reference's comparison semantics exactly (reference
train.py:747-838):
  - ``initialize_best_score``: -inf sentinels (+inf for FTE);
  - ``is_best_score``: weighted compare over {MIoU, FIoU, FF1, TC, RC}
    skipping NaN current values, plus FTE inverted via max(0, 1 - err/10)
    with |weight|; returns True on first comparison (best is None);
  - ``update_best_score``: NaN-guarded copy with defaults (0.0 / FTE 10.0).

Note: the reference's is_best_score skips a metric's contribution to BOTH
totals when the *current* value is NaN — preserved.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

_WEIGHTED_METRICS = (
    "MIoU",
    "Foreground IoU",
    "Foreground F1",
    "Temporal Consistency",
    "Region Continuity",
)
MAX_FTE = 10.0


def initialize_best_score() -> Dict[str, float]:
    best = {m: -math.inf for m in _WEIGHTED_METRICS + ("Precision", "Recall")}
    best["Front Tracking Error"] = math.inf
    return best


def is_best_score(
    current_score: Mapping[str, float],
    best_score: Optional[Mapping[str, float]],
    weights: Mapping[str, float],
) -> bool:
    if best_score is None:
        return True

    current_total = 0.0
    best_total = 0.0
    for metric in _WEIGHTED_METRICS:
        if metric in weights and weights[metric] > 0:
            current_val = float(current_score[metric])
            best_val = float(best_score.get(metric, 0.0))
            if not math.isnan(current_val):
                current_total += weights[metric] * current_val
                best_total += weights[metric] * best_val

    if "Front Tracking Error" in current_score:
        current_error = float(current_score["Front Tracking Error"])
        best_error = float(best_score.get("Front Tracking Error", MAX_FTE))
        current_error_score = max(0.0, 1.0 - current_error / MAX_FTE)
        best_error_score = max(0.0, 1.0 - best_error / MAX_FTE)
        weight = abs(weights.get("Front Tracking Error", 0.03))
        current_total += weight * current_error_score
        best_total += weight * best_error_score

    return current_total > best_total


def update_best_score(val_score: Mapping[str, float]) -> Dict[str, float]:
    best: Dict[str, float] = {}
    for metric in ("MIoU", "Foreground IoU", "Foreground F1", "Region Continuity"):
        v = val_score.get(metric)
        best[metric] = float(v) if v is not None and not math.isnan(v) else 0.0

    if "Front Tracking Error" in val_score:
        error = float(val_score["Front Tracking Error"])
        best["Front Tracking Error"] = error if not math.isnan(error) else MAX_FTE

    if "Temporal Consistency" in val_score:
        v = val_score["Temporal Consistency"]
        best["Temporal Consistency"] = (
            float(v) if v is not None and not math.isnan(v) else 0.0
        )

    for metric in ("Precision", "Recall"):
        v = val_score.get(metric)
        if v is not None and not math.isnan(v):
            best[metric] = float(v)
    return best
