"""StreamMetrics facade + the single weighted-score implementation.

Re-specification of the reference facade (reference
metrics/stream_metrics.py:7-196).  The composite weighted score —
0.05*MIoU + 0.25*FIoU + 0.25*FF1 + 0.25*(1 - min(FTE/10, 1)) + 0.10*TC +
0.10*RC — was duplicated in three places in the reference
(stream_metrics.py:65-100, train.py:128-167, train.py:760-797); here
``weighted_score`` is the one canonical function every caller uses.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from .front_tracking import FrontTrackingMetrics
from .region import RegionMetrics
from .temporal import TemporalMetrics

FOREGROUND_CLASS = 1
EPS = 1e-7  # reference stream_metrics.py:49

DEFAULT_WEIGHTS: Dict[str, float] = {
    "MIoU": 0.05,
    "Foreground IoU": 0.25,
    "Foreground F1": 0.25,
    "Front Tracking Error": 0.25,  # inverted/normalized below
    "Temporal Consistency": 0.10,
    "Region Continuity": 0.10,
}
MAX_FTE = 10.0  # reference stream_metrics.py:86


def weighted_score(
    results: Mapping[str, float],
    weights: Optional[Mapping[str, float]] = None,
    max_fte: float = MAX_FTE,
) -> float:
    """Composite score (reference stream_metrics.py:65-100 / train.py:842-850)."""
    w = dict(DEFAULT_WEIGHTS if weights is None else weights)
    fte = results["Front Tracking Error"]
    norm_fte = 1.0 - min(fte / max_fte, 1.0)
    return float(
        w["MIoU"] * results["MIoU"]
        + w["Foreground IoU"] * results["Foreground IoU"]
        + w["Foreground F1"] * results["Foreground F1"]
        + w["Front Tracking Error"] * norm_fte
        + w["Temporal Consistency"] * results["Temporal Consistency"]
        + w["Region Continuity"] * results["Region Continuity"]
    )


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray, n_classes: int):
    """Confusion-matrix accumulation via bincount (reference :24-31)."""
    label_true = np.asarray(label_true)
    label_pred = np.asarray(label_pred)
    mask = (label_true >= 0) & (label_true < n_classes)
    hist = np.bincount(
        n_classes * label_true[mask].astype(int) + label_pred[mask].astype(int),
        minlength=n_classes**2,
    ).reshape(n_classes, n_classes)
    return hist


def foreground_metrics(hist: np.ndarray):
    """(miou, fiou, precision, recall, f1) from a 2x2+ CM (reference :33-63)."""
    tp = hist[FOREGROUND_CLASS, FOREGROUND_CLASS]
    fp = hist[:, FOREGROUND_CLASS].sum() - tp
    fn = hist[FOREGROUND_CLASS, :].sum() - tp

    fiou = tp / (tp + fp + fn + EPS)
    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)

    btp = hist[0, 0]
    bfp = hist[:, 0].sum() - btp
    bfn = hist[0, :].sum() - btp
    biou = btp / (btp + bfp + bfn + EPS)
    miou = (biou + fiou) / 2.0
    return float(miou), float(fiou), float(precision), float(recall), float(f1)


class StreamMetrics:
    """Streaming facade over the four evaluators (reference stream_metrics.py).

    ``update(gts, preds, sequence_data=True)`` feeds the whole window to the
    temporal evaluator and the LAST frame only to region / front / CM
    (reference :102-122) — the asymmetry is intentional.

    The reference's ``temporal_stride`` parameter (stream_metrics.py:10) is
    accepted there and never read — a dead knob, NOT reproduced here.
    """

    def __init__(
        self,
        n_classes: int,
        sequence_length: int = 7,
        threshold: float = 0.005,
        weights: Optional[Mapping[str, float]] = None,
        max_fte: float = MAX_FTE,
    ):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes))
        self.weights = dict(DEFAULT_WEIGHTS if weights is None else weights)
        self.max_fte = max_fte
        self.best_score: Dict[str, float] = {"weighted_score": 0.0}

        self.temporal_evaluator = TemporalMetrics(
            sequence_length=sequence_length, threshold=threshold
        )
        self.region_evaluator = RegionMetrics()
        self.front_tracking_evaluator = FrontTrackingMetrics()

    def update(self, label_trues, label_preds, sequence_data: bool = True) -> None:
        if sequence_data:
            # The whole [T,H,W] window goes to the temporal evaluator, whose
            # preprocess collapses it to the cleaned LAST frame before
            # appending to its ring buffer (reference temporal_metrics.py:129-133
            # via mask_utils.py:11-12) — one frame enters the buffer per window.
            self.temporal_evaluator.update(label_preds, label_trues)
            self.region_evaluator.update(label_preds[-1], label_trues[-1])
            self.front_tracking_evaluator.update(label_preds[-1], label_trues[-1])
            hist = fast_hist(
                np.asarray(label_trues[-1]).flatten(),
                np.asarray(label_preds[-1]).flatten(),
                self.n_classes,
            )
        else:
            self.region_evaluator.update(label_preds, label_trues)
            self.front_tracking_evaluator.update(label_preds, label_trues)
            hist = fast_hist(
                np.asarray(label_trues).flatten(),
                np.asarray(label_preds).flatten(),
                self.n_classes,
            )
        self.confusion_matrix += hist

        current = self.get_results(update_best=False)
        score = weighted_score(current, self.weights, self.max_fte)
        if score > self.best_score["weighted_score"]:
            self.best_score["weighted_score"] = score
            self.best_score.update(
                {
                    "miou": current["MIoU"],
                    "foreground_iou": current["Foreground IoU"],
                    "foreground_f1": current["Foreground F1"],
                    "temporal_consistency": current["Temporal Consistency"],
                    "front_tracking_error": current["Front Tracking Error"],
                    "region_continuity": current["Region Continuity"],
                }
            )

    def get_results(self, update_best: bool = True) -> Dict[str, float]:
        miou, fiou, precision, recall, f1 = foreground_metrics(self.confusion_matrix)
        results: Dict[str, float] = {
            "MIoU": miou,
            "Foreground IoU": fiou,
            "Foreground F1": f1,
            "Temporal Consistency": self.temporal_evaluator.get_mean_score(),
            "Front Tracking Error": self.front_tracking_evaluator.get_mean_error(),
            "Region Continuity": self.region_evaluator.get_mean_score(),
            "Precision": precision,
            "Recall": recall,
        }

        temporal_stats = self.temporal_evaluator.get_detailed_statistics()
        results.update(
            {
                "Transition Accuracy": temporal_stats["mean_transition"],
                "Stability Score": temporal_stats["mean_stability"],
                "Motion Consistency": temporal_stats["mean_motion"],
                "Wave Segment Score": temporal_stats["mean_wave_segment"],
            }
        )
        region_stats = self.region_evaluator.get_statistics()
        results["Region Valid Ratio"] = region_stats["valid_ratio"]

        if update_best:
            score = weighted_score(results, self.weights, self.max_fte)
            if score > self.best_score["weighted_score"]:
                self.best_score["weighted_score"] = score
        results["Best Score"] = self.best_score["weighted_score"]
        return results

    def to_str(self, results: Mapping[str, float]) -> str:
        return "\n".join(f"{k}: {v}" for k, v in results.items())

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))
        self.temporal_evaluator.reset()
        self.region_evaluator.reset()
        self.front_tracking_evaluator.reset()
