"""Temporal-consistency evaluator over sliding frame windows.

Re-specification of the reference evaluator (reference
metrics/temporal_metrics.py:5-182).  Window routing preserved exactly:
  - no GT wave in window  -> 1 - false-alarm ratio (:69-72)
  - GT wave everywhere    -> mean(0.5*stability + 0.5*motion) (:43-67)
  - mixed                 -> 0.6*transition accuracy + 0.4*wave-segment (:100-107)
Transition accuracy from np.diff of presence with timing-error scoring
(:21-41); the safe_process(0.0) wrappers are reproduced.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .mask_utils import (
    calculate_motion,
    calculate_stability,
    check_wave_presence,
    preprocess_mask,
)


class TemporalMetrics:
    def __init__(self, sequence_length: int = 7, threshold: float = 0.005):
        self.sequence_length = sequence_length
        self.threshold = threshold
        self.sequence_predictions: list = []
        self.sequence_groundtruth: list = []
        self.temporal_scores: List[float] = []
        self.transition_scores: List[float] = []
        self.stability_scores: List[float] = []
        self.motion_scores: List[float] = []
        self.wave_segment_scores: List[float] = []

    # ------------------------------------------------------------- pieces
    def _evaluate_transitions(self, gt_has_wave, pred_has_wave) -> float:
        gt_trans = np.diff(np.asarray(gt_has_wave)).astype(int)
        pred_trans = np.diff(np.asarray(pred_has_wave)).astype(int)

        if not np.any(gt_trans):
            score = 1.0 if not np.any(pred_trans) else 0.0
            self.transition_scores.append(score)
            return score

        gt_idx = np.where(gt_trans)[0]
        pred_idx = np.where(pred_trans)[0]
        if len(pred_idx) != len(gt_idx):
            self.transition_scores.append(0.0)
            return 0.0

        timing_errors = np.abs(gt_idx - pred_idx)
        score = float(1.0 / (1.0 + np.mean(timing_errors)))
        self.transition_scores.append(score)
        return score

    def _evaluate_wave_sequence(self, pred_sequence, gt_sequence) -> float:
        stability_values = []
        motion_values = []
        for t in range(1, len(pred_sequence)):
            stability_values.append(
                calculate_stability(pred_sequence[t], pred_sequence[t - 1])
            )
            motion_values.append(
                calculate_motion(pred_sequence[t], pred_sequence[t - 1])
            )
        mean_stability = float(np.mean(stability_values)) if stability_values else 0.0
        mean_motion = float(np.mean(motion_values)) if motion_values else 0.0
        self.stability_scores.append(mean_stability)
        self.motion_scores.append(mean_motion)
        if not stability_values:
            return 0.0
        return float(
            np.mean([0.5 * s + 0.5 * m for s, m in zip(stability_values, motion_values)])
        )

    def _evaluate_no_wave_sequence(self, pred_has_wave) -> float:
        error_ratio = sum(pred_has_wave) / len(pred_has_wave)
        return 1.0 - error_ratio

    def _evaluate_wave_segments(
        self, pred_sequence, gt_sequence, pred_has_wave, gt_has_wave
    ) -> float:
        try:
            wave_scores = []
            for t in range(1, len(pred_sequence)):
                if gt_has_wave[t]:
                    pred_stability = calculate_stability(
                        pred_sequence[t], pred_sequence[t - 1]
                    )
                    match_score = calculate_stability(
                        pred_sequence[t], gt_sequence[t]
                    )
                    wave_scores.append(0.5 * pred_stability + 0.5 * match_score)
            segment_score = float(np.mean(wave_scores)) if wave_scores else 0.0
        except Exception:
            segment_score = 0.0  # safe_process (reference :74)
        self.wave_segment_scores.append(segment_score)
        return segment_score

    def _evaluate_mixed_sequence(
        self, pred_sequence, gt_sequence, pred_has_wave, gt_has_wave
    ) -> float:
        transition_accuracy = self._evaluate_transitions(gt_has_wave, pred_has_wave)
        wave_segments = self._evaluate_wave_segments(
            pred_sequence, gt_sequence, pred_has_wave, gt_has_wave
        )
        return 0.6 * transition_accuracy + 0.4 * wave_segments

    def _calculate_sequence_temporal_consistency(
        self, pred_sequence, gt_sequence
    ) -> float:
        try:
            gt_has_wave = [
                check_wave_presence(f, self.threshold) for f in gt_sequence
            ]
            pred_has_wave = [
                check_wave_presence(f, self.threshold) for f in pred_sequence
            ]
            if not any(gt_has_wave):
                return self._evaluate_no_wave_sequence(pred_has_wave)
            if all(gt_has_wave):
                return self._evaluate_wave_sequence(pred_sequence, gt_sequence)
            return self._evaluate_mixed_sequence(
                pred_sequence, gt_sequence, pred_has_wave, gt_has_wave
            )
        except Exception:
            return 0.0  # safe_process (reference :109)

    # ------------------------------------------------------------ streaming
    def update(self, pred, gt) -> Optional[float]:
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        if pred.ndim > 2:
            pred = preprocess_mask(pred)
        if gt.ndim > 2:
            gt = preprocess_mask(gt)

        self.sequence_predictions.append(pred)
        self.sequence_groundtruth.append(gt)

        score = None
        if len(self.sequence_predictions) == self.sequence_length:
            score = self._calculate_sequence_temporal_consistency(
                self.sequence_predictions, self.sequence_groundtruth
            )
            self.temporal_scores.append(score)
            self.sequence_predictions = self.sequence_predictions[1:]
            self.sequence_groundtruth = self.sequence_groundtruth[1:]
        return score

    def get_latest_score(self) -> float:
        return self.temporal_scores[-1] if self.temporal_scores else 0.0

    def get_mean_score(self) -> float:
        if not self.temporal_scores:
            return 0.0
        return float(np.mean(self.temporal_scores))

    def get_detailed_statistics(self) -> dict:
        def m(xs):
            return float(np.mean(xs)) if xs else 0.0

        return {
            "mean_score": self.get_mean_score(),
            "mean_transition": m(self.transition_scores),
            "mean_stability": m(self.stability_scores),
            "mean_motion": m(self.motion_scores),
            "mean_wave_segment": m(self.wave_segment_scores),
            "score_count": len(self.temporal_scores),
        }

    def reset(self) -> None:
        self.sequence_predictions = []
        self.sequence_groundtruth = []
        self.temporal_scores = []
        self.transition_scores = []
        self.stability_scores = []
        self.motion_scores = []
        self.wave_segment_scores = []
