"""Training observability: metric history, JSONL log, plots, MLflow bridge.
A copy of ``iswm_tpu/train/logging.py`` (the JAX package's ``train``
package imports jax); plots are drawn only where matplotlib imports.

Replaces the reference's MetricsLogger + MLflow wiring (reference
train.py:52-84, 93-269): the same metric series and names
(train_loss / lr / epoch / val_* / weighted_score), logged to a JSONL file
always, to MLflow when available and enabled, and rendered to the same
matplotlib artifacts (training_loss.png, validation_metrics.png,
learning_rate.png, confusion-matrix heatmaps).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Mapping

import numpy as np

from ..metrics.stream import weighted_score as _weighted_score

_VAL_SERIES = (
    "val_miou",
    "val_foreground_iou",
    "val_foreground_f1",
    "val_temporal_consistency",
    "val_front_tracking_error",
    "val_region_continuity",
    "val_precision",
    "val_recall",
)


def try_setup_mlflow(experiment_name: str, enabled: bool):
    """MLflow experiment setup (reference train.py:52-84); tracking URI from
    MLFLOW_TRACKING_URI env with file:./mlruns default.  Returns the mlflow
    module or None."""
    if not enabled:
        return None
    try:
        import mlflow

        mlflow.set_tracking_uri(
            os.environ.get("MLFLOW_TRACKING_URI", "file:./mlruns")
        )
        mlflow.set_experiment(experiment_name)
        return mlflow
    except Exception as e:  # pragma: no cover
        print(f"MLflow unavailable ({e}); falling back to JSONL only")
        return None


class MetricsLogger:
    """In-memory series + JSONL sink + plot rendering."""

    def __init__(self, log_dir: str = "logs", mlflow_module=None):
        self.history: Dict[str, list] = defaultdict(list)
        self.log_dir = log_dir
        self.mlflow = mlflow_module
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def update(self, name: str, value) -> None:
        self.history[name].append(float(value))

    def log_step(self, step: int, metrics: Mapping[str, float]) -> None:
        for k, v in metrics.items():
            self.update(k, v)
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.mlflow is not None:
            try:
                self.mlflow.log_metrics(
                    {k: float(v) for k, v in metrics.items()}, step=int(step)
                )
            except Exception:
                pass

    def log_validation(self, step: int, val_score: Mapping[str, float], weights=None):
        """Log the 8 val series + weighted score with the reference's names
        (train.py:1090-1101)."""
        metrics = {
            "val_miou": val_score["MIoU"],
            "val_foreground_iou": val_score["Foreground IoU"],
            "val_foreground_f1": val_score["Foreground F1"],
            "val_temporal_consistency": val_score.get("Temporal Consistency", 0.0),
            "val_front_tracking_error": val_score.get("Front Tracking Error", 0.0),
            "val_region_continuity": val_score.get("Region Continuity", 0.0),
            "val_precision": val_score["Precision"],
            "val_recall": val_score["Recall"],
            "weighted_score": _weighted_score(val_score, weights),
        }
        self.log_step(step, metrics)
        return metrics["weighted_score"]

    def get_weighted_score(self) -> float:
        """Weighted score from the latest logged val series — the reference's
        MetricsLogger.get_weighted_score (train.py:128-167), delegating to
        the single canonical formula."""
        h = self.history
        if not h.get("val_miou"):
            return 0.0
        results = {
            "MIoU": h["val_miou"][-1],
            "Foreground IoU": h["val_foreground_iou"][-1],
            "Foreground F1": h["val_foreground_f1"][-1],
            "Temporal Consistency": h["val_temporal_consistency"][-1],
            "Front Tracking Error": h["val_front_tracking_error"][-1],
            "Region Continuity": h["val_region_continuity"][-1],
        }
        return _weighted_score(results)

    # ------------------------------------------------------------- plots
    def save_plots(self, plots_dir: str) -> None:
        """training_loss.png / validation_metrics.png / learning_rate.png
        (reference train.py:169-269)."""
        os.makedirs(plots_dir, exist_ok=True)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # pragma: no cover
            return

        if self.history.get("train_loss"):
            fig, ax = plt.subplots(figsize=(8, 5))
            ax.plot(self.history["train_loss"])
            ax.set_xlabel("log step")
            ax.set_ylabel("loss")
            ax.set_title("Training loss")
            fig.savefig(os.path.join(plots_dir, "training_loss.png"), dpi=100)
            plt.close(fig)

        if self.history.get("val_miou"):
            fig, ax = plt.subplots(figsize=(10, 6))
            for name in _VAL_SERIES + ("weighted_score",):
                if self.history.get(name):
                    ax.plot(self.history[name], label=name)
            ax.legend(fontsize=7)
            ax.set_title("Validation metrics")
            fig.savefig(os.path.join(plots_dir, "validation_metrics.png"), dpi=100)
            plt.close(fig)

        if self.history.get("lr"):
            fig, ax = plt.subplots(figsize=(8, 5))
            ax.plot(self.history["lr"])
            ax.set_title("Learning rate")
            fig.savefig(os.path.join(plots_dir, "learning_rate.png"), dpi=100)
            plt.close(fig)

    def save_confusion_matrix(self, cm: np.ndarray, plots_dir: str, step: int) -> None:
        """Per-validation CM heatmap (reference train.py:236-269, seaborn
        replaced by plain matplotlib)."""
        os.makedirs(plots_dir, exist_ok=True)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # pragma: no cover
            return
        fig, ax = plt.subplots(figsize=(5, 4))
        im = ax.imshow(cm, cmap="Blues")
        for (i, j), v in np.ndenumerate(cm):
            ax.text(j, i, f"{v:.0f}", ha="center", va="center", fontsize=9)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        ax.set_title(f"Confusion matrix @ iter {step}")
        fig.colorbar(im)
        fig.savefig(
            os.path.join(plots_dir, f"confusion_matrix_iter_{step}.png"), dpi=100
        )
        plt.close(fig)

    def close(self) -> None:
        self._jsonl.close()
