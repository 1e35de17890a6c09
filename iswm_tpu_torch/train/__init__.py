"""Training, the counterpart of ``iswm_tpu/train``: optimizer and schedule,
train/eval steps, best-score gate, logging, ``.pth`` checkpoints and the
``Trainer``."""

from .best_score import initialize_best_score, is_best_score, update_best_score
from .checkpoint import best_checkpoint_name, find_best, restore, save_best
from .logging import MetricsLogger, try_setup_mlflow
from .optim import make_optimizer, make_schedule
from .step import TrainState, make_eval_step, make_train_step
from .trainer import Trainer, refuse_unported, save_validation_results

__all__ = [
    "MetricsLogger",
    "TrainState",
    "Trainer",
    "best_checkpoint_name",
    "find_best",
    "initialize_best_score",
    "is_best_score",
    "make_eval_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "refuse_unported",
    "restore",
    "save_best",
    "save_validation_results",
    "try_setup_mlflow",
    "update_best_score",
]
