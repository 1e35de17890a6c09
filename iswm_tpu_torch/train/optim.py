"""Optimizers and per-iteration LR schedules, the counterpart of
``iswm_tpu/train/optim.py`` (optax there, ``torch.optim`` here):

  - sgd: momentum 0.9, nesterov, coupled weight decay (torch adds
    ``wd * p`` to the gradient, as ``optax.add_decayed_weights`` before
    ``optax.sgd`` does); the momentum buffer is optax's ``trace``;
  - adam: coupled weight decay likewise; adamw: decoupled;
  - cosine: the closed form of ``optax.cosine_decay_schedule(alpha=
    cosine_min_factor)``, ``lr * ((1 - a) * 0.5 * (1 + cos(pi * t / T)) + a)``
    with ``t`` clamped to ``T``, as a ``LambdaLR`` (not the recursive
    ``CosineAnnealingLR``);
  - poly: ``max(lr * clip(1 - t / T, 0, 1) ** power, poly_min_lr)``.
Both schedules are stepped once per iteration.  Every optimizer state (SGD's
momentum, Adam's moments) is kept in its parameter's dtype, as optax keeps
it: bfloat16 under ``param_dtype="bfloat16"``, as the gradients are.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from ..config import OptimConfig


def make_schedule(cfg: OptimConfig, total_itrs: int) -> Callable[[int], float]:
    """step -> learning rate."""
    if cfg.schedule == "cosine":
        alpha = cfg.cosine_min_factor

        def cosine(step: int) -> float:
            t = min(step, total_itrs)
            decay = 0.5 * (1.0 + math.cos(math.pi * t / total_itrs))
            return cfg.lr * ((1.0 - alpha) * decay + alpha)

        return cosine
    if cfg.schedule == "poly":

        def poly(step: int) -> float:
            frac = min(max(1.0 - step / total_itrs, 0.0), 1.0)
            return max(cfg.lr * frac ** cfg.poly_power, cfg.poly_min_lr)

        return poly
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def make_optimizer(
    cfg: OptimConfig, total_itrs: int
) -> Tuple[Callable[[Iterable[torch.nn.Parameter]], tuple], Callable[[int], float]]:
    """Returns ``(factory, schedule)``: ``factory(params) -> (optimizer,
    scheduler)``, the scheduler a ``LambdaLR`` following ``schedule``;
    ``schedule(step) -> lr`` for logging."""
    schedule = make_schedule(cfg, total_itrs)

    def factory(params):
        if cfg.optimizer == "sgd":
            opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                  nesterov=cfg.nesterov, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adam":
            opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: schedule(step) / cfg.lr)
        return opt, scheduler

    return factory, schedule
