"""Profiling and timing hooks, the counterpart of ``iswm_tpu/train/profiling.py``.

  - ``trace(logdir)``: a context manager around ``torch.profiler`` that
    writes a Chrome / TensorBoard-loadable trace of the enclosed block into
    ``logdir`` (CPU activity, and CUDA activity when a card is present);
  - ``StepTimer``: wall-clock per-step timing with warm-up exclusion and
    rolling throughput.  Where CUDA is initialized it synchronizes the
    device before reading the clock on both sides of a step, so that queued
    kernels are counted in the step that launched them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir`` (``trace_<pid>_<ns>.json``)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Per-step timing with warm-up exclusion (first ``skip`` steps)."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self._seen = 0
        self._total = 0.0
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip:
            self._total += dt
            self._count += 1
        return False

    @property
    def mean_seconds(self) -> float:
        return self._total / self._count if self._count else 0.0

    def throughput(self, items_per_step: int) -> float:
        s = self.mean_seconds
        return items_per_step / s if s else 0.0
