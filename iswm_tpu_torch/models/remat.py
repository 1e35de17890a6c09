"""Activation rematerialization by block, the counterpart of the JAX package's
``remat`` (``iswm_tpu/train/step.py``, ``jax.checkpoint`` around the forward).

Under :func:`rematerialized` (the train step with ``remat=True``) every
:func:`segment` of a train-mode forward runs through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the segment keeps
its input and drops what it would save for the backward, which recomputes
the segment's forward at its first use.  The JAX package wraps the whole
forward in one region whose policy saves no conv output; a non-reentrant
region is recomputed whole at its first use, so one region would bring every
activation back at once.  Here the models mark their blocks instead (the
stem, each residual block or inverted residual, each Xception block, the
head's ASPP and decoder), so that one block's activations are live at a time.
The arithmetic is the same, op for op.

A recomputed forward runs again what the first forward did, so the state a
train forward updates in place must change once: the BatchNorm running
statistics (the plain, cross-replica, fused-stem and fused-block paths) and a
delayed-mode QAT site's running amax skip their update while
:func:`recomputing`, and such a site quantizes with the amax the first
forward read (:func:`first_read`).  Dropout draws the same mask
(``preserve_rng_state``).  Collectives in a segment (the cross-replica
BatchNorm's and QAT's amax all-reduces) run again in the backward, in the
same order on every rank.

A segment of a forward under ``parallel/spatial.py``'s ``spatially_split``
is recomputed under the same split (the backward runs after the split's
context has closed): its halo exchanges and group sums run again, counted
in ``spatial.recomputed`` too; the operators' global heights, cached at the
first forward, take no exchange.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial

# module-wide, not thread-local: the autograd engine recomputes a CUDA
# segment on its own thread while the caller waits in backward()
_active = False  # inside rematerialized()
_phase = None  # None, "forward" (a segment's first forward) or "recompute"


@contextlib.contextmanager
def rematerialized(on: bool = True):
    """Within: the :func:`segment` calls of a forward with gradients are
    checkpointed (``on`` False: a no-op)."""
    global _active
    previous, _active = _active, _active or on
    try:
        yield
    finally:
        _active = previous


@contextlib.contextmanager
def _in_phase(phase: str):
    global _phase
    previous, _phase = _phase, phase
    try:
        yield
    finally:
        _phase = previous


@contextlib.contextmanager
def _recomputing(split):
    with _in_phase("recompute"), spatial.restored(split, recompute=True):
        yield


def _contexts(split):
    """The contexts of a segment's first forward and of its recomputation,
    which runs under ``split``, the first forward's."""
    return _in_phase("forward"), _recomputing(split)


def recomputing() -> bool:
    """Whether the forward running now is a segment's recomputation."""
    return _phase == "recompute"


def segment(fn: Callable, *args):
    """``fn(*args)``, checkpointed where :func:`rematerialized` is on and
    gradients are recorded."""
    if not (_active and torch.is_grad_enabled()):
        return fn(*args)
    split = spatial.current()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=True,
                      context_fn=lambda: _contexts(split))


def first_read(stash: dict, key: str, value: torch.Tensor) -> torch.Tensor:
    """The value of a piece of state as the first forward read it: in a
    segment's first forward ``value`` is copied into ``stash[key]`` (the
    caller updates it in place afterwards), and the recomputation reads that
    copy back; outside a segment it is ``value`` itself."""
    if _phase == "forward":
        stash[key] = value.detach().clone()
    elif _phase == "recompute":
        return stash[key]
    return value
