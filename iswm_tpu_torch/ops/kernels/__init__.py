"""The hand-written CUDA kernels, their wrappers and their plain versions.

The kernels that serving reaches are operators of the dispatcher, in the
namespace ``iswm`` (``torch.ops.iswm``): #1 ``int8_matmul`` and
``int8_matmul_prequant`` (``int8_matmul.py``), ``quantize_s8``,
``conv_s8_igemm`` and ``conv_s8_direct`` (``int8_conv.py``) and #10
``stem_norm_relu_pool`` (``fused_stem.py``).  Each has three
implementations: ``CUDA``, the hand kernel, with its checks and launch
counter (it launches or raises); ``CPU``, its plain version; and a fake, the
output's shape, dtype and strides as the device's implementation gives them,
which is all that a ``torch.export`` trace runs.  So a serving fn exports
with each kernel as one node of its graph, and the artifact, loaded back,
launches the kernels (``infer/engine.py``).  Importing this package
registers them; it builds nothing (a library is built at its first CUDA
call, into ``build/kernels/``).

The other wrappers, all of them training's (``fused_ce``, ``confusion``,
``fused_block``, the stem's statistics and backward, the int8 backward),
launch through ctypes outside the dispatcher: :func:`ctypes_entry` marks
them, and ``infer/engine.serialize`` refuses a fn that reaches one
(:func:`refusing_ctypes_entries`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

LIBRARY = torch.library.Library("iswm", "DEF")
_reached: list | None = None  # within refusing_ctypes_entries: the entries reached


class ReachedCtypesEntry(Exception):
    """A ctypes entry was called within :func:`refusing_ctypes_entries`."""


def op(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define ``iswm::<schema>`` with its CPU, CUDA and fake implementations;
    returns its overload, which the wrapper calls."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"iswm::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.iswm, name).default


def ctypes_entry(fn: Callable) -> Callable:
    """Mark ``fn`` as a wrapper that launches its kernel through ctypes, out
    of the dispatcher's sight (``torch.export`` cannot trace it): within
    :func:`refusing_ctypes_entries` a call raises ``ReachedCtypesEntry``
    before its body runs."""
    name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _reached is not None:
            _reached.append(name)
            raise ReachedCtypesEntry(name)
        return fn(*args, **kwargs)
    return entry


@contextlib.contextmanager
def refusing_ctypes_entries():
    """Within: every call of a :func:`ctypes_entry` raises before its body
    runs (no plain version, no launch, no counter) and is appended, as
    "module.function", to the list this yields."""
    global _reached
    previous, _reached = _reached, []
    try:
        yield _reached
    finally:
        _reached = previous


from . import fused_stem, int8_conv, int8_matmul  # noqa: E402  (they register their ops)

__all__ = ["LIBRARY", "ReachedCtypesEntry", "ctypes_entry", "fused_stem", "int8_conv",
           "int8_matmul", "op", "refusing_ctypes_entries"]
