"""ctypes bridge to the native metrics runtime (runtime/iswm_runtime.cpp).

The validation metrics path is host-side and per-frame (SURVEY §3.3); the
native library implements the O(H*W) primitives (3x3 binary morphology,
8-connected two-pass labeling, per-row front extraction) in C++.  All
callers fall back to scipy/numpy when the library is not built, and the
test suite asserts native == fallback on random masks.

Build: ``python setup.py build_runtime`` or ``make -C runtime`` (produces
``runtime/libiswm_runtime.so``).  Set ``ISWM_NO_NATIVE=1`` to disable.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _find_library() -> Optional[str]:
    if os.environ.get("ISWM_NO_NATIVE"):
        return None
    root = Path(__file__).resolve().parents[2]
    for cand in (
        root / "runtime" / "libiswm_runtime.so",
        Path(__file__).parent / "libiswm_runtime.so",
    ):
        if cand.exists():
            return str(cand)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _find_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.iswm_dilate3x3.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.iswm_erode3x3.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.iswm_label8.argtypes = [u8p, i32p, ctypes.c_int, ctypes.c_int]
        lib.iswm_label8.restype = ctypes.c_int
        lib.iswm_front_positions.argtypes = [u8p, i32p, ctypes.c_int, ctypes.c_int]
        lib.iswm_front_positions.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def dilate(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    dst = np.empty_like(src)
    lib.iswm_dilate3x3(src, dst, src.shape[0], src.shape[1], iterations)
    return dst.astype(bool)


def erode(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    dst = np.empty_like(src)
    lib.iswm_erode3x3(src, dst, src.shape[0], src.shape[1], iterations)
    return dst.astype(bool)


def label(mask: np.ndarray):
    """8-connected labeling -> (labels int32, num_features)."""
    lib = _load()
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    labels = np.zeros(src.shape, dtype=np.int32)
    n = lib.iswm_label8(src, labels, src.shape[0], src.shape[1])
    return labels, int(n)


def front_positions(mask: np.ndarray) -> np.ndarray:
    """Per-row leftmost foreground pixel -> (K, 2) array of (row, col)."""
    lib = _load()
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty((src.shape[0], 2), dtype=np.int32)
    k = lib.iswm_front_positions(src, out, src.shape[0], src.shape[1])
    return out[:k]
