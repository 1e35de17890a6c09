"""Binary morphology + connected components with cv2-equivalent semantics.

The reference metrics lean on OpenCV (reference metrics/utils/mask_utils.py:18-23,
metrics/region_metrics.py:8-11); this module reproduces those exact semantics
on top of scipy.ndimage so the framework carries no cv2 dependency:

  - cv2.dilate pads the border with the identity for max (=0 for binary),
  - cv2.erode pads with the identity for min (=1 for binary),
  - cv2.morphologyEx CLOSE = dilate->erode, OPEN = erode->dilate,
  - cv2.connectedComponentsWithStats uses 8-connectivity.

A native C++ implementation (runtime/libiswm_runtime) is used when built —
the per-frame metrics path is the validation hot loop (SURVEY §3.3 note) —
with this scipy path as the always-available fallback and oracle.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from . import _native

_STRUCT8 = np.ones((3, 3), dtype=bool)


def dilate3x3(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """cv2.dilate(mask, ones(3,3), iterations) for binary uint8 masks."""
    m = mask.astype(bool)
    if _native.available():
        return _native.dilate(m, iterations).astype(mask.dtype)
    out = ndimage.binary_dilation(
        m, structure=_STRUCT8, iterations=iterations, border_value=0
    )
    return out.astype(mask.dtype)


def erode3x3(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """cv2.erode(mask, ones(3,3), iterations); border treated as foreground
    (cv2 pads erode with the min-identity)."""
    m = mask.astype(bool)
    if _native.available():
        return _native.erode(m, iterations).astype(mask.dtype)
    out = ndimage.binary_erosion(
        m, structure=_STRUCT8, iterations=iterations, border_value=1
    )
    return out.astype(mask.dtype)


def morph_close(mask: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(MORPH_CLOSE) with a 3x3 rect kernel."""
    return erode3x3(dilate3x3(mask))


def morph_open(mask: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(MORPH_OPEN) with a 3x3 rect kernel."""
    return dilate3x3(erode3x3(mask))


def connected_components(mask: np.ndarray):
    """8-connected labeling.

    Returns (num_labels, labels, areas) where ``num_labels`` counts the
    background as label 0 (cv2.connectedComponentsWithStats convention) and
    ``areas[i]`` is the pixel count of label i+1 (background excluded).
    """
    m = mask.astype(bool)
    if _native.available():
        labels, n = _native.label(m)
    else:
        labels, n = ndimage.label(m, structure=_STRUCT8)
    if n == 0:
        return 1, labels, np.zeros((0,), dtype=np.int64)
    areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    return n + 1, labels, areas


def repair_small_gaps(mask: np.ndarray) -> np.ndarray:
    """Gap repair: dilate x3 then erode x2 (reference region_metrics.py:6-11)."""
    return erode3x3(dilate3x3(mask, iterations=3), iterations=2)
