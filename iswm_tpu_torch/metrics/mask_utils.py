"""Mask preprocessing + front/motion/stability primitives.

Numpy-exact re-specification of the reference's MaskUtils (reference
metrics/utils/mask_utils.py:5-143), preserving its intentional quirks
because they feed the composite weighted score:

  - preprocess: binarize>0, morphological CLOSE then OPEN (3x3), keep only
    the largest connected region whose area >= 0.1% of pixels; when several
    regions pass the area gate the surviving largest region is *scaled* by
    max(0.4, 1 - 0.2*(n_valid-1)) — producing a float mask whose values are
    no longer ==1, which downstream `== 1` comparisons then treat as empty
    (mask_utils.py:41-42 feeding 117/128's ``== 1`` scans).  Quirk preserved.
  - fronts: per-row leftmost foreground pixel (mask_utils.py:68-73).
  - motion: mean-front displacement squashed by 1/(1+d/(0.1*H)) (77-101).
  - stability: per-row nearest-front agreement within a ±10%-width window
    (103-136).
  - presence: mean(mask) >= threshold on the *weighted* mask (138-143).

Inputs may be numpy arrays or array-likes of any numeric dtype; 3D inputs take the last
slice (mask_utils.py:11-12).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import _native
from ._morphology import connected_components, morph_close, morph_open

MIN_VALID_AREA_FRACTION = 0.001  # reference mask_utils.py:28
MULTI_REGION_WEIGHT_STEP = 0.2  # reference mask_utils.py:41
MULTI_REGION_WEIGHT_FLOOR = 0.4


def _to_numpy(mask) -> np.ndarray:
    arr = np.asarray(mask)
    return arr


def preprocess_mask(mask) -> np.ndarray:
    """Clean a predicted/GT mask; returns float or uint8 array (see module doc)."""
    mask = _to_numpy(mask)
    if mask.ndim == 3:
        mask = mask[-1]
    mask = (mask > 0).astype(np.uint8)

    cleaned = morph_open(morph_close(mask))
    num_labels, labels, areas = connected_components(cleaned)

    if num_labels > 1:  # at least one region beyond background
        min_valid_area = cleaned.size * MIN_VALID_AREA_FRACTION
        valid = areas >= min_valid_area
        valid_labels = np.where(valid)[0] + 1
        if len(valid_labels) > 0:
            largest_label = valid_labels[np.argmax(areas[valid_labels - 1])]
            base = (labels == largest_label).astype(np.uint8)
            if len(valid_labels) > 1:
                weight = max(
                    MULTI_REGION_WEIGHT_FLOOR,
                    1.0 - MULTI_REGION_WEIGHT_STEP * (len(valid_labels) - 1),
                )
                return base * weight  # float mask, values in {0, 0.4..0.8}
            return base
        return np.zeros_like(cleaned)
    return cleaned


def find_front_positions(mask) -> List[Tuple[int, int]]:
    """Per-row leftmost foreground point of the preprocessed mask.

    Note the reference scans for ``mask[i] == 1`` (mask_utils.py:70), so a
    multi-region *weighted* mask (values < 1) yields no front points.
    """
    mask = preprocess_mask(mask)
    if not np.any(mask):
        return []
    binary = mask == 1
    if not np.any(binary):
        return []  # weighted mask: no pixel equals exactly 1
    if _native.available():
        pts = _native.front_positions(binary)
        return [tuple(p) for p in pts]
    has_fg = binary.any(axis=1)
    first_col = binary.argmax(axis=1)
    return [(int(r), int(first_col[r])) for r in np.where(has_fg)[0]]


def calculate_motion(curr_pred, prev_pred) -> float:
    """Front-centroid displacement score (reference mask_utils.py:77-101)."""
    curr_fronts = find_front_positions(curr_pred)
    prev_fronts = find_front_positions(prev_pred)
    if not curr_fronts or not prev_fronts:
        return 0.0
    curr = np.asarray(curr_fronts, dtype=np.float64)
    prev = np.asarray(prev_fronts, dtype=np.float64)
    dy = curr[:, 0].mean() - prev[:, 0].mean()
    dx = curr[:, 1].mean() - prev[:, 1].mean()
    distance = float(np.hypot(dy, dx))
    # reference uses the raw input's shape[0] as "height" (mask_utils.py:98)
    max_reasonable = _to_numpy(curr_pred).shape[0] * 0.1
    return 1.0 / (1.0 + distance / max_reasonable)


def calculate_stability(curr_pred, prev_pred) -> float:
    """Per-row front agreement within a ±(0.1*W) window (reference 103-136)."""
    curr = preprocess_mask(curr_pred)
    prev = preprocess_mask(prev_pred)
    h, w = curr.shape
    window = int(w * 0.1)

    scores = []
    curr_bin = curr == 1
    prev_bin = prev == 1
    for i in range(h):
        cols = np.where(curr_bin[i])[0]
        if len(cols) == 0:
            continue
        front = int(cols[0])
        start = max(0, front - window)
        end = min(w, front + window)
        prev_cols = np.where(prev_bin[i, start:end])[0]
        if len(prev_cols) > 0:
            diff = abs(front - (int(prev_cols[0]) + start))
            scores.append(1.0 / (1.0 + diff / window))
    return float(np.mean(scores)) if scores else 0.0


def check_wave_presence(mask, threshold: float = 0.005) -> bool:
    """Foreground-fraction presence test on the weighted mask (138-143)."""
    mask = preprocess_mask(mask)
    ratio = float(np.sum(mask)) / mask.size
    return ratio >= threshold
