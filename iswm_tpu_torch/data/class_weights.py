"""Class weights ("IW" inverse weights), the counterpart of
``iswm_tpu/data/class_weights.py``: one pass over the training labels
counting {0, 1} pixels, weights ``[1, sqrt(n0 / n1)]`` (``[1, 1]`` when no
pixel is foreground).  Label batches may be numpy arrays or tensors; a
tensor is counted on its own device."""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def calculate_class_weights(label_batches: Iterable) -> np.ndarray:
    """[w_background = 1.0, w_foreground = sqrt(background / foreground)]."""
    counts = np.zeros(2, dtype=np.int64)
    for labels in label_batches:
        labels = torch.as_tensor(labels)
        counts += np.array([int((labels == 0).sum()), int((labels == 1).sum())])
    black, white = int(counts[0]), int(counts[1])
    if white == 0:
        return np.array([1.0, 1.0], dtype=np.float32)
    return np.array([1.0, float(np.sqrt(black / white))], dtype=np.float32)
