"""Bilinear resize with torch-interpolate semantics (``align_corners=False``),
the counterpart of ``iswm_tpu/ops/resize.py`` ``resize_bilinear``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], owner=None) -> torch.Tensor:
    """Bilinearly resize NCHW ``x`` to spatial ``size`` (H, W).

    Under ``parallel/spatial.py``'s ``spatially_split`` ``x`` holds this
    rank's rows and ``size`` its share of the output rows: H is resized in
    the global image's coordinates on a halo (``spatial.resize_rows``), then
    W at an unchanged H, which maps each row to itself exactly.  ``owner``
    (the calling module) keys the two maps' global heights, which the first
    call exchanges (``spatial.extents``; None: every call)."""
    if x.ndim != 4:
        raise ValueError(f"expected 4D NCHW input, got {x.ndim}D")
    if spatial.current() is not None:
        x = spatial.resize_rows(x, size[0], owner)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
