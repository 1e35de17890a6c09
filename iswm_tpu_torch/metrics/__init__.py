"""Host-side metrics engine: the port's own copy of ``iswm_tpu/metrics``
(numpy/scipy only, the same code, held equal by
``tests/test_torch_shared.py``).  ``StreamMetrics`` gives the reported
numbers; the reductions on tensors for quick evaluation are in
``.device``.
"""

from .base import MetricsBase
from .front_tracking import FrontTrackingMetrics
from .mask_utils import (
    calculate_motion,
    calculate_stability,
    check_wave_presence,
    find_front_positions,
    preprocess_mask,
)
from .region import RegionMetrics
from .stream import (
    DEFAULT_WEIGHTS,
    MAX_FTE,
    StreamMetrics,
    fast_hist,
    foreground_metrics,
    weighted_score,
)
from .temporal import TemporalMetrics

__all__ = [
    "DEFAULT_WEIGHTS",
    "FrontTrackingMetrics",
    "MAX_FTE",
    "MetricsBase",
    "RegionMetrics",
    "StreamMetrics",
    "TemporalMetrics",
    "calculate_motion",
    "calculate_stability",
    "check_wave_presence",
    "fast_hist",
    "find_front_positions",
    "foreground_metrics",
    "preprocess_mask",
    "weighted_score",
]
