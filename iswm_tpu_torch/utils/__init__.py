"""Utilities of the port (``iswm_tpu/utils``): the panel visualizer and the
small helpers of ``misc``."""

from .misc import Denormalize, denormalize, mkdir, safe_process, timing_debug
from .visualizer import Visualizer

__all__ = [
    "Denormalize",
    "Visualizer",
    "denormalize",
    "mkdir",
    "safe_process",
    "timing_debug",
]
