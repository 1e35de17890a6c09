"""Utilities of the port (``iswm_tpu/utils``): the panel visualizer."""

from .visualizer import Visualizer

__all__ = ["Visualizer"]
