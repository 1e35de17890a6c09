"""Visualizer: image/metric panel dumps.

Matplotlib-backed analogue of the reference's visdom ``Visualizer``
(reference utils/visualizer.py:4-74 — legacy, exported but unused by
train), the counterpart of ``iswm_tpu/utils/visualizer.py``.  Writes PNG
panels instead of pushing to a visdom server, which suits headless
machines; the MLflow/JSONL series in ``iswm_tpu_torch.train.logging`` are
the live-monitoring path.  matplotlib is imported at first use.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


class Visualizer:
    def __init__(self, out_dir: str = "vis"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _plt(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def vis_scalar(self, name: str, values: Sequence[float]) -> str:
        plt = self._plt()
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(values)
        ax.set_title(name)
        path = os.path.join(self.out_dir, f"{name.replace(' ', '_')}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def vis_image(self, name: str, image: np.ndarray) -> str:
        plt = self._plt()
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(np.asarray(image))
        ax.axis("off")
        ax.set_title(name)
        path = os.path.join(self.out_dir, f"{name.replace(' ', '_')}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path

    def vis_segmentation_panel(
        self,
        name: str,
        image: np.ndarray,
        gt: Optional[np.ndarray] = None,
        pred: Optional[np.ndarray] = None,
        confidence: Optional[np.ndarray] = None,
    ) -> str:
        """Side-by-side (image | gt | pred | confidence) panel, the
        counterpart of the reference's validation grids (train.py:461-523)."""
        plt = self._plt()
        panels = [("image", image, None)]
        if gt is not None:
            panels.append(("ground truth", gt, "gray"))
        if pred is not None:
            panels.append(("prediction", pred, "gray"))
        if confidence is not None:
            panels.append(("confidence", confidence, "viridis"))
        fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
        if len(panels) == 1:
            axes = [axes]
        for ax, (title, data, cmap) in zip(axes, panels):
            ax.imshow(np.asarray(data), cmap=cmap)
            ax.set_title(title)
            ax.axis("off")
        path = os.path.join(self.out_dir, f"{name.replace(' ', '_')}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
