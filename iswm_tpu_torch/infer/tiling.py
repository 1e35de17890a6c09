"""Batched sliding-window whole-scene inference (the tile engine), the
counterpart of ``iswm_tpu/infer/tiling.py`` ``TileEngine``.

A scene of any size is covered by overlapping fixed-size tiles (stride =
tile - overlap, the last row/column flush with the border); the tiles go
through the model in chunks of ``batch``; each tile's logits, weighted by a
separable ramp that downweights tile borders, are added into a canvas, and
the canvas is divided by the summed weights.  ``tile_origins`` and
``_blend_window`` are numpy copies of the JAX module's (it imports jax).

With a ``mesh`` (``parallel.make_mesh``) the engine is scene-parallel, as the
JAX engine over a mesh's data axis: ``batch`` is per rank, a chunk is
``batch * mesh.data`` tiles, each rank runs its data index's slice of every
chunk, and the chunk's logits are all-gathered over the default group (the
ranks of a model group run the same slice; the first of each gives it), so
that every rank blends the whole scene, as the JAX engine's replicated blend.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist


def tile_origins(size: int, tile: int, stride: int) -> np.ndarray:
    """1-D tile start offsets covering [0, size) with last tile flush."""
    if size <= tile:
        return np.array([0], dtype=np.int32)
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return np.asarray(starts, dtype=np.int32)


def _blend_window(tile: int, overlap: int) -> np.ndarray:
    """Separable border ramp: 1 in the interior, cosine-tapered over the
    overlap margin.  Guarantees strictly positive weights everywhere."""
    if overlap <= 0:
        return np.ones((tile, tile), dtype=np.float32)
    ramp = np.ones(tile, dtype=np.float32)
    m = min(overlap, tile // 2)
    t = (np.arange(m) + 0.5) / m
    taper = 0.5 - 0.5 * np.cos(np.pi * t)  # 0..1
    ramp[:m] = taper
    ramp[tile - m :] = taper[::-1]
    w = np.outer(ramp, ramp)
    return np.maximum(w, 1e-3).astype(np.float32)


def _reflect_indices(size: int, padded: int) -> np.ndarray:
    """Source indices of numpy's ``mode="reflect"`` padding of ``size``
    values up to ``padded``, for any pad width (``F.pad`` refuses a pad
    as large as the input; ``np.pad`` and ``jnp.pad`` reflect repeatedly)."""
    i = np.arange(padded)
    if size == 1:
        return np.zeros_like(i)
    period = 2 * (size - 1)
    j = i % period
    return np.where(j < size, j, period - j)


class TileEngine:
    """Whole-scene tiled inference over a per-batch model fn.

    ``model_fn(images[N,T,T,C]) -> logits[N,T,T,num_classes]`` takes
    normalized float input.  ``infer_scene`` takes a normalized [H,W,C]
    scene tensor and returns [H,W,num_classes] float32 logits on its device.
    With ``mesh``, every rank of the default group calls ``infer_scene`` on
    the same scene (see the module docstring).
    """

    def __init__(self, model_fn: Callable, tile: int = 512, overlap: int = 64,
                 batch: int = 8, num_classes: int = 2, mesh=None):
        if overlap >= tile:
            raise ValueError("overlap must be < tile")
        self.model_fn = model_fn
        self.tile = tile
        self.overlap = overlap
        self.batch = batch
        self.num_classes = num_classes
        self.mesh = mesh
        self.ranks = 1 if mesh is None else mesh.data
        self._window = torch.from_numpy(_blend_window(tile, overlap))
        # per (h, w, device): (origins, summed-weight canvas)
        self._plans: Dict[Tuple, Tuple[np.ndarray, torch.Tensor]] = {}

    def _plan(self, h: int, w: int, device: torch.device):
        key = (h, w, str(device))
        if key not in self._plans:
            stride = self.tile - self.overlap
            ys = tile_origins(h, self.tile, stride)
            xs = tile_origins(w, self.tile, stride)
            origins = np.stack([np.repeat(ys, len(xs)), np.tile(xs, len(ys))], axis=1)
            window = self._window.to(device)
            weights = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
            t = self.tile
            for oy, ox in origins:
                weights[oy : oy + t, ox : ox + t, 0] += window
            self._plans[key] = (origins, weights)
        return self._plans[key]

    def infer_scene(self, scene: torch.Tensor) -> torch.Tensor:
        """[H,W,C] normalized scene -> [H,W,num_classes] blended logits."""
        h, w = int(scene.shape[0]), int(scene.shape[1])
        t = self.tile
        if h < t or w < t:
            # Small scene: reflect-pad up to one tile, run, crop back.
            rows = torch.from_numpy(_reflect_indices(h, max(h, t))).to(scene.device)
            cols = torch.from_numpy(_reflect_indices(w, max(w, t))).to(scene.device)
            return self.infer_scene(scene[rows][:, cols])[:h, :w]
        origins, weights = self._plan(h, w, scene.device)
        window = self._window.to(scene.device)[..., None]
        n = len(origins)
        size = self.batch * self.ranks
        # the tile list is padded to a chunk multiple with the last origin;
        # only the first n tiles are accumulated
        padded = np.concatenate([origins, np.repeat(origins[-1:], (-n) % size, 0)])
        canvas = torch.zeros((h, w, self.num_classes), dtype=torch.float32,
                             device=scene.device)
        mine = slice(0, size) if self.mesh is None else slice(
            self.mesh.data_index * self.batch, (self.mesh.data_index + 1) * self.batch)
        for c0 in range(0, len(padded), size):
            chunk = padded[c0 : c0 + size]
            tiles = torch.stack([scene[oy : oy + t, ox : ox + t] for oy, ox in chunk[mine]])
            logits = self.model_fn(tiles).float()
            if self.mesh is not None:
                logits = self._gather(logits)
            for i in range(min(size, n - c0)):
                oy, ox = chunk[i]
                canvas[oy : oy + t, ox : ox + t] += logits[i] * window
        return canvas / weights

    def _gather(self, logits: torch.Tensor) -> torch.Tensor:
        """Every data index's slice of a chunk, in order, on every rank."""
        logits = logits.contiguous()
        parts = [torch.empty_like(logits) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, logits)
        return torch.cat(parts[::self.mesh.model])
