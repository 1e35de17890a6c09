"""Synthetic Himawari-like fixture generator: a numpy copy of
``iswm_tpu/data/synthetic.py`` (the JAX package's ``data`` package imports
jax).  Visible-band ocean scenes with thin, curved, roughly vertical
internal-wave stripe packets; binary masks {0 background, 1 wave}.
``PIL`` is imported only to write PNGs.

Images are written as ``{split}/imgs/{name}.png`` +
``{split}/masks/{name}_mask.png``; file names embed a fake timestamp so
that name order is time order (validation sorts by name).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def generate_scene(
    rng: np.random.Generator,
    size: Tuple[int, int] = (200, 200),
    wave_probability: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image uint8 [H,W,3], mask uint8 [H,W]) pair."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    # Ocean background: smooth luminance gradient + low-freq cloud blobs + noise
    base = 90 + 40 * (xx / w) + 25 * np.sin(2 * np.pi * yy / h * rng.uniform(0.5, 2))
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(h / 6, h / 2)
        base += rng.uniform(10, 45) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
    noise = rng.normal(0, 6, (h, w)).astype(np.float32)

    mask = np.zeros((h, w), dtype=np.uint8)
    img = base + noise

    if rng.random() < wave_probability:
        # A packet of curved near-vertical stripes (solitons) entering from a
        # random x position, each a sinusoid in y with decreasing amplitude.
        n_stripes = int(rng.integers(2, 6))
        x0 = rng.uniform(0.2 * w, 0.8 * w)
        amp = rng.uniform(0.05, 0.15) * w
        freq = rng.uniform(0.5, 1.5)
        phase = rng.uniform(0, 2 * np.pi)
        spacing = rng.uniform(4, 10)
        thickness = rng.uniform(1.2, 3.0)
        for s in range(n_stripes):
            cx_of_y = x0 + s * spacing + amp * np.sin(
                2 * np.pi * freq * yy[:, 0] / h + phase + 0.3 * s
            )
            dist = np.abs(xx - cx_of_y[:, None])
            stripe = dist < (thickness * (1.0 - 0.12 * s))
            brightness = rng.uniform(35, 70) * (1.0 - 0.15 * s)
            img = np.where(stripe, img + brightness, img)
            mask |= stripe.astype(np.uint8)
        # restrict wave to a band of rows (waves don't span the whole scene)
        r0 = int(rng.uniform(0, 0.3) * h)
        r1 = int(rng.uniform(0.7, 1.0) * h)
        band = np.zeros((h, 1), dtype=bool)
        band[r0:r1] = True
        mask = (mask & band).astype(np.uint8)

    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1), mask


def generate_sequence(
    rng: np.random.Generator,
    length: int = 7,
    size: Tuple[int, int] = (200, 200),
    wave_probability: float = 0.8,
):
    """A time-evolving scene sequence: the wave packet propagates smoothly
    across frames (constant drift + phase advance), so the 7-frame temporal
    metrics (stability/motion/transitions) see realistic dynamics instead
    of independent scenes.  Yields ``length`` (image, mask) pairs."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    base = 90 + 40 * (xx / w) + 25 * np.sin(2 * np.pi * yy / h * rng.uniform(0.5, 2))
    has_wave = rng.random() < wave_probability
    n_stripes = int(rng.integers(2, 5))
    x0 = rng.uniform(0.25 * w, 0.6 * w)
    amp = rng.uniform(0.05, 0.12) * w
    freq = rng.uniform(0.5, 1.5)
    phase = rng.uniform(0, 2 * np.pi)
    spacing = rng.uniform(5, 9)
    thickness = rng.uniform(1.5, 3.0)
    drift = rng.uniform(1.0, 4.0)  # px/frame eastward propagation
    r0 = int(rng.uniform(0, 0.25) * h)
    r1 = int(rng.uniform(0.75, 1.0) * h)

    out = []
    for t in range(length):
        img = base + rng.normal(0, 6, (h, w)).astype(np.float32)
        mask = np.zeros((h, w), dtype=np.uint8)
        if has_wave:
            for s in range(n_stripes):
                cx_of_y = (
                    x0
                    + drift * t
                    + s * spacing
                    + amp * np.sin(2 * np.pi * freq * yy[:, 0] / h + phase + 0.3 * s)
                )
                dist = np.abs(xx - cx_of_y[:, None])
                stripe = dist < (thickness * (1.0 - 0.1 * s))
                img = np.where(stripe, img + rng.uniform(35, 65) * (1 - 0.15 * s), img)
                mask |= stripe.astype(np.uint8)
            band = np.zeros((h, 1), dtype=bool)
            band[r0:r1] = True
            mask = (mask & band).astype(np.uint8)
        out.append((np.stack([np.clip(img, 0, 255).astype(np.uint8)] * 3, -1), mask))
    return out


def write_sequence_dataset(
    root: str,
    n_sequences: int = 8,
    length: int = 7,
    size: Tuple[int, int] = (200, 200),
    seed: int = 0,
    split: str = "val",
) -> str:
    """Materialize temporally-coherent sequences; filenames sort in time
    order within and across sequences (validation's sliding
    window then sees smooth motion)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = Path(root) / split / "imgs"
    mask_dir = Path(root) / split / "masks"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)
    for s in range(n_sequences):
        frames = generate_sequence(rng, length=length, size=size)
        for t, (img, mask) in enumerate(frames):
            name = f"H09_{20250101 + s:08d}_{t * 10:04d}"
            Image.fromarray(img).save(img_dir / f"{name}.png")
            Image.fromarray(mask * 255).save(mask_dir / f"{name}_mask.png")
    return root


def write_dataset(
    root: str,
    n_train: int = 64,
    n_val: int = 16,
    size: Tuple[int, int] = (200, 200),
    seed: int = 0,
) -> str:
    """Materialize a synthetic dataset tree under ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = Path(root) / split / "imgs"
        mask_dir = Path(root) / split / "masks"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = generate_scene(rng, size=size)
            name = f"H09_{20250101 + i // 96:08d}_{(i % 96) * 15:04d}"
            Image.fromarray(img).save(img_dir / f"{name}.png")
            Image.fromarray(mask * 255).save(mask_dir / f"{name}_mask.png")
    return root
