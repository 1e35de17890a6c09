"""Datasets, a numpy copy of ``iswm_tpu/data/datasets.py`` (the JAX
package's ``data`` package imports jax): ``BinarySegmentation`` over an
``imgs/`` + ``masks/`` tree, its ``EvaluationDataset`` variant, an
in-memory ``ArrayDataset`` with the same interface, and ``batch_iterator``.

A dataset exposes ``images`` (file names, whose sort order is time order),
``__len__`` and ``__getitem__`` -> (uint8 [H, W, 3] image, uint8 [H, W]
mask in {0, 1}).  ``PIL`` is imported only to decode files.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def decode_target(mask: np.ndarray) -> np.ndarray:
    """{1 -> white, 0 -> black} RGB decode."""
    mask = np.asarray(mask)
    rgb = np.zeros((*mask.shape, 3), dtype=np.uint8)
    rgb[mask == 1] = (255, 255, 255)
    return rgb


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_mask(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        m = np.asarray(im.convert("L"), dtype=np.uint8)
    return (m > 0).astype(np.uint8)  # binarize


class BinarySegmentation:
    """Binary ISW segmentation dataset over an imgs/ + masks/ tree; a
    missing mask reads as all background."""

    decode_target = staticmethod(decode_target)

    def __init__(self, root: str, split: str = "train", cache: bool = False):
        self.root = root
        self.split = split
        self.cache = cache  # keep decoded arrays in RAM
        self._cache: dict = {}
        base = Path(root) if split in ("", ".") else Path(root) / split
        if not (base / "imgs").is_dir():
            if not (Path(root) / "imgs").is_dir():
                raise FileNotFoundError(f"no imgs/ directory under {base} or {root}")
            base = Path(root)  # a flat root without splits
        self.img_dir = base / "imgs"
        self.mask_dir = base / "masks"
        self.images: List[str] = sorted(
            f for f in os.listdir(self.img_dir) if f.lower().endswith(IMG_EXTENSIONS)
        )
        if not self.images:
            raise FileNotFoundError(f"no images found in {self.img_dir}")

    def __len__(self) -> int:
        return len(self.images)

    def _mask_path(self, img_name: str) -> Optional[Path]:
        stem, ext = os.path.splitext(img_name)
        for cand_ext in (ext,) + tuple(e for e in IMG_EXTENSIONS if e != ext):
            p = self.mask_dir / f"{stem}_mask{cand_ext}"
            if p.exists():
                return p
        return None

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        name = self.images[idx]
        image = _load_image(str(self.img_dir / name))
        mask_path = self._mask_path(name)
        label = (np.zeros(image.shape[:2], dtype=np.uint8) if mask_path is None
                 else _load_mask(str(mask_path)))
        if self.cache:
            self._cache[idx] = (image, label)
        return image, label


class EvaluationDataset(BinarySegmentation):
    """Eval-only variant returning (image, mask, name, raw image) 4-tuples
    (reference evaluate_quantization.py:34-79), read anew at every access.
    The port's datasets apply no transform, so the first and the last
    entry are the same array."""

    def __getitem__(self, idx: int):  # type: ignore[override]
        name = self.images[idx]
        image = _load_image(str(self.img_dir / name))
        mask_path = self._mask_path(name)
        label = (np.zeros(image.shape[:2], dtype=np.uint8) if mask_path is None
                 else _load_mask(str(mask_path)))
        return image, label, name, image


class ArrayDataset:
    """In-memory dataset with ``BinarySegmentation``'s interface: uint8
    images [N, H, W, 3], uint8 masks [N, H, W] and their ``names`` (default
    ``{i:06d}.png``, so that name order is index order)."""

    decode_target = staticmethod(decode_target)

    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 names: Optional[Sequence[str]] = None):
        if len(images) != len(masks):
            raise ValueError(f"{len(images)} images but {len(masks)} masks")
        self._images = np.asarray(images, dtype=np.uint8)
        self._masks = np.asarray(masks, dtype=np.uint8)
        self.images: List[str] = (list(names) if names is not None
                                  else [f"{i:06d}.png" for i in range(len(images))])

    def __len__(self) -> int:
        return len(self._images)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._images[idx], self._masks[idx]


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    epochs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host batch assembly: stacked (uint8 images [B, H, W, 3], int32 labels
    [B, H, W]), shuffled per epoch from ``seed``; ``epochs=None`` repeats
    forever.  Images within a batch must share one size."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                continue
            imgs, lbls = zip(*(dataset[int(i)] for i in idxs))
            yield np.stack(imgs), np.stack(lbls).astype(np.int32)
        epoch += 1
