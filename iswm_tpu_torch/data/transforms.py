"""Transforms, the counterpart of ``iswm_tpu/data/transforms.py`` (the JAX
module imports jax, so the port keeps its own copy).

Training augmentation runs on the device, as in the JAX package: random
scale U(scale_min, scale_max) with integer-floored scaled dims, a random
crop (or a centred pad when the scaled image is smaller), a horizontal flip
folded into the column order, a separable bilinear resample of the image
(zero outside the source) and a nearest resample of the labels (fill 0),
then ImageNet normalization.  It is split in two:

  - ``draw_augment_params`` draws ``(scale, top, left, flip)`` per sample
    from an explicit ``torch.Generator`` (it cannot replay ``jax.random``);
  - ``augment_resample`` is deterministic given those four values and
    computes what ``augment_sample`` computes after its draws, in the same
    float32 operations, so it can be held against the JAX function.

Images are channels last, [B, H, W, C], as the JAX package keeps them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class AugmentConfig(NamedTuple):
    crop_size: int = 513
    scale_min: float = 0.5
    scale_max: float = 2.0
    hflip_prob: float = 0.5
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD


def normalize(
    image: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> torch.Tensor:
    """(x - mean) / std per channel, channels last, in float32."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=image.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) - mean_t) / std_t


def val_transform_batch(images: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize: uint8 [..., H, W, C] -> normalized float32."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    return normalize(images)


def _scaled_dims(h: int, w: int, scale: torch.Tensor):
    """Integer scaled dims, floor(h * s) in float32 as the JAX package."""
    return torch.floor(h * scale).to(torch.int32), torch.floor(w * scale).to(torch.int32)


def draw_augment_params(
    n: int, h: int, w: int, cfg: AugmentConfig, generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample ``(scale, top, left, flip)`` on the generator's device.

    scale ~ U(scale_min, scale_max); an offset is uniform over
    {0 .. scaled - crop} when the scaled side is at least the crop, else the
    centring offset (scaled - crop) // 2 (negative); flip with
    ``hflip_prob``.  ``top`` and ``left`` are float32, ``flip`` bool."""
    dev = generator.device
    u = torch.rand((4, n), generator=generator, device=dev)
    scale = cfg.scale_min + u[0] * (cfg.scale_max - cfg.scale_min)
    sh, sw = _scaled_dims(h, w, scale)

    def offset(v, scaled):
        span = scaled - cfg.crop_size
        big = torch.minimum(torch.floor(v * (span + 1).float()).to(torch.int32), span)
        small = torch.div(span, 2, rounding_mode="floor")
        return torch.where(span >= 0, big, small).to(torch.float32)

    return scale, offset(u[1], sh), offset(u[2], sw), u[3] < cfg.hflip_prob


def _separable_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Sample [B, H, W, C] at the outer grid of float coords ys [B, Th],
    xs [B, Tw]; taps outside the source contribute 0."""
    b, h, w, c = img.shape
    batch = torch.arange(b, device=img.device)[:, None]
    y0 = torch.floor(ys)
    wy = (ys - y0)[:, :, None, None]
    y0i = y0.long()

    def take_rows(idx):
        valid = ((idx >= 0) & (idx < h))[:, :, None, None]
        return img[batch, idx.clamp(0, h - 1)] * valid

    tmp = take_rows(y0i) * (1 - wy) + take_rows(y0i + 1) * wy  # [B, Th, W, C]
    x0 = torch.floor(xs)
    wx = (xs - x0)[:, None, :, None]
    x0i = x0.long()

    def take_cols(idx):
        valid = ((idx >= 0) & (idx < w))[:, None, :, None]
        index = idx.clamp(0, w - 1)[:, None, :, None].expand(b, tmp.shape[1], -1, c)
        return tmp.gather(2, index) * valid

    return take_cols(x0i) * (1 - wx) + take_cols(x0i + 1) * wx


def _separable_nearest(lbl: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, fill):
    """Nearest sample of [B, H, W] integer labels at the outer grid."""
    b, h, w = lbl.shape
    yi = torch.round(ys).long()
    xi = torch.round(xs).long()
    batch = torch.arange(b, device=lbl.device)[:, None]
    rows = lbl[batch, yi.clamp(0, h - 1)]  # [B, Th, W]
    out = rows.gather(2, xi.clamp(0, w - 1)[:, None, :].expand(b, rows.shape[1], -1))
    valid = ((yi >= 0) & (yi < h))[:, :, None] & ((xi >= 0) & (xi < w))[:, None, :]
    return torch.where(valid, out, torch.full_like(out, fill))


def augment_resample(
    images: torch.Tensor, labels: torch.Tensor, scale: torch.Tensor,
    top: torch.Tensor, left: torch.Tensor, flip: torch.Tensor, cfg: AugmentConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale + crop/pad + hflip + normalize, given the draws.

    images [B, H, W, C] float in [0, 1], labels [B, H, W] integer ->
    ([B, crop, crop, C] float32 normalized, [B, crop, crop] labels).  Each
    output pixel centre maps back to the source with the effective
    (floored) scale: src = (offset + o + 0.5) / (scaled / side) - 0.5."""
    _, h, w, _ = images.shape
    sh, sw = _scaled_dims(h, w, scale)

    def recip(side):  # XLA turns ``scaled / side`` into ``scaled * (1 / side)``
        return torch.tensor(1.0 / side, dtype=torch.float32, device=images.device)

    eff_sy = (sh.to(torch.float32) * recip(h))[:, None]
    eff_sx = (sw.to(torch.float32) * recip(w))[:, None]
    o = torch.arange(cfg.crop_size, dtype=torch.float32, device=images.device)
    src_y = (top[:, None] + o + 0.5) / eff_sy - 0.5
    src_x = (left[:, None] + o + 0.5) / eff_sx - 0.5
    src_x = torch.where(flip[:, None], src_x.flip(1), src_x)
    out_img = _separable_bilinear(images.to(torch.float32), src_y, src_x)
    out_lbl = _separable_nearest(labels, src_y, src_x, fill=0)
    return normalize(out_img, cfg.mean, cfg.std), out_lbl


def augment_batch(
    images: torch.Tensor, labels: torch.Tensor, cfg: AugmentConfig,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and resample a batch on the generator's device (uint8 images
    are scaled to [0, 1] first)."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    b, h, w, _ = images.shape
    params = draw_augment_params(b, h, w, cfg, generator)
    return augment_resample(images, labels, *params, cfg)
