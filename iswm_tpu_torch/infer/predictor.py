"""Batch inference: checkpoint -> per-image products on disk, the
counterpart of ``iswm_tpu/infer/predictor.py`` ``Predictor``.

Walks an input directory (top level + one level of subdirectories) and
writes ``{name}_predict.png`` (+ optional ``_confidence.png`` and
``_binary_mask.png``) per image; scenes go through the batched
sliding-window TileEngine.  Serving variants: ``bf16`` (the model in its
compute dtype), ``int8`` (weight-only), ``int8_exec`` (1x1 convs in int8
through the hand-written matmul) and ``int8_exec_xla`` (every dense conv of
>= 64 input channels in int8 through the hand-written int8 convs; with
``int8_grouped`` / ``int8_stem`` the grouped convs / the stem too); both
``int8_exec`` variants calibrate on the first scene, and a checkpoint of
delayed-mode QAT lends them its learned input amaxes.  With
``save_feature_maps``, also ``{name}_fmap_{label}.png``: channel-mean
heatmaps of the backbone's two taps and the ASPP output on the centre tile.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..compat.bridge import load_checkpoint
from ..config import Config
from ..data.datasets import IMG_EXTENSIONS, decode_target
from ..data.transforms import val_transform_batch
from ..models import ASPP, build_model
from ..train.checkpoint import load_quant
from .products import binarize_confidence_map, confidence_map, prob_to_mask
from .quantization import (ServingFn, calibrate_conv_inputs, conv_scales_from_quant,
                           make_variant_fn)
from .tiling import TileEngine


def _channel_mean(feats: torch.Tensor) -> np.ndarray:
    """[1, c, h, w] activations -> [h, w] channel mean scaled to [0, 1]."""
    arr = feats[0].float().mean(dim=0).cpu().numpy()
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / (hi - lo + 1e-8)


class Predictor:
    def __init__(self, cfg: Config, ckpt_path: Optional[str] = None,
                 device: str = "cuda"):
        cfg.validate()
        variant = cfg.predict.serving_variant
        if variant not in ("bf16", "int8", "int8_exec", "int8_exec_xla"):
            raise ValueError(f"unknown serving_variant {variant!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg.model)  # seeded init without a checkpoint
        # a QAT checkpoint's running amaxes (``quant``), reused as int8 scales
        self.quant: Dict[str, torch.Tensor] = {}
        if ckpt_path:
            self.model.load_state_dict(load_checkpoint(ckpt_path), strict=True)
            self.quant = load_quant(ckpt_path)
        self.model.to(self.device, memory_format=torch.channels_last)

        self._needs_calibration = variant.startswith("int8_exec")
        if variant == "int8":
            fn = make_variant_fn(self.model, "int8")
        else:  # bf16, and int8_exec* until the first scene calibrates it
            fn = ServingFn(self.model, dict(self.model.named_parameters()))
        self.engine = self._make_engine(fn)

    def _make_engine(self, fn) -> TileEngine:
        p = self.cfg.predict
        return TileEngine(fn, tile=p.tile_size, overlap=p.tile_overlap,
                          batch=p.tile_batch, num_classes=self.cfg.model.num_classes)

    def _calibrate_int8(self, scene: torch.Tensor) -> None:
        """Calibrate conv input scales on three tiles of the first scene
        (top-left, bottom-right, centre) and swap the tile engine onto the
        int8 serving fn (one-time rebuild)."""
        t = self.cfg.predict.tile_size
        h, w = scene.shape[:2]
        tiles = []
        for ty, tx in ((0, 0), (max(0, h - t), max(0, w - t)),
                       (max(0, (h - t) // 2), max(0, (w - t) // 2))):
            tile = scene[ty : ty + t, tx : tx + t]
            if tile.shape[0] == t and tile.shape[1] == t:
                tiles.append(tile[None])
        if not tiles:  # scene smaller than a tile in some dim: crop + zero-pad
            tile = scene[:t, :t]
            tiles = [torch.nn.functional.pad(
                tile, (0, 0, 0, t - tile.shape[1], 0, t - tile.shape[0])
            )[None]]
        p = self.cfg.predict
        conv_scales = calibrate_conv_inputs(
            self.model, [x.permute(0, 3, 1, 2) for x in tiles], wide=True,
            grouped=p.int8_grouped, stem=p.int8_stem,
        )
        # QAT-learned input amaxes override the few-tile calibration where
        # present (learned over the whole training distribution)
        conv_scales.update(conv_scales_from_quant(self.quant))
        self.engine = self._make_engine(make_variant_fn(
            self.model, p.serving_variant, conv_scales=conv_scales,
            grouped=p.int8_grouped, stem=p.int8_stem,
        ))
        self._needs_calibration = False

    def predict_image(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 [H,W,3] image -> products dict.

        ``mask`` is fg prob > pred_threshold unless cfg.predict.use_argmax
        selects argmax (the validation semantics)."""
        cfg = self.cfg.predict
        x = val_transform_batch(torch.as_tensor(np.asarray(image), device=self.device))
        if self._needs_calibration:
            self._calibrate_int8(x)
        logits = self.engine.infer_scene(x)
        prob_fg = torch.softmax(logits, dim=-1)[..., 1].cpu().numpy()
        if cfg.use_argmax:
            mask = logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
        else:
            mask = prob_to_mask(prob_fg, cfg.pred_threshold)
        return {
            "mask": mask,
            "prob_fg": prob_fg,
            "confidence": confidence_map(prob_fg),
            "rgb": decode_target(mask),
        }

    def extract_feature_maps(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 [H, W, 3] image -> {label: [h, w] float map in [0, 1]}: the
        channel means of ``backbone_low_level``, ``backbone_out`` and
        ``aspp`` (the ASPP's output) on the centre tile, reflect-padded to
        the tile size where the image is smaller, through the model in its
        compute dtype (the JAX package's ``extract_feature_maps``)."""
        t = self.cfg.predict.tile_size
        h, w = image.shape[:2]
        top, left = max(0, (h - t) // 2), max(0, (w - t) // 2)
        tile = image[top:top + t, left:left + t]
        if tile.shape[0] < t or tile.shape[1] < t:
            tile = np.pad(tile, ((0, t - tile.shape[0]), (0, t - tile.shape[1]), (0, 0)),
                          mode="reflect")
        x = val_transform_batch(torch.as_tensor(np.ascontiguousarray(tile), device=self.device))
        taps: Dict[str, torch.Tensor] = {}
        aspp = next(m for m in self.model.modules() if isinstance(m, ASPP))
        hooks = [
            self.model.backbone.register_forward_hook(
                lambda m, args, out: taps.update({f"backbone_{k}": v for k, v in out.items()})),
            aspp.register_forward_hook(lambda m, args, out: taps.update(aspp=out)),
        ]
        try:
            with torch.inference_mode():
                self.model(x[None].permute(0, 3, 1, 2))
        finally:
            for hook in hooks:
                hook.remove()
        return {label: _channel_mean(v) for label, v in taps.items()}

    def process_images(self, input_dir: str, output_dir: str) -> int:
        """Walk input_dir (and one level of subdirs); write products.
        Returns the number of images processed."""
        from PIL import Image

        cfg = self.cfg.predict
        os.makedirs(output_dir, exist_ok=True)
        jobs = []
        for entry in sorted(Path(input_dir).iterdir()):
            if entry.is_file() and entry.suffix.lower() in IMG_EXTENSIONS:
                jobs.append((entry, Path(output_dir)))
            elif entry.is_dir():
                sub_out = Path(output_dir) / entry.name
                for f in sorted(entry.iterdir()):
                    if f.is_file() and f.suffix.lower() in IMG_EXTENSIONS:
                        jobs.append((f, sub_out))

        count = 0
        for src, out_dir in jobs:
            try:
                out_dir.mkdir(parents=True, exist_ok=True)
                with Image.open(src) as im:
                    image = np.asarray(im.convert("RGB"), dtype=np.uint8)
                products = self.predict_image(image)
                stem = src.stem
                Image.fromarray(products["rgb"]).save(out_dir / f"{stem}_predict.png")
                if cfg.save_confidence:
                    Image.fromarray(products["confidence"]).save(
                        out_dir / f"{stem}_confidence.png"
                    )
                if cfg.save_binary:
                    binary = binarize_confidence_map(
                        products["confidence"],
                        min_prob=cfg.min_prob,
                        max_prob=cfg.max_prob,
                        pred_mask=products["rgb"],
                        enable_wave_processing=cfg.enable_wave_processing,
                        synthetic_prob=cfg.synthetic_damage_prob,
                        synthetic_ratio=cfg.synthetic_damage_ratio,
                    )
                    Image.fromarray(binary).save(out_dir / f"{stem}_binary_mask.png")
                if cfg.save_feature_maps:
                    for label, fmap in self.extract_feature_maps(image).items():
                        Image.fromarray((fmap * 255).astype(np.uint8)).save(
                            out_dir / f"{stem}_fmap_{label}.png")
                count += 1
            except (OSError, ValueError) as e:  # skip unreadable images
                print(f"skipping {src}: {e}")
        return count
