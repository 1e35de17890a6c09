"""Prediction CLI of the port, the counterpart of ``iswm_tpu/cli/predict.py``.

``python -m iswm_tpu_torch.cli.predict --input_dir ... --ckpt model.pth
--output_dir ... [--device cuda] [--serving_variant int8_exec_xla
[--int8_grouped] [--int8_stem]]``

The flags are the JAX CLI's, with ``--device`` in place of ``--platform``.
``--ckpt`` takes a reference-format .pth (``python -m
iswm_tpu.cli.export_torch`` writes one from an Orbax checkpoint); without
it the model has seeded random weights.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import Config


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ISWM batch prediction (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="predictions")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference-format .pth checkpoint")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--output_stride", type=int, default=None, choices=[8, 16])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--pred_threshold", type=float, default=None)
    p.add_argument("--use_argmax", action="store_true",
                   help="validation semantics (argmax) instead of fg-prob threshold")
    p.add_argument("--save_confidence", action="store_true")
    p.add_argument("--save_binary", action="store_true")
    p.add_argument("--binary_threshold", type=int, default=None)
    p.add_argument("--min_prob", type=float, default=None)
    p.add_argument("--max_prob", type=float, default=None)
    p.add_argument("--enable_wave_processing", action="store_true")
    p.add_argument("--save_feature_maps", action="store_true",
                   help="also write channel-mean heatmaps of the backbone taps "
                        "and the ASPP output ({name}_fmap_{label}.png)")
    p.add_argument("--serving_variant", type=str, default=None,
                   choices=["bf16", "int8", "int8_exec", "int8_exec_xla"],
                   help="serving precision (int8_exec: 1x1 convs in int8 "
                        "through the CUDA matmul; int8_exec_xla: every dense "
                        "conv of >= 64 input channels in int8 through the "
                        "CUDA int8 convs)")
    p.add_argument("--int8_grouped", action="store_true",
                   help="with int8_exec_xla: also run the grouped and "
                        "depthwise convs in int8")
    p.add_argument("--int8_stem", action="store_true",
                   help="with int8_exec_xla: also run the stem conv in int8")
    p.add_argument("--tile_size", type=int, default=None)
    p.add_argument("--tile_overlap", type=int, default=None)
    p.add_argument("--tile_batch", type=int, default=None)
    return p


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.model:
        head, _, backbone = args.model.partition("_")
        cfg.model.name = head
        cfg.model.backbone = "mobilenetv2" if backbone == "mobilenet" else backbone
    if args.output_stride is not None:
        cfg.model.output_stride = args.output_stride
    if args.num_classes is not None:
        cfg.model.num_classes = args.num_classes
    if args.compute_dtype is not None:
        cfg.model.compute_dtype = args.compute_dtype
    cfg.predict.input_dir = args.input_dir
    cfg.predict.output_dir = args.output_dir
    for flag in ("pred_threshold", "binary_threshold", "min_prob", "max_prob",
                 "tile_size", "tile_overlap", "tile_batch", "serving_variant"):
        v = getattr(args, flag)
        if v is not None:
            setattr(cfg.predict, flag, v)
    for flag in ("use_argmax", "save_confidence", "save_binary",
                 "enable_wave_processing", "save_feature_maps",
                 "int8_grouped", "int8_stem"):
        if getattr(args, flag):
            setattr(cfg.predict, flag, True)
    return cfg.validate()


def main(argv=None) -> int:
    args = get_argparser().parse_args(argv)
    cfg = build_config(args)
    if not os.path.isdir(cfg.predict.input_dir):  # fail fast, before model build
        print(f"error: --input_dir {cfg.predict.input_dir!r} is not a directory")
        return 2
    from ..infer import Predictor

    predictor = Predictor(cfg, ckpt_path=args.ckpt, device=args.device)
    n = predictor.process_images(cfg.predict.input_dir, cfg.predict.output_dir)
    print(f"processed {n} images -> {cfg.predict.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
