"""Quantization evaluation CLI of the port, the counterpart of
``iswm_tpu/cli/evaluate_quantization.py``.

``python -m iswm_tpu_torch.cli.evaluate_quantization --data_dir <imgs/ +
masks/ tree> [--ckpt model.pth] [--device cuda] [--variants
f32,bf16,int8,int8_act,int8_exec,int8_exec_xla] [--int8_grouped] [--int8_stem]``

Compares serving variants on an ``imgs/`` + ``masks/`` evaluation tree and
prints the latency / size / metric-delta table with tiered verdicts
(reference evaluate_quantization.py:81-89, 187-354).  The flags are the JAX
CLI's, with ``--device`` in place of ``--platform``.  ``--ckpt`` takes a
reference-format .pth (``python -m iswm_tpu.cli.export_torch`` writes one
from an Orbax checkpoint); without it the model has seeded random weights.
``--int8_grouped`` and ``--int8_stem`` (not in the JAX CLI, whose
comparison never routes those sites) pass to the ``int8_exec_xla`` variant
as ``Predictor`` takes them.
"""

from __future__ import annotations

import argparse
import sys

from ..config import Config


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ISWM quantization evaluation (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory with imgs/ and masks/ subdirs")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference-format .pth checkpoint")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--output_stride", type=int, default=None, choices=[8, 16])
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--variants", type=str, default="f32,bf16,int8",
                   # also available: int8_act (fake-quant PTQ simulation),
                   # int8_exec (eligible 1x1 convs in int8 through the CUDA
                   # matmul) and int8_exec_xla (every dense conv of >= 64
                   # input channels in int8 through the CUDA int8 convs)
                   help="comma-separated: "
                        "f32,bf16,int8,int8_act,int8_exec,int8_exec_xla")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--sequence_length", type=int, default=7)
    p.add_argument("--comparison_dir", type=str, default=None,
                   help="write per-variant comparison panels here")
    p.add_argument("--int8_grouped", action="store_true",
                   help="with int8_exec_xla: also run the grouped and "
                        "depthwise convs in int8")
    p.add_argument("--int8_stem", action="store_true",
                   help="with int8_exec_xla: also run the stem conv in int8")
    return p


def main(argv=None) -> int:
    args = get_argparser().parse_args(argv)
    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.model:
        head, _, backbone = args.model.partition("_")
        cfg.model.name = head
        cfg.model.backbone = "mobilenetv2" if backbone == "mobilenet" else backbone
    if args.output_stride is not None:
        cfg.model.output_stride = args.output_stride
    if args.compute_dtype is not None:
        cfg.model.compute_dtype = args.compute_dtype
    cfg.validate()

    import torch

    from ..compat.bridge import load_checkpoint
    from ..data.datasets import EvaluationDataset
    from ..infer.quantization import compare_variants, format_report
    from ..models import build_model

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA card is "
                           "available (pass --device cpu to run on the CPU)")

    # a flat root with imgs/ + masks/ subdirs (reference layout,
    # evaluate_quantization.py:34-50)
    dataset = EvaluationDataset(args.data_dir, split="")

    model = build_model(cfg.model)  # seeded init without a checkpoint
    if args.ckpt:
        model.load_state_dict(load_checkpoint(args.ckpt), strict=True)
    model.to(device, memory_format=torch.channels_last)

    variants = tuple(v.strip() for v in args.variants.split(",") if v.strip())
    report = compare_variants(
        model,
        dataset,
        variants=variants,
        sequence_length=args.sequence_length,
        max_images=args.max_images,
        comparison_dir=args.comparison_dir,
        grouped=args.int8_grouped,
        stem=args.int8_stem,
    )
    print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
