"""Training CLI of the port, the counterpart of ``iswm_tpu/cli/train.py``.

``python -m iswm_tpu_torch.cli.train --synthetic [--device cuda] ...``

Data-parallel on N processes (``nccl`` on N cards, ``gloo`` with
``--device cpu``); ``--batch_size`` is the global batch:

    torchrun --standalone --nproc_per_node=N -m iswm_tpu_torch.cli.train ...

Accepts the reference's consumed argparse surface (reference
train.py:272-351), so shell scripts written against the reference or
against ``python -m iswm_tpu.cli.train`` work unchanged: the same flags and
defaults, with ``--device`` (a torch device) in place of ``--platform``.
Dead reference flags are accepted and ignored with a note.  A ``--config``
YAML can set everything; explicit flags win.  Flags of features the port
has not reached are parsed into the config, and the trainer refuses them
by their ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys

from ..config import Config


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ISWM training (PyTorch/CUDA)")
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")

    # data
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None,
                   help="training crop; batches must be uniform-sized, so "
                        "images are cropped/validated to this")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--val_batch_size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true", help="use synthetic fixtures")
    p.add_argument("--sequence_val", action="store_true",
                   help="synthetic validation split as temporally-coherent\n"
                        "sequences (exercises the 7-frame sliding-window\n"
                        "temporal metrics the way real Himawari series do)")

    # model
    p.add_argument("--model", type=str, default=None,
                   help="factory name, e.g. deeplabv3plus_resnet50")
    p.add_argument("--output_stride", type=int, default=None, choices=[8, 16])
    p.add_argument("--separable_conv", action="store_true",
                   help="use atrous separable convs in the head (functional here)")
    p.add_argument("--pretrained_backbone", action="store_true",
                   help="initialize the backbone from cached ImageNet weights "
                        "(reference default; see compat/pretrained.py for the "
                        "cache search order)")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--int8_training", type=int, default=None,
                   help="QAT: min input channels to route forward convs "
                        "through executed int8 (0 = off; 64 = all eligible)")
    p.add_argument("--int8_scale_mode", type=str, default=None,
                   choices=["dynamic", "delayed"],
                   help="activation-scale mode for --int8_training convs "
                        "(delayed = fp8-style stale scaling, one fusable "
                        "quantize pass)")
    p.add_argument("--int8_bwd", type=int, default=None, choices=[0, 1],
                   help="with --int8_training: dgrad/wgrad of the gated "
                        "convs also run in int8 (quantized "
                        "cotangents, int8 activation residuals)")
    p.add_argument("--int8_switch_iter", type=int, default=None,
                   help="int8-early/bf16-finish hybrid schedule: with "
                        "--int8_training, iterations >= this run the plain "
                        "bf16 train step (params/optimizer/BN stats carry "
                        "over; 0 = off)")
    p.add_argument("--int8_route", type=str, default=None,
                   choices=["gate", "cost"],
                   help="int8_training site selection: 'gate' = the channel "
                        "threshold alone; 'cost' = per-site roofline model "
                        "with the threshold as an eligibility floor")
    p.add_argument("--int8_cost_bytes", type=float, default=None,
                   help="bytes/value the cost model charges a dynamic "
                        "quantize pass (default 3.0; sweeps only)")
    p.add_argument("--grouped_blockdiag", type=int, default=None,
                   help="execute grouped convs with <= this many input "
                        "channels as block-diagonal dense convs (same "
                        "math and parameters; -1 = auto, the default; "
                        "0 = off).  The port runs native grouped convs "
                        "whatever the value")

    # optimization
    p.add_argument("--total_itrs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optimizer", type=str, default=None,
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--lr_schedule", type=str, default=None,
                   choices=["cosine", "poly"])
    p.add_argument("--loss_type", type=str, default=None,
                   choices=["ce_loss", "IWce_loss", "focal_loss"])

    # loop control
    p.add_argument("--random_seed", type=int, default=None)
    p.add_argument("--print_interval", type=int, default=None)
    p.add_argument("--val_interval", type=int, default=None)
    p.add_argument("--quick_eval_interval", type=int, default=None,
                   help="device-side CM-only eval every N iters (0 = off)")
    p.add_argument("--sequence_length", type=int, default=None)

    # checkpoints / outputs
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--checkpoints_dir", type=str, default=None)
    p.add_argument("--val_results_dir", type=str, default=None)
    p.add_argument("--metrics_plots_dir", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--save_confidence_map", action="store_true")
    p.add_argument("--val_dump_limit", type=int, default=None,
                   help="val samples dumped on a new best (0 = whole val "
                        "set, the reference's behavior; default 8)")
    p.add_argument("--enable_mlflow", action="store_true")

    # accepted for reference-script compatibility; non-functional there too
    p.add_argument("--test_only", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--step_size", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--training_stage", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--gpu_id", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--enable_vis", action="store_true", help=argparse.SUPPRESS)
    return p


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config.from_yaml(args.config) if args.config else Config()

    if args.model:
        head, _, backbone = args.model.partition("_")
        cfg.model.name = head
        cfg.model.backbone = "mobilenetv2" if backbone == "mobilenet" else backbone
    for flag, path in (
        ("data_root", ("data", "data_root")),
        ("dataset", ("data", "dataset")),
        ("crop_size", ("data", "crop_size")),
        ("batch_size", ("data", "batch_size")),
        ("val_batch_size", ("data", "val_batch_size")),
        ("num_classes", ("model", "num_classes")),
        ("output_stride", ("model", "output_stride")),
        ("compute_dtype", ("model", "compute_dtype")),
        ("int8_training", ("model", "int8_training")),
        ("int8_scale_mode", ("model", "int8_scale_mode")),
        ("int8_bwd", ("model", "int8_training_bwd")),
        ("int8_route", ("model", "int8_route")),
        ("int8_switch_iter", ("train", "int8_switch_iter")),
        ("int8_cost_bytes", ("model", "int8_cost_bytes")),
        ("grouped_blockdiag", ("model", "grouped_blockdiag")),
        ("total_itrs", ("train", "total_itrs")),
        ("lr", ("optim", "lr")),
        ("optimizer", ("optim", "optimizer")),
        ("weight_decay", ("optim", "weight_decay")),
        ("lr_schedule", ("optim", "schedule")),
        ("loss_type", ("loss", "loss_type")),
        ("random_seed", ("train", "random_seed")),
        ("print_interval", ("train", "print_interval")),
        ("val_interval", ("train", "val_interval")),
        ("quick_eval_interval", ("train", "quick_eval_interval")),
        ("sequence_length", ("metrics", "sequence_length")),
        ("ckpt", ("train", "ckpt")),
        ("checkpoints_dir", ("train", "checkpoints_dir")),
        ("val_results_dir", ("train", "val_results_dir")),
        ("metrics_plots_dir", ("train", "metrics_plots_dir")),
        ("log_dir", ("train", "log_dir")),
        ("val_dump_limit", ("train", "val_dump_limit")),
    ):
        v = getattr(args, flag)
        if v is not None:
            setattr(getattr(cfg, path[0]), path[1], v)

    if args.synthetic:
        cfg.data.synthetic = True
    if args.sequence_val:
        cfg.data.synthetic_sequence_val = True
    if args.separable_conv:
        cfg.model.separable_conv = True
    if args.pretrained_backbone:
        cfg.model.pretrained_backbone = True
    if args.continue_training:
        cfg.train.continue_training = True
    if args.save_confidence_map:
        cfg.train.save_confidence_map = True
    if args.enable_mlflow:
        cfg.train.use_mlflow = True
    for dead in ("test_only", "step_size", "training_stage", "gpu_id", "enable_vis"):
        if getattr(args, dead, None):
            print(f"note: --{dead} is accepted for compatibility but has no effect")
    return cfg.validate()


def main(argv=None) -> int:
    args = get_argparser().parse_args(argv)
    from ..parallel import destroy, maybe_initialize_distributed, rank

    # "cuda" is this rank's card, cuda:LOCAL_RANK
    maybe_initialize_distributed(device=None if args.device == "cuda" else args.device)
    try:
        cfg = build_config(args)
        from ..train import Trainer

        result = Trainer(cfg, device=args.device).fit()
        if rank() == 0:
            print(f"done: best weighted score {result['best_weighted_score']:.4f}")
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
