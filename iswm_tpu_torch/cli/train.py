"""Training CLI of the port, the counterpart of ``iswm_tpu/cli/train.py``.

``python -m iswm_tpu_torch.cli.train --synthetic [--device cuda] ...``

The flags are the JAX CLI's (its argument parser and config builder import
no jax and are reused as they are), plus ``--device``; ``--platform``, a
JAX platform, has no effect here.
"""

from __future__ import annotations

import sys

from iswm_tpu.cli.train import build_config
from iswm_tpu.cli.train import get_argparser as _jax_argparser


def get_argparser():
    p = _jax_argparser()
    p.description = "ISWM training (PyTorch/CUDA)"
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    return p


def main(argv=None) -> int:
    args = get_argparser().parse_args(argv)
    cfg = build_config(args)
    if args.platform:
        print("note: --platform selects a JAX platform and has no effect here; "
              "use --device")
    from ..train import Trainer

    result = Trainer(cfg, device=args.device).fit()
    print(f"done: best weighted score {result['best_weighted_score']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
