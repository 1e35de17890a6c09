"""The multi-device dry run, the counterpart of ``__graft_entry__.py``
``dryrun_multichip``: one augmented train step of the flagship model over an
n-rank (data, model) grid, then ``int8_exec_xla`` serving through the
scene-parallel ``TileEngine``.

    python -m iswm_tpu_torch.parallel.dryrun --devices 4                  # nccl, a card a rank
    python -m iswm_tpu_torch.parallel.dryrun --devices 4 --backend gloo   # gloo, all on cuda:0
    python -m iswm_tpu_torch.parallel.dryrun --devices 4 --device cpu     # gloo on the CPU
    python -m iswm_tpu_torch.parallel.dryrun --devices 4 --device cpu --backbone xception

The grid has a model axis of 2 when n is even and at least 4 (the image rows
split over 2 ranks, ``parallel/spatial.py``), else 1.  The step is
``deeplabv3plus_resnet50`` (OS 16, float32; ``--backbone`` another of the
zoo's, as the JAX dry run's ``ISWM_DRYRUN_BACKBONE``: Xception's maps split
unevenly) at crop 32 on 40x40 uint8 images, 2 a data index; the serving fn
is calibrated wide on the trained weights and serves a (2 * tile + 8) x (2 *
tile) scene with every rank on the data axis.  :func:`dryrun_body` runs in a
group that is already open.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .distributed import destroy, maybe_initialize_distributed, rank, world_size
from .mesh import make_mesh, shard_batch


def dryrun_body(backbone: str = "resnet50", crop: int = 32, model_axis=None,
                device="cuda") -> dict:
    """One train step and one scene served, on every rank of the open group;
    asserts a finite loss, step 1, the scene's shape, finite logits and a
    routed int8 site; returns what it saw."""
    from ..config import Config
    from ..data.transforms import AugmentConfig
    from ..infer.quantization import calibrate_conv_inputs, make_variant_fn
    from ..infer.tiling import TileEngine
    from ..models import build_model
    from ..ops.losses import make_loss_fn
    from ..train.optim import make_optimizer
    from ..train.step import TrainState, data_parallel, make_train_step
    from ..train.trainer import rank_seed

    n = world_size()
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // model_axis, model_axis)
    device = torch.device(device)
    lead = rank() == 0
    if lead:
        print(f"dryrun mesh: {mesh.shape} over {n} ranks")

    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = backbone, "float32"
    model = build_model(cfg.model).to(
        device, memory_format=torch.channels_last if device.type == "cuda"
        else torch.preserve_format)
    factory, _ = make_optimizer(cfg.optim, 100)
    state = TrainState(model, *factory(model.parameters()), 0, data_parallel(model))
    augment = AugmentConfig(crop_size=crop, scale_min=0.75, scale_max=1.25)
    generator = torch.Generator(device=device).manual_seed(rank_seed(0, mesh.data_index))
    step = make_train_step(make_loss_fn("ce_loss", device=device), augment=augment,
                           generator=generator, mesh=mesh)
    batch = 2 * mesh.data
    images = np.random.default_rng(0).integers(0, 255, (batch, 40, 40, 3)).astype(np.uint8)
    labels = np.zeros((batch, 40, 40), np.int32)
    images, labels = (torch.from_numpy(a).to(device) for a in shard_batch(mesh, images, labels))
    loss = float(step(state, images, labels))
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert state.step == 1
    if lead:
        print(f"dryrun_multichip OK: {n} ranks, loss={loss:.4f}")

    # serving: int8_exec_xla on the trained weights, tiles over every rank
    tile = max(crop, 32)
    model.eval()
    x0 = torch.from_numpy(np.random.default_rng(1).normal(size=(1, tile, tile, 3))
                          .astype(np.float32)).to(device)
    scales = calibrate_conv_inputs(model, [x0.permute(0, 3, 1, 2)], wide=True)
    serve = make_variant_fn(model, "int8_exec_xla", conv_scales=scales)
    engine = TileEngine(serve, tile=tile, overlap=tile // 4, batch=1, mesh=make_mesh())
    scene = torch.from_numpy(np.random.default_rng(2).normal(size=(2 * tile + 8, 2 * tile, 3))
                             .astype(np.float32)).to(device)
    logits = engine.infer_scene(scene)
    assert tuple(logits.shape) == (2 * tile + 8, 2 * tile, 2), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite serving logits"
    assert serve.routed_sites, "int8 serving path routed no convs"
    if lead:
        print(f"dryrun_multichip serving OK: int8_exec_xla TileEngine on {n} ranks, "
              f"{len(set(serve.routed_sites))} int8 conv sites, scene {tuple(logits.shape)}")
    return {"mesh": mesh.shape, "loss": loss, "step": state.step,
            "logits": logits.detach().cpu(), "routed": len(serve.routed_sites)}


def _rank(r: int, n: int, rendezvous: str, device: str, backend, backbone: str, crop: int):
    if device == "cuda":
        device = "cuda:0" if backend == "gloo" else f"cuda:{r}"
    maybe_initialize_distributed(f"file://{rendezvous}", r, n, device=device, backend=backend)
    try:
        dryrun_body(backbone, crop, device=device)
    finally:
        destroy()


def dryrun_multichip(n_devices: int, device: str = "cuda", backend=None,
                     backbone: str = "resnet50", crop: int = 32) -> None:
    """Open an ``n_devices``-rank group of spawned processes and run
    :func:`dryrun_body` on each: ``nccl`` with a card a rank (``device``
    ``"cuda"``), ``gloo`` on the CPU (``"cpu"``), or ``gloo`` with every rank
    on ``cuda:0`` (``backend="gloo"``).  A rank that fails raises here."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA dry run was asked for, but no CUDA card is available "
                           "(pass device='cpu' for gloo on the CPU)")
    if device == "cuda" and backend != "gloo" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards for nccl, have "
                           f"{torch.cuda.device_count()} (pass backend='gloo' to share cuda:0)")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank, args=(n_devices, os.path.join(tmp, "rendezvous"), device, backend,
                         backbone, crop),
            nprocs=n_devices, join=True, start_method="spawn")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument("--crop", type=int, default=32)
    args = parser.parse_args(argv)
    dryrun_multichip(args.devices, args.device, args.backend, args.backbone, args.crop)


if __name__ == "__main__":
    main()
