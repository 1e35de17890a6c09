"""The ranks of the port's data-parallel tests (``tests/test_torch_parallel.py``).

Each rank is a process spawned from the test, one rank of a ``gloo`` group
on the CPU opened through a rendezvous file.  It reads the inputs the test
wrote (``payload``), runs every port-side check of the module and saves what
it saw for the test to compare (``rank{r}.pt``).  This module imports neither
jax nor the JAX package: a spawned child imports it.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

WORLD = 2
TOTAL = 50  # total_itrs of the optimizer's cosine schedule, as in the step tests


def start_ranks(payload_path: str, out_dir: str, world: int = WORLD):
    """Spawn ``world`` ranks of :func:`rank_main` without waiting; returns the
    process context to ``join``."""
    init_file = os.path.join(out_dir, "rendezvous")
    return torch.multiprocessing.start_processes(
        rank_main, args=(world, init_file, payload_path, out_dir), nprocs=world,
        join=False, start_method="spawn")


def join_ranks(context, out_dir: str, timeout: float, world: int = WORLD) -> list:
    """Wait for the ranks (a child's exception is raised here) and load what
    each saved."""
    import time

    deadline = time.monotonic() + timeout
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in context.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_main(rank: int, world: int, init_file: str, payload_path: str, out_dir: str):
    from iswm_tpu_torch.parallel import destroy, maybe_initialize_distributed

    torch.set_num_threads(2)
    payload = torch.load(payload_path, weights_only=False)
    assert maybe_initialize_distributed(f"file://{init_file}", rank, world, device="cpu")
    try:
        seen = {
            "mesh": _mesh_checks(),
            "ce": [_sharded_ce(case) for case in payload["ce_cases"]],
            "bn": [_batchnorm(case) for case in payload["bn_cases"]],
            "step": _train_step(payload["step"]),
            "qat": _train_step(payload["step"], qat=True),
            "refusals": _refusals(),
            "fit": _fit(payload["fit_dir"]),
        }
    finally:
        destroy()
    seen["jax_loaded"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "flax", "optax", "iswm_tpu"))
    torch.save(seen, os.path.join(out_dir, f"rank{rank}.pt"))


def _raised(fn) -> tuple:
    """(exception class name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # the test checks the class and the message
        return type(e).__name__, str(e)
    return None


def _rows(a):
    """This rank's rows of a global batch."""
    from iswm_tpu_torch.parallel import make_mesh, shard_batch

    return shard_batch(make_mesh(), a)


def _mesh_checks() -> dict:
    from iswm_tpu_torch.parallel import (
        make_mesh,
        process_local_batch_slice,
        rank,
        shard_batch,
        world_size,
    )

    mesh = make_mesh()
    x = np.arange(8 * 3).reshape(8, 3)
    sx, sy = shard_batch(mesh, x, torch.arange(8))
    return {
        "rank": rank(), "world": world_size(), "shape": mesh.shape,
        "mesh_2": make_mesh(data_axis=2).shape, "sx": sx, "sy": sy,
        "local": process_local_batch_slice(8),
        "not_divisible": _raised(lambda: process_local_batch_slice(3)),
        "model_3": _raised(lambda: make_mesh(model_axis=3)),
        "data_3": _raised(lambda: make_mesh(data_axis=3)),
        "model_2": _raised(lambda: make_mesh(model_axis=2)),
        "odd_batch": _raised(lambda: shard_batch(mesh, x[:3])),
    }


def _sharded_ce(case: dict) -> dict:
    """Loss and this rank's d_logits through the sharded CE (its plain version
    and ``make_sharded_fused_ce``, which on CPU tensors runs the plain
    versions of kernel #4)."""
    from iswm_tpu_torch.ops.kernels.fused_ce import (
        make_sharded_fused_ce,
        sharded_fused_binary_ce_plain,
    )

    labels = torch.from_numpy(_rows(case["labels"]))
    cw = torch.from_numpy(case["cw"])
    out = {}
    for name, fn in (("plain", sharded_fused_binary_ce_plain),
                     ("wrapper", make_sharded_fused_ce())):
        logits = torch.from_numpy(_rows(case["logits"])).requires_grad_()
        loss = fn(logits, labels, cw)
        loss.backward()
        out[name] = (loss.item(), logits.grad.numpy())
    return out


def _batchnorm(case: dict) -> dict:
    """Output, running statistics and gradients (x's rows; this rank's share
    of the weight's and the bias's) of the cross-replica BatchNorm2d."""
    from iswm_tpu_torch.models import layers

    c = case["x"].shape[1]
    bn = layers.BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(_rows(case["x"])).requires_grad_()
    before = layers.cross_replica_all_reduces
    y = bn(x)
    y.backward(torch.from_numpy(_rows(case["dy"])))
    return {"y": y.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "all_reduces": layers.cross_replica_all_reduces - before}


def _dropout_off(model) -> None:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


QAT = dict(int8_training=64, int8_scale_mode="delayed")  # the QAT step's model


def _train_step(case: dict, qat: bool = False) -> dict:
    """One data-parallel step of resnet18 from the crossed weights on this
    rank's rows: the sharded CE (plain versions), the cross-replica
    BatchNorm and the summing gradient reduction; with ``qat``, of the
    delayed-mode QAT model (``QAT``), its amaxes taken over both ranks."""
    from iswm_tpu_torch.compat import load_checkpoint
    from iswm_tpu_torch.config import ModelConfig, OptimConfig
    from iswm_tpu_torch.models import build_model, layers
    from iswm_tpu_torch.ops import int8_train
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from iswm_tpu_torch.train.step import data_parallel

    model = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32",
                                    **(QAT if qat else {})))
    model.load_state_dict(load_checkpoint(case["ckpt"]), strict=True)
    _dropout_off(model)
    factory, _ = make_optimizer(OptimConfig(), TOTAL)
    state = TrainState(model, *factory(model.parameters()), 0, data_parallel(model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    all_reduces = layers.cross_replica_all_reduces
    amax_reduces = int8_train.amax_all_reduces
    loss = make_train_step(make_loss_fn("ce_loss", fused="interpret"))(
        state, torch.from_numpy(_rows(case["images"])), torch.from_numpy(_rows(case["labels"])))
    return {"loss": float(loss), "before": before,
            "after": {k: v.clone() for k, v in model.state_dict().items()},
            "count": state.step,
            "all_reduces": layers.cross_replica_all_reduces - all_reduces,
            "amax_all_reduces": int8_train.amax_all_reduces - amax_reduces,
            "amaxes": {k: v.clone() for k, v in layers.quant_state(model).items()},
            "routed": len(layers.routed_sites(model, True)),
            "batchnorms": sum(isinstance(m, layers.BatchNorm2d) for m in model.modules())}


def _refusals() -> dict:
    from iswm_tpu_torch.config import Config, ModelConfig
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.train import Trainer

    def model(**fused):
        cfg = ModelConfig(backbone="resnet50", compute_dtype="float32")
        for k, v in fused.items():
            setattr(cfg, k, v)
        return build_model(cfg)

    def trainer(section, key, value):
        cfg = Config()
        setattr(getattr(cfg, section), key, value)
        return Trainer(cfg, device="cpu")

    auto = model(fused_stem="auto", fused_blocks="auto").backbone
    return {
        "auto": (auto.fused_stem, auto.layer1[0].fused_mode),
        **{f"{k}={v}": _raised(lambda k=k, v=v: model(**{k: v}))
           for k in ("fused_stem", "fused_blocks") for v in ("always", "interpret")},
        "model_axis": _raised(lambda: trainer("parallel", "model_axis", 2)),
        "data_axis": _raised(lambda: trainer("parallel", "data_axis", 3)),
        "batch": _raised(lambda: trainer("data", "batch_size", 3)),
    }


def _fit(root: str) -> dict:
    """``Trainer.fit`` of 2 steps and a validation on the group."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, generate_scene
    from iswm_tpu_torch.train import Trainer

    rng = np.random.default_rng(0)
    images, masks = zip(*(generate_scene(rng, size=(40, 40)) for _ in range(8)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = "resnet18", "float32"
    cfg.data.crop_size, cfg.data.batch_size = 32, 4
    cfg.train.total_itrs, cfg.train.val_interval, cfg.train.print_interval = 2, 2, 1
    cfg.train.save_val_results = False
    cfg.metrics.sequence_length = 3
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, os.path.join(root, name))
    trainer = Trainer(cfg, device="cpu", train_ds=dataset, val_ds=dataset)
    trainer.fit()
    return {"step": trainer.state.step, "best_path": trainer.best_path,
            "losses": None if trainer.logger is None
            else list(trainer.logger.history["train_loss"]),
            "state": {k: v.clone() for k, v in trainer.state.model.state_dict().items()},
            "checkpoints": sorted(os.listdir(cfg.train.checkpoints_dir))}
