"""The ranks of the port's data-parallel tests (``tests/test_torch_parallel.py``).

Each rank is a process spawned from the test, one rank of a ``gloo`` group
on the CPU opened through a rendezvous file.  It reads the inputs the test
wrote (``payload``), runs every port-side check of the module and saves what
it saw for the test to compare (``rank{r}.pt``).  This module imports neither
jax nor the JAX package: a spawned child imports it.
"""

from __future__ import annotations

import contextlib
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
    from iswm_tpu_torch.parallel import destroy, make_mesh, maybe_initialize_distributed

    torch.set_num_threads(2)
    payload = torch.load(payload_path, weights_only=False)
    assert maybe_initialize_distributed(f"file://{init_file}", rank, world, device="cpu")
    try:
        seen = {
            "mesh": _mesh_checks(),
            "ce": [_sharded_ce(case) for case in payload["ce_cases"]],
            "bn": [_batchnorm(case) for case in payload["bn_cases"]],
            "step": _train_step(payload["step"]),
            "qat": _train_step(payload["step"], QAT),
            "qat_bwd": _train_step(payload["step"], QAT_BWD),
            "remat": _train_step(payload["step"], remat=True),
            "int8_bwd_conv": _int8_bwd_conv(payload["int8_bwd_conv"]),
            "fused_block": _fused_block(payload["fused_block"]),
            "fused_stem": _fused_stem(payload["fused_stem"]),
            **_fused_steps(payload["step"]),
            "refusals": _refusals(payload["fit_dir"] + "-spatial"),
            "fit": _fit(payload["fit_dir"]),
        }
        spatial = make_mesh(1, WORLD)  # one model group of both ranks
        seen["spatial_mesh"] = _spatial_mesh_checks(spatial)
        seen["halo"] = [_halo(spatial, case) for case in payload["halo_cases"]]
        seen["spatial_step"] = step = _train_step(payload["step"], mesh=spatial)
        seen.update({  # of the option's steps, what kept() keeps
            "spatial_remat": kept(_train_step(payload["step"], remat=True, mesh=spatial),
                                  like=step),
            "spatial_qat": kept(_train_step(payload["step"], QAT, mesh=spatial)),
            "spatial_qat_bwd": kept(_train_step(payload["step"], QAT_BWD, mesh=spatial),
                                    state=False),
            "spatial_int8_bwd_conv": _spatial_int8_bwd_conv(spatial,
                                                            payload["spatial_int8_bwd_conv"]),
            **{f"spatial_{b}": _spatial_backbone(payload["step"], b, spatial)
               for b in SPATIAL_BACKBONES},
            "tiles": _tile_engines(payload["tiles"]),
            "dryrun": _dryrun(),
        })
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
        "model_2": make_mesh(model_axis=2).shape,
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
    from iswm_tpu_torch.parallel import distributed

    c = case["x"].shape[1]
    bn = layers.BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(_rows(case["x"])).requires_grad_()
    before = distributed.cross_replica_all_reduces
    y = bn(x)
    y.backward(torch.from_numpy(_rows(case["dy"])))
    return {"y": y.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "all_reduces": distributed.cross_replica_all_reduces - before}


def _dropout_off(model) -> None:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


# the options still refused under a model axis above 1 (section, key, value)
SPATIAL_REFUSED = (("model", "fused_stem", "always"), ("model", "fused_blocks", "interpret"))
# the options a Trainer takes under a model axis of 2 (once refused there), in
# two Trainers: the Config fields each sets
SPATIAL_ACCEPTED = {
    "mobilenetv2-int8_training": (("model", "backbone", "mobilenetv2"),
                                  ("model", "int8_training", 64)),
    "xception-int8_training_bwd-remat": (("model", "backbone", "xception"),
                                         ("model", "int8_training", 64),
                                         ("model", "int8_training_bwd", True),
                                         ("parallel", "remat", True)),
}
SPATIAL_BACKBONES = ("mobilenetv2", "xception")  # their split steps, from seeded weights
QAT = dict(int8_training=64, int8_scale_mode="delayed")  # the QAT step's model
QAT_BWD = dict(QAT, int8_training_bwd=True)  # ... with QAT's int8 backward
# the fused step's model: ResNet-50's stem and bottlenecks through the fused
# functions (their plain versions here), from the seeded weights of build_model
FUSED = dict(backbone="resnet50", fused_stem="always", fused_blocks="always")
RESNET50 = dict(backbone="resnet50")  # ... and unfused, its yardstick


def step_model(case: dict, options: dict):
    """The float32 model of a step case, dropout off: resnet18 with the
    crossed weights of ``case["ckpt"]``, or where ``options`` name another
    backbone (``FUSED``, ``RESNET50``), that model's seeded weights."""
    from iswm_tpu_torch.compat import load_checkpoint
    from iswm_tpu_torch.config import ModelConfig
    from iswm_tpu_torch.models import build_model

    model = build_model(ModelConfig(**{"backbone": "resnet18", "compute_dtype": "float32",
                                       **options}))
    if options.get("backbone", "resnet18") == "resnet18":
        model.load_state_dict(load_checkpoint(case["ckpt"]), strict=True)
    _dropout_off(model)
    return model


@contextlib.contextmanager
def counting_fused_calls(counts: dict):
    """Count the calls of the fused block and the fused stem's train entry
    (which still run) into ``counts["blocks"]`` and ``counts["stem"]``."""
    from iswm_tpu_torch.models import fused_block as mfb
    from iswm_tpu_torch.ops.kernels import fused_stem as fs

    real = mfb.fused_bottleneck_apply, fs.stem_fused_train
    counts.update(blocks=0, stem=0)

    def block(*args):
        counts["blocks"] += 1
        return real[0](*args)

    def stem(*args):
        counts["stem"] += 1
        return real[1](*args)

    mfb.fused_bottleneck_apply, fs.stem_fused_train = block, stem
    try:
        yield counts
    finally:
        mfb.fused_bottleneck_apply, fs.stem_fused_train = real


def _train_step(case: dict, options: dict | None = None, remat: bool = False,
                mesh=None, again: bool = False) -> dict:
    """One data-parallel step of resnet18 from the crossed weights on this
    rank's rows: the sharded CE (plain versions), the cross-replica
    BatchNorm and the summing gradient reduction; with ``options`` (``QAT``,
    ``QAT_BWD``), of that QAT model, its amaxes (and with the int8 backward
    its cotangents' amaxes) taken over both ranks, or (``FUSED``) of
    ResNet-50 through the fused stem and blocks, their BatchNorm sums taken
    over both ranks; with ``remat``, the activations recomputed block by
    block in the backward; with a ``mesh`` of a model axis, the step on this
    rank's image rows of its data index's batch rows, with its halo
    exchanges counted (those of remat's recomputation apart too) and its
    exchanges of row counts; with ``again``, the counts of a second step
    (after ``after`` is taken)."""
    from iswm_tpu_torch.parallel import distributed, shard_batch, spatial
    from iswm_tpu_torch.config import OptimConfig
    from iswm_tpu_torch.models import layers
    from iswm_tpu_torch.ops import int8_train
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from iswm_tpu_torch.train.step import data_parallel

    model = step_model(case, options or {})
    factory, _ = make_optimizer(OptimConfig(), TOTAL)
    state = TrainState(model, *factory(model.parameters()), 0, data_parallel(model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    all_reduces = distributed.cross_replica_all_reduces
    amax_reduces = int8_train.amax_all_reduces
    rows = _rows if mesh is None else (lambda a: shard_batch(mesh, a))
    step = make_train_step(make_loss_fn("ce_loss", fused="interpret"), remat=remat, mesh=mesh)
    batch = (torch.from_numpy(rows(case["images"])), torch.from_numpy(rows(case["labels"])))
    spatial.reset_counts()
    with counting_fused_calls({}) as fused_calls:
        loss = step(state, *batch)
    counts = {"collectives": dict(spatial.collectives), "recomputed": dict(spatial.recomputed),
              "row_exchanges": spatial.row_exchanges}
    out = {"loss": float(loss), "before": before, "fused_calls": fused_calls, **counts,
           "after": {k: v.clone() for k, v in model.state_dict().items()},
           "count": state.step,
           "all_reduces": distributed.cross_replica_all_reduces - all_reduces,
           "amax_all_reduces": int8_train.amax_all_reduces - amax_reduces,
           "amaxes": {k: v.clone() for k, v in layers.quant_state(model).items()},
           "routed": len(layers.routed_sites(model, True)),
           "batchnorms": sum(isinstance(m, layers.BatchNorm2d) for m in model.modules())}
    if again:
        spatial.reset_counts()
        step(state, *batch)
        out["again"] = {"collectives": dict(spatial.collectives),
                        "row_exchanges": spatial.row_exchanges}
    return out


def _int8_bwd_conv(case: dict) -> dict:
    """One int8-backward conv (``int8_conv_fullq``, across the ranks) on this
    rank's rows of ``case``'s x and cotangent g: dx of the rows, dw summed
    over the ranks as the data-parallel step's gradient reduction sums it,
    the amax all-reduces it made."""
    from iswm_tpu_torch.ops import int8_train

    x = torch.from_numpy(_rows(case["x"])).requires_grad_()
    w = torch.from_numpy(case["w"]).requires_grad_()
    reduces = int8_train.amax_all_reduces
    out = int8_train.int8_conv_fullq(x, w, *case["geometry"], across_ranks=True)
    out.backward(torch.from_numpy(_rows(case["g"])))
    dw = w.grad.clone()
    torch.distributed.all_reduce(dw)
    return {"dx": x.grad, "dw": dw, "amax_all_reduces": int8_train.amax_all_reduces - reduces}


KEPT = ("loss", "fused_calls", "all_reduces", "batchnorms", "count", "collectives",
        "recomputed", "row_exchanges", "again", "amaxes", "amax_all_reduces", "routed")


def kept(step: dict, state: bool = True, like: dict | None = None) -> dict:
    """What a rank saves of a step of a large model, or of one of many (a
    ResNet-50 state is 160 MB): the ``KEPT`` numbers it has, whether its
    state after the step equals rank 0's bit for bit (a digest of each
    tensor's bytes, broadcast), and with ``state`` that state on rank 0
    alone; with ``like``, whether it equals that step's instead of the
    state."""
    import hashlib

    import torch.distributed as dist

    digest = [hashlib.sha256(v.reshape(-1).view(torch.uint8).numpy()).hexdigest()
              for v in step["after"].values()]
    lead = [digest]
    dist.broadcast_object_list(lead, src=0)
    out = {**{k: step[k] for k in KEPT if k in step}, "equal_to_rank_0": lead[0] == digest}
    if like is not None:
        return {**out, "equal_to_like": all(torch.equal(v, like["after"][k])
                                            for k, v in step["after"].items())}
    return {**out, "after": step["after"] if state and dist.get_rank() == 0 else None}


def _spatial_backbone(case: dict, backbone: str, mesh) -> dict:
    """The split step of ``backbone`` (seeded weights) and a second step's
    counts (:func:`kept`), and before it the eval-mode forward's logits of
    this rank's image rows under ``spatially_split``."""
    from iswm_tpu_torch.parallel import shard_batch, spatial

    options = {"backbone": backbone}
    model = step_model(case, options).eval()
    images = shard_rows(mesh, torch.from_numpy(shard_batch(mesh, case["images"])), dim=1)
    with torch.no_grad(), spatial.spatially_split(mesh, case["images"].shape[1]):
        logits = model(images.permute(0, 3, 1, 2))
    return {**kept(_train_step(case, options, mesh=mesh, again=True)), "eval_logits": logits}


def int8_bwd_site(case: dict):
    """A QAT conv site with the int8 backward (``layers.QatConv2d``, route
    "st", dynamic scales) of ``case``'s weight and geometry, in train mode."""
    from iswm_tpu_torch.models import layers

    n, c, k, _ = case["w"].shape
    stride, padding, dilation = case["geometry"]
    conv = layers.QatConv2d(c, n, k, route="st", int8_bwd=True, stride=stride,
                            padding=padding, dilation=dilation, bias=False).train()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(case["w"]))
    return conv


def _spatial_int8_bwd_conv(mesh, case: dict) -> dict:
    """:func:`int8_bwd_site` on this rank's rows of ``case``'s x under
    ``spatially_split`` (a halo fetched, the conv run at H padding 0), the
    cotangent's rows of its output: the output and dx rows, dw summed over
    the ranks, the collectives and amax all-reduces it made."""
    from iswm_tpu_torch.ops import int8_train
    from iswm_tpu_torch.parallel import spatial

    conv = int8_bwd_site(case)
    x = torch.from_numpy(shard_rows(mesh, case["x"])).requires_grad_()
    reduces = int8_train.amax_all_reduces
    spatial.reset_counts()
    with spatial.spatially_split(mesh):
        out = conv(x)
    out.backward(torch.from_numpy(shard_rows(mesh, case["g"])))
    dw = conv.weight.grad.clone()
    torch.distributed.all_reduce(dw)
    return {"out": out.detach(), "dx": x.grad, "dw": dw,
            "collectives": dict(spatial.collectives),
            "amax_all_reduces": int8_train.amax_all_reduces - reduces}


def shard_rows(mesh, a, dim: int = 2):
    """This rank's rows of ``a`` along ``dim`` in the split's layout
    (``spatial.shard``: chunks of ceil(H / M), the last shorter)."""
    from iswm_tpu_torch.parallel import spatial

    start, stop = spatial.shard(a.shape[dim], mesh.model, mesh.model_index)
    index = [slice(None)] * a.ndim
    index[dim] = slice(start, stop)
    return a[tuple(index)]


def _fused_steps(case: dict) -> dict:
    """The ``FUSED`` step, its remat step and the ``RESNET50`` step on this
    rank's rows: of the two plain steps what :func:`kept` keeps, and of the
    remat step whether its state equals the fused step's."""
    counts = ("loss", "fused_calls", "all_reduces", "batchnorms", "count")
    step = _train_step(case, FUSED)
    remat = _train_step(case, FUSED, remat=True)
    return {
        "fused_step": kept(step),
        "fused_remat": {**{k: remat[k] for k in counts},
                        "equal_to_fused_step": all(torch.equal(v, step["after"][k])
                                                   for k, v in remat["after"].items())},
        "resnet50_step": kept(_train_step(case, RESNET50)),
    }


def fused_block_module(state: dict):
    """ResNet-50's ``layer1.0`` (64 -> 256 channels, with its downsample) in
    training mode through the fused path, BatchNorm momentum flax's 0.9,
    with the weights and statistics of ``state``."""
    from iswm_tpu_torch.models.resnet import Bottleneck

    block = Bottleneck(64, 64, downsample=True, fused_mode="always").train()
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1
    block.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return block


def _fused_block(case: dict) -> dict:
    """The fused block on this rank's rows of x [B, 64, H, W] and of the
    output's cotangent: output and dx rows, this rank's parameter gradients,
    the running statistics and the all-reduces it made."""
    from iswm_tpu_torch.parallel import distributed

    block = fused_block_module(case["state"])
    x = torch.from_numpy(_rows(case["x"])).requires_grad_()
    before = distributed.cross_replica_all_reduces
    with counting_fused_calls({}) as calls:
        out = block(x)
    out.backward(torch.from_numpy(_rows(case["g"])))
    return {"out": out.detach(), "dx": x.grad, "calls": calls,
            "grads": {k: p.grad.clone() for k, p in block.named_parameters()},
            "buffers": {k: b.clone() for k, b in block.named_buffers()},
            "all_reduces": distributed.cross_replica_all_reduces - before}


def fused_stem_call(case: dict, rows) -> dict:
    """``stem_fused_train`` on ``rows`` of the image [B, 3, 2S, 2S] with the
    cotangent's rows of the pooled output: p, the batch statistics and the
    gradients of the conv weight, gamma and beta (this process's)."""
    from iswm_tpu_torch.ops.kernels import fused_stem as fs

    leaves = [torch.from_numpy(case[k]).requires_grad_() for k in ("weight", "gamma", "beta")]
    p, mean, var = fs.stem_fused_train(torch.from_numpy(rows(case["image"])), *leaves, 1e-5)
    (p * torch.from_numpy(rows(case["w"]))).sum().backward()
    return {"p": p.detach(), "mean": mean, "var": var,
            **{f"d{k}": t.grad for k, t in zip(("weight", "gamma", "beta"), leaves)}}


def _fused_stem(case: dict) -> dict:
    from iswm_tpu_torch.parallel import distributed

    before = distributed.cross_replica_all_reduces
    out = fused_stem_call(case, _rows)
    return {**out, "all_reduces": distributed.cross_replica_all_reduces - before}


def _spatial_mesh_checks(mesh) -> dict:
    """A data 1 x model 2 mesh: its indices, the model group, the batch rows
    (the whole batch on both ranks) and the image rows."""
    import torch.distributed as dist

    from iswm_tpu_torch.parallel import shard_batch, spatial_rows

    x = np.arange(8 * 3).reshape(8, 3)
    images = np.arange(2 * 6 * 5).reshape(2, 6, 5)
    ones = torch.ones(1)
    dist.all_reduce(ones, group=mesh.group)
    return {"shape": mesh.shape, "indices": (mesh.data_index, mesh.model_index),
            "group_size": dist.get_world_size(mesh.group), "group_sum": float(ones),
            "sx": shard_batch(mesh, x), "rows": spatial_rows(mesh, images),
            "odd_rows": _raised(lambda: spatial_rows(mesh, images[:, :5]))}


def halo_op(case: dict):
    """(fn(x, model_axis), parameters) of a halo case: ``fn`` runs the
    port's module on rows ``x`` of an image split over ``model_axis`` ranks
    (1: the whole image, one process)."""
    from iswm_tpu_torch.models import layers
    from iswm_tpu_torch.models.deeplab import ASPPPooling
    from iswm_tpu_torch.ops.resize import resize_bilinear
    from iswm_tpu_torch.parallel import spatial

    kind = case["kind"]
    if kind == "conv":
        module = layers.Conv2d(**case["conv"], bias=False)
    elif kind == "pool":
        module = layers.MaxPool2d(3, 2, 1)
    elif kind == "pooling":
        module = ASPPPooling(*case["channels"]).train()
    else:
        out_h, out_w = case["size"]

        def share() -> int:  # this rank's rows of the output
            split = spatial.current()
            start, stop = ((0, out_h) if split is None else
                           spatial.shard(out_h, split.size, split.index))
            return stop - start

        return (lambda x, m: resize_bilinear(x, (share(), out_w))), {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(case["params"][name]))
    if kind == "pooling":  # broadcast over the rows, as the ASPP does
        return (lambda x, m: module(x).expand(-1, -1, x.shape[2], x.shape[3])), \
            dict(module.named_parameters())
    return (lambda x, m: module(x)), dict(module.named_parameters())


def _halo(mesh, case: dict) -> dict:
    """A halo case on this rank's rows (``shard_rows``: of an odd height,
    uneven) under ``spatially_split``: y and dx of the rows, this rank's
    parameter gradients, the collectives and exchanges of row counts made."""
    from iswm_tpu_torch.parallel import spatial

    fn, params = halo_op(case)
    x = shard_rows(mesh, torch.from_numpy(case["x"])).clone().requires_grad_()
    spatial.reset_counts()
    with spatial.spatially_split(mesh):
        y = fn(x, mesh.model)
    y.backward(shard_rows(mesh, torch.from_numpy(case["dy"])))
    return {"y": y.detach(), "dx": x.grad, "collectives": dict(spatial.collectives),
            "row_exchanges": spatial.row_exchanges,
            "grads": {k: p.grad.clone() for k, p in params.items()}}


def standin_fn(x):
    """The tile engine's stand-in model: [N, T, T, C] -> [N, T, T, 2]."""
    k = x.mean(dim=-1, keepdim=True)
    return torch.cat([k, -k], dim=-1)


def int8_serving_fn(x0: np.ndarray):
    """resnet18 (float32, seeded weights) served ``int8_exec_xla``, calibrated
    wide on the [1, T, T, 3] image ``x0``."""
    from iswm_tpu_torch.config import ModelConfig
    from iswm_tpu_torch.infer.quantization import calibrate_conv_inputs, make_variant_fn
    from iswm_tpu_torch.models import build_model

    model = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32"))
    scales = calibrate_conv_inputs(model, [torch.from_numpy(x0).permute(0, 3, 1, 2)],
                                   wide=True)
    return make_variant_fn(model, "int8_exec_xla", conv_scales=scales)


def _tile_engines(case: dict) -> dict:
    """The scene-parallel engine (every rank on the data axis, batch 1 a
    rank) on the stand-in model and on ``int8_exec_xla``."""
    from iswm_tpu_torch.infer.tiling import TileEngine
    from iswm_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    fn = int8_serving_fn(case["x0"])
    return {
        "standin": TileEngine(standin_fn, tile=128, overlap=32, batch=1, mesh=mesh)
        .infer_scene(torch.from_numpy(case["scene"])),
        "int8": TileEngine(fn, tile=32, overlap=8, batch=1, mesh=mesh)
        .infer_scene(torch.from_numpy(case["int8_scene"])),
        "routed": len(fn.routed_sites)}


def _dryrun() -> dict:
    """The dry run's body at model 2 (resnet18, crop 32) on the CPU."""
    from iswm_tpu_torch.parallel.dryrun import dryrun_body

    return dryrun_body("resnet18", 32, model_axis=2, device="cpu")


def _refusals(root: str) -> dict:
    """What builds at world size 2 and what is refused; the Trainers of
    ``SPATIAL_ACCEPTED`` (crop 48, data under ``root``) with what each
    built: its backbone's class, its QAT sites, remat and the mesh."""
    from iswm_tpu_torch.config import Config, ModelConfig
    from iswm_tpu_torch.data import ArrayDataset, generate_scene
    from iswm_tpu_torch.models import build_model, layers
    from iswm_tpu_torch.train import Trainer

    def model(**fused):
        cfg = ModelConfig(backbone="resnet50", compute_dtype="float32")
        for k, v in fused.items():
            setattr(cfg, k, v)
        return build_model(cfg)

    def trainer(section, key, value, model_axis=1):
        cfg = Config()
        cfg.parallel.model_axis = model_axis
        setattr(getattr(cfg, section), key, value)
        return Trainer(cfg, device="cpu")

    def modes(**fused):
        backbone = model(**fused).backbone
        return backbone.fused_stem, backbone.layer1[0].fused_mode

    rng = np.random.default_rng(1)
    images, masks = zip(*(generate_scene(rng, size=(48, 48)) for _ in range(2)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))

    def accepted(name, fields):
        cfg = Config()
        cfg.parallel.model_axis = 2
        cfg.model.backbone, cfg.model.compute_dtype = "resnet18", "float32"
        cfg.data.crop_size, cfg.data.batch_size = 48, 2
        for section, key, value in fields:
            setattr(getattr(cfg, section), key, value)
        for key in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
            setattr(cfg.train, key, os.path.join(root, name, key))
        t = Trainer(cfg, device="cpu", train_ds=dataset, val_ds=dataset)
        return {"backbone": type(t.state.model.backbone).__name__, "mesh": t.mesh.shape,
                "int8_bwd": any(getattr(m, "int8_bwd", False) for m in t.state.model.modules()),
                "routed": len(layers.routed_sites(t.state.model, True)),
                "remat": t.cfg.parallel.remat}

    return {
        "auto": modes(fused_stem="auto", fused_blocks="auto"),
        **{f"{k}={v}": modes(**{k: v})
           for k in ("fused_stem", "fused_blocks") for v in ("always", "interpret")},
        **{f"spatial {k}={v!r}": _raised(lambda s=s, k=k, v=v: trainer(s, k, v, model_axis=2))
           for s, k, v in SPATIAL_REFUSED},
        **{f"spatial {name}": accepted(name, fields) for name, fields in SPATIAL_ACCEPTED.items()},
        "spatial crop": _raised(lambda: trainer("data", "crop_size", 30, model_axis=2)),
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
