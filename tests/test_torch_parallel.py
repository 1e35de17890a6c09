"""The port's data-parallel training against the JAX package's, on the CPU.

Two ranks of a ``gloo`` group (``tests/_torch_dist.py``, spawned once for the
module, while the JAX side runs here) against the JAX package on two of the
eight virtual CPU devices, ``Mesh(jax.devices()[:2], ("data",))``:

- (a) ``make_mesh``, ``shard_batch``, ``process_local_batch_slice`` and their
  errors, as ``tests/test_parallel.py`` holds the JAX ones;
- (b) the sharded CE, its plain version and ``make_sharded_fused_ce``:
  loss and the concatenated d_logits equal the single-process
  ``fused_binary_ce`` on the whole batch (1e-6) and the JAX
  ``make_sharded_fused_ce`` in Pallas interpret mode with ``jax.grad``
  (1e-5);
- (c) the cross-replica ``BatchNorm2d``: output, running statistics and the
  gradients of x, weight and bias (the ranks' shares summed) equal flax
  ``nn.BatchNorm`` on the whole batch (1e-5), at local batches of 2 and 1;
- (d) one 2-rank train step of resnet18 (OS 16, float32, 32x32, global batch
  8, no augmentation, dropout off, the fused CE's plain version) from the
  crossed weights of ``tests/test_torch_train_step.py``, against the JAX
  ``make_train_step`` with ``make_loss_fn(mesh=...)`` on the 2-device mesh, at
  that file's tolerances (loss 1e-5 relative, statistics 1e-5, each update
  1e-3 * max + one ulp) on its batch seed 1, which has no flipped decision
  here either; both ranks end with equal parameters; the same step of the
  delayed-mode QAT model (gate 64) against the one-process QAT step on the
  whole batch at those tolerances, its new amaxes within 1e-6 relative (a
  max over both ranks' rows, one all-reduce a routed site, the same on both
  ranks; a rank's own rows give other amaxes); with QAT's int8 backward
  (the cotangents' amaxes all-reduced too) the same loss and amaxes, and one
  int8-backward conv on the two ranks against one process: dx bit-equal, dw
  within 1.5 float32 ulps; the remat step (``remat=True``) equal to the
  2-rank plain step bit for bit and to the one-process remat step at the
  step tolerances;
- (d') the fused stem and blocks on the two ranks, their BatchNorm sums
  all-reduced: ResNet-50's ``layer1.0`` (with its downsample, float32,
  global batch 4 at 8x8, 2 + 2 rows) and the fused stem (global batch 4 at
  16x16) against the JAX package's ``Bottleneck(fused_mode="interpret")`` /
  ``stem_fused_train`` in Pallas interpret mode on the whole batch and
  against the port's one-process fused functions: output rows, running
  statistics, the input gradient and the ranks' parameter gradients summed
  (the stem's dgamma and dbeta are each rank's share: their sum is the
  one-process value, not twice it); one step of deeplabv3plus_resnet50
  (seeded weights, (d)'s batch) with ``fused_stem`` / ``fused_blocks`` =
  ``always`` against the one-process fused step, two all-reduces a
  BatchNorm (fused or not), and its remat step bit-equal to it with three;
  the same step unfused against the one-process unfused step, held the same
  way (a chaotic step: (d)'s tolerances or five times the distance of a
  one-process step whose stem output moved by an ulp);
- (e) at world size 2: the fused stem and blocks build under ``always`` /
  ``interpret``; ``auto`` resolves to ``never``; under ``model_axis = 2`` the
  options still refused (the fused modes: ROADMAP.md Queue 1, 'Spatial model
  axis: remaining options'), a Trainer for each option once refused there
  (MobileNetV2, Xception, QAT with and without its int8 backward, remat) and
  a crop size below ``output_stride * model_axis``; ``data_axis`` other than
  the world size and a batch that does not divide;
- (f) ``Trainer.fit`` of 2 steps and a validation on the two ranks: equal
  parameters on both, one checkpoint, written by rank 0;

and the spatial model axis, the two ranks one model group (data 1 x model 2):

- (g) ``make_mesh(1, 2)``: the indices, the model group, ``shard_batch``
  giving both ranks the whole batch and ``spatial_rows`` each its rows;
- (h) every operator that reads across a row boundary, on each rank's rows
  under ``spatially_split`` against the one-process op on the whole image:
  the output and the input gradient (rows concatenated) and the parameter
  gradients (summed over the ranks) within 1e-6 of their largest element;
- (h') the same for uneven shards (an odd height split ceil(H / 2) + the
  rest, as Xception's maps are), also against the JAX package's op;
- (i) one data 1 x model 2 step of (d)'s resnet18, each rank on 16 of the 32
  rows of all 8 images, against the JAX 2-device step at (d)'s tolerances,
  bit-equal parameters on both ranks;
- (i') under the split: the remat step bit-equal to (i)'s; the QAT step
  against the one-process QAT step at (d)'s tolerances, amaxes within
  1e-6; with the int8 backward the loss and amaxes, and one strided site
  with a halo against one process (dx bit-equal but on the borrowed row, it
  and dw within 1.5 ulps); MobileNetV2's and Xception's steps (seeded
  weights; Xception's maps uneven) against one process, the eval logits
  under the split within 1e-5 and the step as ``_held_step`` holds a chaotic
  one; a second step exchanges no row counts;
- (j) the scene-parallel ``TileEngine(mesh=)`` (batch 1 a rank) against the
  port's one-rank engine (batch 2) on ``tests/test_infer.py``'s stand-in
  model (1e-5) and resnet18 ``int8_exec_xla`` (1e-4);
- (k) the dry run's body (``parallel/dryrun.py``) at model 2, resnet18, crop 32.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.models.layers import BatchNorm2d
from iswm_tpu_torch.ops.kernels.fused_ce import fused_binary_ce
from iswm_tpu_torch.parallel import (
    make_mesh,
    maybe_initialize_distributed,
    process_local_batch_slice,
    shard_batch,
    world_size,
)

from ._torch_dist import TOTAL, WORLD, join_ranks, start_ranks
from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)
from .test_torch_fused_block import _close
from .test_torch_models import crossed_models
from .test_torch_train import _no_dropout
from .test_torch_train_step import _batch, _check_step

STEP_BATCH = 1  # the batch seed of tests/test_torch_train_step.py's first step


def _ce_cases():
    """(logits [B, 2, H, W], labels, class weights): class weights, a ragged
    size, and rank 1's rows all ignored."""
    rng = np.random.default_rng(5)
    cases = []
    for shape, cw, ignored_shard in (((4, 16, 16), (1.0, 3.2), False),
                                     ((2, 17, 21), (1.0, 1.0), False),
                                     ((4, 9, 13), (1.0, 2.0), True)):
        b, h, w = shape
        logits = (3 * rng.normal(size=(b, 2, h, w))).astype(np.float32)
        labels = (rng.random((b, h, w)) < 0.3).astype(np.int64)
        labels[rng.random((b, h, w)) < 0.05] = 255
        if ignored_shard:
            labels[b // 2:] = 255
        cases.append({"logits": logits, "labels": labels,
                      "cw": np.asarray(cw, np.float32)})
    return cases


def _bn_cases():
    """x [B, C, H, W] with local batches of 2 and 1 per rank (the last as the
    ASPP pooling branch at global batch 2: one value per channel a rank)."""
    rng = np.random.default_rng(6)
    cases = []
    for shape in ((4, 5, 6, 7), (2, 5, 3, 3), (2, 5, 1, 1)):
        c = shape[1]
        cases.append({
            "x": (0.5 + 2 * rng.normal(size=shape)).astype(np.float32),
            "dy": rng.normal(size=shape).astype(np.float32),
            "weight": (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32),
        })
    return cases


def _halo_cases():
    """The halo cases (h): x [B, C, H, W], a cotangent of the op's output and
    the op's parameters, from one seed."""
    rng = np.random.default_rng(8)

    def conv(name, shape, out, k, stride=1, dilation=1, groups=1, pad=None):
        c, pad = shape[1], (k // 2) * dilation if pad is None else pad
        spec = dict(in_channels=c, out_channels=out, kernel_size=k, stride=stride,
                    padding=pad, dilation=dilation, groups=groups)
        h_out = (shape[2] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
        w_out = (shape[3] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
        return {"name": name, "kind": "conv", "conv": spec,
                "x": rng.normal(size=shape).astype(np.float32),
                "dy": rng.normal(size=(shape[0], out, h_out, w_out)).astype(np.float32),
                "params": {"weight": (rng.normal(size=(out, c // groups, k, k))
                                      / np.sqrt(k * k * c / groups)).astype(np.float32)}}

    cases = [conv("stem-7x7-s2", (2, 3, 16, 12), 8, 7, stride=2),
             conv("3x3-s2", (2, 4, 8, 6), 6, 3, stride=2),
             conv("dilated-3x3-d2", (2, 4, 8, 6), 6, 3, dilation=2),
             conv("dilated-3x3-d4", (2, 4, 8, 6), 6, 3, dilation=4)]
    for rows in (2, 4):  # a halo past the neighbour: rows of zeros beyond it
        cases += [conv(f"aspp-d{d}-{rows}-rows", (2, 4, rows, 5), 6, 3, dilation=d)
                  for d in (6, 12, 18)]
    cases.append(conv("depthwise-3x3", (2, 4, 8, 6), 4, 3, groups=4))
    cases.append({"name": "max-pool", "kind": "pool",
                  "x": rng.normal(size=(2, 4, 8, 6)).astype(np.float32),
                  "dy": rng.normal(size=(2, 4, 4, 3)).astype(np.float32)})
    cases.append({"name": "aspp-pooling", "kind": "pooling", "channels": (4, 6),
                  "x": (1 + rng.normal(size=(4, 4, 8, 6))).astype(np.float32),
                  "dy": rng.normal(size=(4, 6, 8, 6)).astype(np.float32),
                  "params": {"1.weight": (0.5 * rng.normal(size=(6, 4, 1, 1))).astype(np.float32),
                             "2.weight": (1 + 0.2 * rng.normal(size=6)).astype(np.float32),
                             "2.bias": (0.1 * rng.normal(size=6)).astype(np.float32)}})
    for name, shape, size in (("resize-decoder", (2, 3, 2, 2), (8, 8)),
                              ("resize-output", (2, 2, 8, 8), (32, 32))):
        cases.append({"name": name, "kind": "resize", "size": size,
                      "x": rng.normal(size=shape).astype(np.float32),
                      "dy": rng.normal(size=(*shape[:2], *size)).astype(np.float32)})
    # uneven shards (ceil(H / 2) rows on rank 0, the rest on rank 1), as
    # Xception's maps split: its VALID stem (15 -> 7 rows), a separable conv's
    # depthwise 3x3 and a strided block's pool at 13 rows, the decoder's
    # resize to an odd height
    rng = np.random.default_rng(18)
    cases += [conv("uneven-valid-3x3-s2", (2, 4, 15, 10), 6, 3, stride=2, pad=0),
              conv("uneven-depthwise-3x3", (2, 4, 13, 6), 4, 3, groups=4)]
    cases.append({"name": "uneven-block-pool", "kind": "pool",
                  "x": rng.normal(size=(2, 4, 13, 6)).astype(np.float32),
                  "dy": rng.normal(size=(2, 4, 7, 3)).astype(np.float32)})
    cases.append({"name": "uneven-resize-odd", "kind": "resize", "size": (7, 9),
                  "x": rng.normal(size=(2, 3, 4, 5)).astype(np.float32),
                  "dy": rng.normal(size=(2, 3, 7, 9)).astype(np.float32)})
    return cases


HALO_NAMES = [case["name"] for case in _halo_cases()]


def _jax_halo(case) -> dict:
    """An uneven halo case's op on the whole image in the JAX package (NHWC):
    ``lax.conv_general_dilated`` (what its ``nn.Conv`` runs), its
    ``max_pool_torch`` or ``resize_bilinear``, with ``jax.vjp``; y, dx and
    the weight's gradient in the port's layouts."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.layers import max_pool_torch
    from iswm_tpu.ops.resize import resize_bilinear

    x = jnp.asarray(np.transpose(case["x"], (0, 2, 3, 1)))
    dy = jnp.asarray(np.transpose(case["dy"], (0, 2, 3, 1)))
    if case["kind"] == "conv":
        spec = case["conv"]
        s, p, d = spec["stride"], spec["padding"], spec["dilation"]
        w = jnp.asarray(np.transpose(case["params"]["weight"], (2, 3, 1, 0)))

        def fn(x, w):
            return jax.lax.conv_general_dilated(
                x, w, (s, s), [(p, p), (p, p)], rhs_dilation=(d, d),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=spec["groups"])

        y, vjp = jax.vjp(fn, x, w)
        dx, dw = vjp(dy)
        grads = {"weight": torch.from_numpy(np.transpose(np.asarray(dw), (3, 2, 0, 1)).copy())}
    else:
        y, vjp = jax.vjp((lambda x: max_pool_torch(x, 3, 2, 1)) if case["kind"] == "pool"
                         else (lambda x: resize_bilinear(x, case["size"])), x)
        (dx,), grads = vjp(dy), {}
    return {"y": torch.from_numpy(_nchw(y)), "dx": torch.from_numpy(_nchw(dx)), **grads}


def _tiles_case():
    """(j): the stand-in model's 300x280 scene, and int8_exec_xla's
    calibration image and 72x64 scene (tests/test_infer.py's seeds)."""
    return {"scene": np.random.default_rng(0).random((300, 280, 3)).astype(np.float32),
            "x0": np.random.default_rng(5).normal(size=(1, 32, 32, 3)).astype(np.float32),
            "int8_scene": np.random.default_rng(6).normal(size=(72, 64, 3)).astype(np.float32)}


def _jax_sharded_ce(mesh, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from iswm_tpu.ops.pallas.fused_ce import make_sharded_fused_ce

    loss_fn = make_sharded_fused_ce(mesh, ignore_index=255, interpret=True)
    rows = NamedSharding(mesh, P("data"))
    logits = jax.device_put(np.transpose(case["logits"], (0, 2, 3, 1)), rows)
    labels = jax.device_put(case["labels"].astype(np.int32), rows)
    cw = jnp.asarray(case["cw"])
    loss, grad = jax.jit(jax.value_and_grad(lambda lg: loss_fn(lg, labels, cw)))(logits)
    return float(loss), np.transpose(np.asarray(grad), (0, 3, 1, 2))


def _flax_batchnorm(case):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) in train mode on the
    whole batch: y, running mean and var, dx, dweight, dbias in NCHW."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    c = case["x"].shape[1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    params = {"scale": jnp.asarray(case["weight"]), "bias": jnp.asarray(case["bias"])}
    x = jnp.asarray(np.transpose(case["x"], (0, 2, 3, 1)))

    def apply(x, params):
        return bn.apply({"params": params, "batch_stats": stats}, x,
                        mutable=["batch_stats"])

    y, updated = apply(x, params)
    _, vjp = jax.vjp(lambda x, p: apply(x, p)[0], x, params)
    dx, dparams = vjp(jnp.asarray(np.transpose(case["dy"], (0, 2, 3, 1))))
    nchw = (0, 3, 1, 2)
    return {"y": np.transpose(np.asarray(y), nchw),
            "mean": np.asarray(updated["batch_stats"]["mean"]),
            "var": np.asarray(updated["batch_stats"]["var"]),
            "dx": np.transpose(np.asarray(dx), nchw),
            "dweight": np.asarray(dparams["scale"]), "dbias": np.asarray(dparams["bias"])}


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _fused_block_case():
    """(d'): the payload of ResNet-50's ``layer1.0`` (x post-ReLU [4, 64, 8,
    8], the output's cotangent, the JAX block's perturbed weights and
    statistics in the port's keys) and the JAX block with its trees."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.resnet import Bottleneck as JaxBottleneck

    from .test_torch_fused_block import _block_state_from_jax

    rng = np.random.default_rng(9)
    x = np.abs(rng.normal(size=(4, 8, 8, 64))).astype(np.float32)
    g = rng.normal(size=(4, 8, 8, 256)).astype(np.float32)
    jblock = JaxBottleneck(planes=64, downsample=True, fused_mode="interpret",
                           dtype=jnp.float32)
    shapes = jax.eval_shape(  # the trees' layout, without running an init
        lambda: jblock.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False))

    def leaf(path, sd):  # He-normal kernels; scale, bias, mean, var near identity
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            return (rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(
                np.float32)
        if name == "var":
            return (0.5 + rng.random(shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.2 * rng.normal(size=shape)).astype(np.float32)

    params, stats = (jax.tree_util.tree_map_with_path(leaf, shapes[k])
                     for k in ("params", "batch_stats"))
    state = {k: t.numpy() for k, t in _block_state_from_jax(params, stats, True).items()}
    return {"x": _nchw(x), "g": _nchw(g), "state": state}, (jblock, params, stats)


def _jax_fused_block(case, jblock, params, stats) -> dict:
    """The JAX fused block on the whole batch (interpret mode): output, dx,
    the parameter gradients and the statistics after, in the port's keys."""
    import jax
    import jax.numpy as jnp

    from .test_torch_fused_block import _block_state_from_jax

    x = jnp.asarray(np.transpose(case["x"], (0, 2, 3, 1)))
    g = jnp.asarray(np.transpose(case["g"], (0, 2, 3, 1)))

    def loss(params, x):
        out, mut = jblock.apply({"params": params, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    (_, (out, new_stats)), (dparams, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    grads = _block_state_from_jax(jax.device_get(dparams), jax.device_get(new_stats), True)
    after = _block_state_from_jax(jax.device_get(params), jax.device_get(new_stats), True)
    return {"out": _nchw(out), "dx": _nchw(dx),
            "grads": {k: v.numpy() for k, v in grads.items()
                      if k.endswith(("weight", "bias"))},
            "buffers": {k: v.numpy() for k, v in after.items() if "running_" in k}}


def _fused_stem_case():
    """(d'): the stem's image [4, 3, 16, 16], conv weight, BatchNorm affine
    and the pooled output's cotangent, NCHW / OIHW, and the same NHWC / HWIO
    for the JAX side."""
    from .test_torch_fused_stem import _inputs

    image, kernel, gamma, beta, w = _inputs(8, b=4, seed=3)
    case = {"image": _nchw(image), "w": _nchw(w), "gamma": gamma, "beta": beta,
            "weight": np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))}
    return case, (image, kernel, gamma, beta, w)


def _jax_fused_stem(image, kernel, gamma, beta, w) -> dict:
    """The JAX fused stem (``stem_stats``, ``stem_norm_relu_pool`` and
    ``stem_tail_bwd`` in interpret mode, through the packed conv) on the
    whole batch: p, the statistics and the three gradients."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.layers import pack_stem_kernel
    from iswm_tpu.ops.pallas.fused_stem import stem_fused_train

    from .test_torch_fused_stem import _jax_packed

    xp_pad, _ = _jax_packed(image, kernel)

    def loss(kernel, gamma, beta):
        p, mean, var = stem_fused_train(xp_pad, pack_stem_kernel(kernel, 7), gamma, beta,
                                        1e-5, True)
        return jnp.sum(p * w), (p, mean, var)

    (_, (p, mean, var)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(gamma), jnp.asarray(beta))
    return {"p": _nchw(p), "mean": np.asarray(mean), "var": np.asarray(var),
            "dweight": np.transpose(np.asarray(grads[0]), (3, 2, 0, 1)),
            "dgamma": np.asarray(grads[1]), "dbeta": np.asarray(grads[2])}


def _jax_step(mesh, jmodel, variables, images, labels):
    """The JAX package's train step on the 2-device mesh: batch sharded over
    ``data``, the sharded fused CE in interpret mode; (loss, state after)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from iswm_tpu.config import OptimConfig
    from iswm_tpu.ops.losses import make_loss_fn
    from iswm_tpu.train.optim import make_optimizer
    from iswm_tpu.train.step import TrainState, make_train_step

    tx, _ = make_optimizer(OptimConfig(), TOTAL)
    loss_fn = make_loss_fn("ce_loss", fused="interpret", mesh=mesh)
    step = make_train_step(jmodel, tx, loss_fn, augment=None, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    rows = NamedSharding(mesh, P("data"))
    state, metrics = step(state, jax.device_put(images, rows),
                          jax.device_put(labels, rows), jax.random.key(0))
    return float(metrics["loss"]), jax.device_get(state)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the two ranks saw, and the JAX package's answers to the same
    inputs (computed here while the ranks run)."""
    import jax
    from jax.sharding import Mesh

    from iswm_tpu_torch.compat import state_dict_from_jax

    root = tmp_path_factory.mktemp("dist")
    jmodel, variables, _, ckpt = crossed_models(root, "resnet18", 16)
    images, labels = _batch(STEP_BATCH)
    block_case, jax_block = _fused_block_case()
    stem_case, stem_inputs = _fused_stem_case()
    payload = {"ce_cases": _ce_cases(), "bn_cases": _bn_cases(),
               "step": {"ckpt": ckpt, "images": images, "labels": labels},
               "int8_bwd_conv": _int8_bwd_conv_case(),
               "spatial_int8_bwd_conv": _spatial_int8_bwd_conv_case(),
               "fused_block": block_case, "fused_stem": stem_case,
               "fit_dir": str(root / "fit"),
               "halo_cases": _halo_cases(), "tiles": _tiles_case()}
    torch.save(payload, root / "payload.pt")
    context = start_ranks(str(root / "payload.pt"), str(root))

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    jax_ce = [_jax_sharded_ce(mesh, case) for case in payload["ce_cases"]]
    flax_bn = [_flax_batchnorm(case) for case in payload["bn_cases"]]
    jax_fused = {"block": _jax_fused_block(block_case, *jax_block),
                 "stem": _jax_fused_stem(*stem_inputs)}
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp, torch.nn.Module())
        jax_loss, jax_state = _jax_step(mesh, jmodel, variables, images, labels)
    sds = [state_dict_from_jax(variables["params"], variables["batch_stats"],
                               backbone="resnet18"),
           state_dict_from_jax(jax_state.params, jax_state.batch_stats, backbone="resnet18")]
    seen = join_ranks(context, str(root), timeout=300)
    return {"payload": payload, "seen": seen, "jax_ce": jax_ce, "flax_bn": flax_bn,
            "jax_step": ([jax_loss], sds), "jax_fused": jax_fused}


# ------------------------------------------------------------- (a) the mesh
def test_mesh_and_batch_slices_on_two_ranks(ranks):
    for r, seen in enumerate(ranks["seen"]):
        m = seen["mesh"]
        assert (m["rank"], m["world"]) == (r, WORLD)
        assert m["shape"] == m["mesh_2"] == {"data": 2, "model": 1}
        np.testing.assert_array_equal(m["sx"], np.arange(24).reshape(8, 3)[4 * r:4 * r + 4])
        assert m["sy"].tolist() == list(range(4 * r, 4 * r + 4))
        assert m["local"] == 4
        assert m["not_divisible"] == ("ValueError", "global batch 3 not divisible by 2 processes")
        assert m["odd_batch"][0] == "ValueError"
        assert m["model_3"] == ("ValueError", "model_axis 3 must divide device count 2")
        assert m["data_3"] == ("ValueError", "data_axis*model_axis (3*1) != devices (2)")
        assert m["model_2"] == {"data": 1, "model": 2}  # the spatial model axis


def test_one_process_is_a_mesh_of_one(monkeypatch):
    """Without a group: nothing configured keeps the process alone, a partial
    configuration raises, and the mesh and slices are those of one device."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_initialize_distributed() is False and world_size() == 1
    with pytest.raises(ValueError, match="a rank and a world size"):
        maybe_initialize_distributed(rank=0)
    assert make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(model_axis=3)
    with pytest.raises(ValueError, match=r"\(2\*1\) != devices \(1\)"):
        make_mesh(data_axis=2)
    x = np.arange(6)
    np.testing.assert_array_equal(shard_batch(make_mesh(), x), x)
    assert process_local_batch_slice(6) == 6


# ----------------------------------------------------------- (b) sharded CE
@pytest.mark.parametrize("case", range(3), ids=["class-weights", "ragged", "ignored-shard"])
def test_sharded_ce_matches_one_process_and_jax(ranks, case):
    inputs = ranks["payload"]["ce_cases"][case]
    logits = torch.from_numpy(inputs["logits"]).requires_grad_()
    want = fused_binary_ce(logits, torch.from_numpy(inputs["labels"]),
                           torch.from_numpy(inputs["cw"]))
    want.backward()
    want = want.item()
    jax_loss, jax_grad = ranks["jax_ce"][case]
    for name in ("plain", "wrapper"):
        losses = [seen["ce"][case][name][0] for seen in ranks["seen"]]
        d_logits = np.concatenate([seen["ce"][case][name][1] for seen in ranks["seen"]])
        assert losses[0] == losses[1]  # the global loss on every rank
        np.testing.assert_allclose(losses[0], want, rtol=1e-6)
        np.testing.assert_allclose(d_logits, logits.grad.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(logits.grad.numpy()).max())
        np.testing.assert_allclose(losses[0], jax_loss, rtol=1e-5)
        np.testing.assert_allclose(d_logits, jax_grad, rtol=0,
                                   atol=1e-5 * np.abs(jax_grad).max())
    if case == 2:  # rank 1 holds no valid pixel
        assert not ranks["seen"][1]["ce"][case]["plain"][1].any()


# ------------------------------------------------------ (c) cross-replica BN
@pytest.mark.parametrize("case", range(3), ids=["local-batch-2", "local-batch-1",
                                                "one-value-a-rank"])
def test_cross_replica_batchnorm_matches_flax(ranks, case):
    want = ranks["flax_bn"][case]
    seen = [s["bn"][case] for s in ranks["seen"]]
    got = {
        "y": np.concatenate([s["y"] for s in seen]),
        "dx": np.concatenate([s["dx"] for s in seen]),
        "dweight": seen[0]["dweight"] + seen[1]["dweight"],  # the gradient reduction
        "dbias": seen[0]["dbias"] + seen[1]["dbias"],
        "mean": seen[0]["mean"], "var": seen[0]["var"],
    }
    for s in seen:
        np.testing.assert_array_equal(s["mean"], seen[0]["mean"])
        np.testing.assert_array_equal(s["var"], seen[0]["var"])
        assert s["all_reduces"] == 2  # one forward, one backward
    # dx is a difference of terms of the size of weight * rsqrt(var) * dy, which
    # cancel exactly at two values a channel (the output is then +-weight + bias
    # whatever x): it is held at 1e-5 of that size
    inputs = ranks["payload"]["bn_cases"][case]
    var = inputs["x"].astype(np.float64).var(axis=(0, 2, 3))
    terms = np.abs(inputs["weight"] / np.sqrt(var + 1e-5)).max() * np.abs(inputs["dy"]).max()
    for k, v in want.items():
        scale = max(np.abs(v).max(), terms) if k == "dx" else np.abs(v).max()
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


def test_batchnorm_without_a_group_keeps_its_path():
    """No group: the one-process train-mode path, not the cross-replica one."""
    from iswm_tpu_torch.parallel import distributed

    before = distributed.cross_replica_all_reduces
    BatchNorm2d(3).train()(torch.randn(2, 3, 4, 4))
    assert distributed.cross_replica_all_reduces == before


# ------------------------------------------------------ (d) one train step
def test_two_rank_train_step_matches_jax_two_device_step(ranks):
    jax_losses, sds = ranks["jax_step"]
    steps = [seen["step"] for seen in ranks["seen"]]
    for s in steps:
        assert s["all_reduces"] == 2 * s["batchnorms"]  # each BN forward and backward
        assert s["loss"] == steps[0]["loss"]
    for k, v in steps[0]["after"].items():
        assert torch.equal(v, steps[1]["after"][k]), k
    port = [(steps[0]["loss"], steps[0]["before"], steps[0]["after"], steps[0]["count"])]
    _check_step((jax_losses, sds, port), 0)


def test_two_rank_qat_step_matches_one_process_step(ranks):
    """QAT's activation amaxes are taken over the global batch (an all-reduce
    with MAX a routed site): the 2-rank step is the one-process step."""
    from ._torch_dist import QAT

    case = ranks["payload"]["step"]
    steps = [seen["qat"] for seen in ranks["seen"]]
    for s in steps:
        assert s["amax_all_reduces"] == s["routed"] > 20
    _same_on_both_ranks(steps)
    loss, before, after, amaxes = _one_process_step(case, QAT, slice(None))
    assert set(amaxes) == set(steps[0]["amaxes"])
    for k, v in amaxes.items():
        torch.testing.assert_close(steps[0]["amaxes"][k], v, rtol=1e-6, atol=0)
    own = _one_process_step(case, QAT, slice(0, len(case["images"]) // WORLD))[3]
    assert any(float(own[k]) != float(v) for k, v in amaxes.items())
    sds = [{k: v.numpy() for k, v in d.items()} for d in (before, after)]
    _check_step(([loss], sds, [(steps[0]["loss"], steps[0]["before"], steps[0]["after"],
                                steps[0]["count"])]), 0)


def test_two_rank_remat_step_matches_one_process_remat_step(ranks):
    """The remat step on two ranks: the 2-rank plain step bit for bit (the
    recomputation's cross-replica all-reduces give the first forward's
    statistics again), each BatchNorm's all-reduce run three times (forward,
    recomputed forward, backward) where the plain step runs it twice, and
    the one-process remat step at the step tests' tolerance."""
    case = ranks["payload"]["step"]
    steps = [seen["remat"] for seen in ranks["seen"]]
    for s, plain in zip(steps, (seen["step"] for seen in ranks["seen"])):
        assert s["all_reduces"] == 3 * s["batchnorms"]
        assert s["loss"] == plain["loss"]
        for k, v in plain["after"].items():
            assert torch.equal(v, s["after"][k]), k
    _same_on_both_ranks(steps)
    loss, before, after, _ = _one_process_step(case, {}, slice(None), remat=True)
    sds = [{k: v.numpy() for k, v in d.items()} for d in (before, after)]
    _check_step(([loss], sds, [(steps[0]["loss"], steps[0]["before"], steps[0]["after"],
                                steps[0]["count"])]), 0)


def _int8_bwd_conv_case() -> dict:
    """x, w and a cotangent of a 3x3 stride-2 conv over the global batch."""
    rng = np.random.default_rng(17)
    return {"x": rng.normal(size=(8, 16, 9, 11)).astype(np.float32),
            "w": (rng.normal(size=(12, 16, 3, 3)) * 0.1).astype(np.float32),
            "g": rng.normal(size=(8, 12, 5, 6)).astype(np.float32), "geometry": (2, 1, 1)}


def _spatial_int8_bwd_conv_case() -> dict:
    """x, w and a cotangent of a 3x3 stride-2 conv whose 10 input rows split
    5 / 5 and whose 5 output rows split 3 / 2 (rank 0 borrows rank 1's first
    row)."""
    rng = np.random.default_rng(19)
    return {"x": rng.normal(size=(4, 16, 10, 11)).astype(np.float32),
            "w": (rng.normal(size=(12, 16, 3, 3)) * 0.1).astype(np.float32),
            "g": rng.normal(size=(4, 12, 5, 6)).astype(np.float32), "geometry": (2, 1, 1)}


def test_two_rank_int8_bwd_qat_step_matches_one_process_step(ranks):
    """With QAT's int8 backward the cotangents' amaxes are taken over the
    global batch too: a second all-reduce with MAX a routed site, in the
    backward.  The step: equal losses, amaxes and parameters on both ranks,
    the loss and the running amaxes those of the one-process step.  Its
    parameters are not held to the one-process step's elementwise: an int8
    backward is chaotic (a float32 cotangent within rounding of an int8
    code's edge flips it, and the flip carries through every data gradient
    below; in one process two torch thread counts alone move some tensors'
    updates by 10% of their largest).  One conv holds the arithmetic there,
    fed the same x and g on both sides: the ranks' dx rows bit-equal to the
    one process's, and dw, each rank's dequantized weight gradient summed in
    float32 across the ranks where the one process dequantizes one int32
    sum, within 1.5 float32 ulps of the largest |dw| (two roundings of the
    ranks' products and one of their sum)."""
    from iswm_tpu_torch.ops import int8_train

    from ._torch_dist import QAT_BWD

    case = ranks["payload"]["step"]
    steps = [seen["qat_bwd"] for seen in ranks["seen"]]
    for s in steps:
        assert s["amax_all_reduces"] == 2 * s["routed"] > 40
    _same_on_both_ranks(steps)
    loss, _, _, amaxes = _one_process_step(case, QAT_BWD, slice(None))
    np.testing.assert_allclose(steps[0]["loss"], loss, rtol=1e-5)
    assert set(amaxes) == set(steps[0]["amaxes"])
    for k, v in amaxes.items():
        torch.testing.assert_close(steps[0]["amaxes"][k], v, rtol=1e-6, atol=0)

    conv = ranks["payload"]["int8_bwd_conv"]
    x = torch.from_numpy(conv["x"]).requires_grad_()
    w = torch.from_numpy(conv["w"]).requires_grad_()
    int8_train.int8_conv_fullq(x, w, *conv["geometry"]).backward(torch.from_numpy(conv["g"]))
    rows = len(conv["x"]) // WORLD
    for r, seen in enumerate(ranks["seen"]):
        got = seen["int8_bwd_conv"]
        assert got["amax_all_reduces"] == 2
        assert torch.equal(got["dx"], x.grad[r * rows:(r + 1) * rows])
        limit = 1.5 * np.spacing(np.float32(w.grad.abs().max()))
        assert float((got["dw"] - w.grad).abs().max()) <= limit


def _same_kept_on_both_ranks(steps) -> None:
    """:func:`_same_on_both_ranks` of what ``_torch_dist.kept`` keeps: the
    losses and the running amaxes, and each rank's state digest."""
    for s in steps:
        assert s["loss"] == steps[0]["loss"] and s["equal_to_rank_0"]
        for k, v in s["amaxes"].items():
            assert torch.equal(v, steps[0]["amaxes"][k]), k


def _same_on_both_ranks(steps) -> None:
    """The two ranks' losses, running amaxes and parameters after a step are
    the same."""
    for s in steps:
        assert s["loss"] == steps[0]["loss"]
        for k, v in s["amaxes"].items():
            assert torch.equal(v, steps[0]["amaxes"][k]), k
    for k, v in steps[0]["after"].items():
        assert torch.equal(v, steps[1]["after"][k]), k


def _one_process_step(case, options: dict, rows, remat: bool = False,
                      group_file=None) -> tuple:
    """(loss, state before, state after, running amaxes) of one step of the
    model ``options`` (``{}``: the plain model; ``QAT``, ``QAT_BWD``,
    ``FUSED``: ``_torch_dist.step_model``) in one process on ``rows`` of the
    step's batch, with ``remat`` as the train step's; with ``group_file``,
    in a 1-rank group opened there (the BatchNorm arithmetic of a group)."""
    from iswm_tpu_torch.config import OptimConfig
    from iswm_tpu_torch.models.layers import quant_state
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import destroy
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    from ._torch_dist import step_model

    if group_file is not None:
        assert maybe_initialize_distributed(f"file://{group_file}", 0, 1, device="cpu")
    try:
        model = step_model(case, options)
        factory, _ = make_optimizer(OptimConfig(), TOTAL)
        state = TrainState(model, *factory(model.parameters()), 0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loss = make_train_step(make_loss_fn("ce_loss", fused="interpret"), remat=remat)(
            state, torch.from_numpy(case["images"][rows]),
            torch.from_numpy(case["labels"][rows]))
    finally:
        if group_file is not None:
            destroy()
    return float(loss), before, model.state_dict(), quant_state(model)


# ------------------------------------------ (d') the fused stem and blocks
def test_two_rank_fused_block_matches_jax_and_one_process(ranks):
    """``layer1.0`` on 2 + 2 rows: the global batch's statistics (four
    all-reduces forward, four backward) give the JAX block's and the
    one-process fused block's output, dx, running statistics and, summed
    over the ranks, parameter gradients (1e-5 of each tensor's largest)."""
    from ._torch_dist import fused_block_module

    case = ranks["payload"]["fused_block"]
    seen = [s["fused_block"] for s in ranks["seen"]]
    for s in seen:
        assert s["all_reduces"] == 8
        assert s["calls"] == {"blocks": 1, "stem": 0}
        for k, v in s["buffers"].items():
            assert torch.equal(v, seen[0]["buffers"][k]), k
    block = fused_block_module(case["state"])
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = block(x)
    out.backward(torch.from_numpy(case["g"]))
    one = {"out": out.detach(), "dx": x.grad,
           "grads": {k: p.grad for k, p in block.named_parameters()},
           "buffers": {k: b for k, b in block.named_buffers() if "running_" in k}}
    got = {"out": torch.cat([s["out"] for s in seen]), "dx": torch.cat([s["dx"] for s in seen]),
           "grads": {k: seen[0]["grads"][k] + seen[1]["grads"][k] for k in one["grads"]},
           "buffers": {k: seen[0]["buffers"][k] for k in one["buffers"]}}
    want = ranks["jax_fused"]["block"]
    for part in ("out", "dx"):
        _close(got[part], one[part], 1e-5)
        _close(got[part], want[part], 1e-5)
    for part in ("grads", "buffers"):
        assert set(got[part]) == set(want[part]) == set(one[part])
        for k in one[part]:
            _close(got[part][k], one[part][k], 1e-5)
            _close(got[part][k], want[part][k], 1e-5)


def test_two_rank_fused_stem_matches_jax_and_one_process(ranks):
    """The fused stem on 2 + 2 images: the global statistics (one all-reduce
    forward, one between the backward's two kernels), p and the statistics
    of the JAX stem and the one-process stem (1e-5); the conv weight's, dgamma's
    and dbeta's rank shares summed equal theirs (1e-5 of the largest
    element): each rank's dgamma and dbeta is its own rows' sum, so their
    sum is the one-process value and not twice it."""
    from ._torch_dist import fused_stem_call

    case = ranks["payload"]["fused_stem"]
    seen = [s["fused_stem"] for s in ranks["seen"]]
    for s in seen:
        assert s["all_reduces"] == 2
        assert torch.equal(s["mean"], seen[0]["mean"]) and torch.equal(s["var"], seen[0]["var"])
    one = fused_stem_call(case, lambda a: a)
    got = {"p": torch.cat([s["p"] for s in seen]), "mean": seen[0]["mean"],
           "var": seen[0]["var"],
           **{k: seen[0][k] + seen[1][k] for k in ("dweight", "dgamma", "dbeta")}}
    want = ranks["jax_fused"]["stem"]
    for k in got:
        _close(got[k], one[k], 1e-5)
        _close(got[k], want[k], 1e-5)
    for k in ("dgamma", "dbeta"):  # a rank's share is not the whole
        assert float((seen[0][k] - one[k]).abs().max()) > 0.1 * float(one[k].abs().max()), k


FUSED_SLACK = 5  # (d'): a 2-rank ResNet-50 step's distances against the nudged step's


def _nudge_pooled(module, args, out):
    """Forward hook on the stem's pool, fused or not: 8 of the 32,768 pooled
    values moved up by one float32 ulp (chip_smoke.py's ``_nudge`` at this
    size)."""
    where = torch.rand(out.shape, generator=torch.Generator().manual_seed(0)) < 8 / out.numel()
    return torch.where(where, (out.double() * (1.0 + 2.0 ** -23)).float(), out)


def _step_distances(got: tuple, want: tuple) -> dict:
    """How far step ``got`` (loss, before, after) lies from ``want``: the
    loss (relative), the running statistics (the worst BatchNorm, variance by
    max|var| and mean by max sqrt(var)) and the parameter updates (each
    tensor's max difference by its largest update: the median and the worst
    tensor)."""
    (loss, before, after), (loss_w, before_w, after_w) = got, want
    stats, updates = [], []
    for k, v in after_w.items():
        if k.endswith("running_var"):
            mk = k.replace("running_var", "running_mean")
            stats.append(max(float((after[k] - v).abs().max() / v.abs().max()),
                             float((after[mk] - after_w[mk]).abs().max() / v.sqrt().max())))
        elif not k.endswith(("running_mean", "num_batches_tracked")):
            ref = v - before_w[k]
            updates.append(float(((after[k] - before[k]) - ref).abs().max() / ref.abs().max()))
    updates.sort()
    return {"loss": abs(loss - loss_w) / abs(loss_w), "statistics": max(stats),
            "median update": updates[len(updates) // 2], "worst update": updates[-1]}


def _held_step(ranks, tmp_path, key: str, options: dict, pool) -> dict:
    """The 2-rank step ``key`` of the model ``options`` against one process
    on all 8 rows, as ``chip_smoke.py`` phase 15 holds its 2-rank steps: the
    loss, the worst BatchNorm's statistics and the median and the worst
    update tensor lie within (d)'s tolerance (1e-5, 1e-5, 1e-3, 1e-3) or
    within FUSED_SLACK times the distance of a yardstick step: the
    one-process step with 8 values of the stem's pooled output
    (``backbone.<pool>``) moved by one float32 ulp (``_nudge_pooled``), or
    with ``pool`` None the one-process step at one torch thread where the
    reference runs two (every sum in another order).  The one process runs
    in a 1-rank group, so that its unfused BatchNorms take the cross-replica
    arithmetic (the variance E[x^2] - E[x]^2) that the ranks run.  Returns
    the step's distances and the yardstick's."""
    from . import _torch_dist

    case = ranks["payload"]["step"]
    steps = [seen[key] for seen in ranks["seen"]]
    for s in steps:
        assert s["all_reduces"] == 2 * s["batchnorms"]
        assert s["loss"] == steps[0]["loss"] and s["equal_to_rank_0"]
    reference = _one_process_step(case, options, slice(None), group_file=tmp_path / "one")[:3]
    with pytest.MonkeyPatch.context() as mp:
        real = _torch_dist.step_model

        def nudged(case, options):
            model = real(case, options)
            getattr(model.backbone, pool).register_forward_hook(_nudge_pooled)
            return model

        if pool is None:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
        else:
            mp.setattr(_torch_dist, "step_model", nudged)
        try:
            nudge = _one_process_step(case, options, slice(None),
                                      group_file=tmp_path / "nudged")[:3]
        finally:
            if pool is None:
                torch.set_num_threads(threads)
    # the ranks start from the seeded weights of step_model, the reference's
    got = _step_distances((steps[0]["loss"], reference[1], steps[0]["after"]), reference)
    yardstick = _step_distances(nudge, reference)
    print(f"2-rank {key} from one process: {got}; the yardstick step: {yardstick}")
    for name, tol in (("loss", 1e-5), ("statistics", 1e-5), ("median update", 1e-3),
                      ("worst update", 1e-3)):
        assert got[name] <= max(tol, FUSED_SLACK * yardstick[name]), (name, got, yardstick)
    return {"step": steps[0], "got": got, "nudged": yardstick}


def test_two_rank_fused_step_matches_one_process_fused_step(ranks, tmp_path):
    """deeplabv3plus_resnet50 with ``fused_stem`` / ``fused_blocks`` =
    ``always`` on two ranks (4 rows each) against one process on all 8: the
    stem and 6 bottlenecks (``layer1``, ``layer2.{1,2,3}``; the other blocks
    are strided, dilated or under 3x3) fused, two all-reduces for each
    BatchNorm (a fused conv's sums or the cross-replica module's), equal
    parameters on both ranks, the step held by ``_held_step``.

    Not at (d)'s tolerances alone: this model's float32 step is chaotic at
    crop 32 from seeded weights (a ReLU decision within rounding of its
    threshold flips between two summation orders), and the UNFUSED 2-rank
    step of the same model misses them as far as the fused one (the next
    test prints its distances).  The fused functions' arithmetic on the
    ranks is held at 1e-5 module by module above."""
    from ._torch_dist import FUSED

    held = _held_step(ranks, tmp_path, "fused_step", FUSED, "fused_stem_pool")
    assert held["step"]["fused_calls"] == {"blocks": 6, "stem": 1}


def test_two_rank_resnet50_step_matches_one_process_step(ranks, tmp_path):
    """The same step unfused (every BatchNorm the cross-replica module), held
    the same way: the yardstick the fused step's looser hold rests on, its
    distances from one process printed beside (d)'s tolerances."""
    from ._torch_dist import RESNET50

    held = _held_step(ranks, tmp_path, "resnet50_step", RESNET50, "maxpool")
    assert held["step"]["fused_calls"] == {"blocks": 0, "stem": 0}


def test_two_rank_fused_remat_step_is_the_fused_step(ranks):
    """Remat with the fused stem and blocks on two ranks: each recomputed
    forward runs its all-reduces again (three a BatchNorm, in the same
    order on both ranks) and updates no running statistic again; the step
    is the 2-rank fused step bit for bit."""
    for seen in ranks["seen"]:
        remat, plain = seen["fused_remat"], seen["fused_step"]
        assert remat["fused_calls"] == {"blocks": 12, "stem": 2}
        assert remat["all_reduces"] == 3 * remat["batchnorms"]
        assert remat["loss"] == plain["loss"] and remat["count"] == 1
        assert remat["equal_to_fused_step"]


# ----------------------------------------- (e) world size two: what builds
def test_refusals_and_auto_at_world_size_two(ranks):
    from ._torch_dist import SPATIAL_ACCEPTED, SPATIAL_REFUSED

    for seen in ranks["seen"]:
        r = seen["refusals"]
        assert r["auto"] == ("never", "never")
        for key in ("fused_stem=always", "fused_stem=interpret",
                    "fused_blocks=always", "fused_blocks=interpret"):
            setting, value = key.split("=")
            want = (value, "never") if setting == "fused_stem" else ("never", value)
            assert r[key] == want, key  # built, the mode handed down as given
        for _, key, value in SPATIAL_REFUSED:
            got = r[f"spatial {key}={value!r}"]
            assert got[0] == "NotImplementedError", key
            assert "ROADMAP.md Queue 1, 'Spatial model axis: remaining options'" in got[1]
            assert f"{key}={value!r}" in got[1]
        for name, fields in SPATIAL_ACCEPTED.items():  # Trainers at model axis 2, crop 48
            got, settings = r[f"spatial {name}"], {key: value for _, key, value in fields}
            assert got["mesh"] == {"data": 1, "model": 2}, name
            assert got["backbone"] == {"mobilenetv2": "MobileNetV2",
                                       "xception": "Xception"}[settings["backbone"]], name
            assert got["routed"] > 10, name
            assert got["int8_bwd"] == settings.get("int8_training_bwd", False), name
            assert got["remat"] == settings.get("remat", False), name
        assert r["spatial crop"][0] == "ValueError"
        assert ("crop_size (30) must be a multiple of model_axis (2), and at least "
                "output_stride * model_axis (16 * 2 = 32)") in r["spatial crop"][1]
        assert r["data_axis"] == ("ValueError", "data_axis*model_axis (3*1) != devices (2)")
        assert r["batch"][0] == "ValueError"
        assert "batch_size (3) must be divisible by the mesh data axis (2 devices)" in r["batch"][1]


def test_the_ranks_import_no_jax(ranks):
    assert [seen["jax_loaded"] for seen in ranks["seen"]] == [[], []]


# ------------------------------------------------------------- (f) the fit
def test_trainer_fits_on_two_ranks(ranks):
    fits = [seen["fit"] for seen in ranks["seen"]]
    assert [f["step"] for f in fits] == [2, 2]
    for k, v in fits[0]["state"].items():
        assert torch.equal(v, fits[1]["state"][k]), k
    assert fits[0]["best_path"] is not None and fits[1]["best_path"] is None
    assert len(fits[0]["losses"]) == 2 and all(np.isfinite(fits[0]["losses"]))
    assert fits[1]["losses"] is None  # rank 0 logs
    assert fits[0]["checkpoints"] == fits[1]["checkpoints"]
    assert len(fits[0]["checkpoints"]) == 1


# ------------------------------------------------ (g) the data 1 x model 2 mesh
def test_spatial_mesh_on_two_ranks(ranks):
    images = np.arange(2 * 6 * 5).reshape(2, 6, 5)
    for r, seen in enumerate(ranks["seen"]):
        m = seen["spatial_mesh"]
        assert m["shape"] == {"data": 1, "model": 2}
        assert m["indices"] == (0, r)
        assert m["group_size"] == 2 and m["group_sum"] == 2.0
        np.testing.assert_array_equal(m["sx"], np.arange(24).reshape(8, 3))
        np.testing.assert_array_equal(m["rows"], images[:, 3 * r:3 * r + 3])
        assert m["odd_rows"] == ("ValueError",
                                 "5 image rows do not split evenly over a model axis of 2")


# --------------------------------------------------------- (h) the halo cases
def _one_process_halo(case, tmp_path):
    """The op on the whole image in one process: y, dx and the parameter
    gradients.  The pooling branch runs in a 1-rank group, so that its
    BatchNorm takes the cross-replica arithmetic (flax's variance E[x^2] -
    E[x]^2) that the split runs: alone, the BatchNorm's two-pass variance
    lies 4e-6 * max from it on this branch, whose four values a channel sit
    on a large mean."""
    from iswm_tpu_torch.parallel import destroy

    from ._torch_dist import halo_op

    group = case["kind"] == "pooling"
    if group:
        assert maybe_initialize_distributed(f"file://{tmp_path / 'one'}", 0, 1, device="cpu")
    try:
        fn, params = halo_op(case)
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = fn(x, 1)
        y.backward(torch.from_numpy(case["dy"]))
    finally:
        if group:
            destroy()
    return y.detach(), x.grad, {k: p.grad for k, p in params.items()}


def _batchnorm_condition(case) -> float:
    """The pooling branch's BatchNorm normalizes four values a channel that
    sit on a mean larger than their spread: a relative rounding of the pooled
    input (the split sums each rank's rows apart) comes out of it multiplied
    by max|z| / std(z) of the conv's output z, in float64 (10.2 here).  Every
    tensor after it is held at 1e-6 of its largest element times that
    factor."""
    p = case["x"].astype(np.float64).mean(axis=(2, 3))
    z = p @ case["params"]["1.weight"][:, :, 0, 0].T.astype(np.float64)
    return float((np.abs(z).max(axis=0) / z.std(axis=0)).max())


@pytest.mark.parametrize("case", range(len(HALO_NAMES)), ids=HALO_NAMES)
def test_halo_case_matches_one_process(ranks, case, tmp_path):
    inputs = ranks["payload"]["halo_cases"][case]
    seen = [s["halo"][case] for s in ranks["seen"]]
    y, dx, grads = _one_process_halo(inputs, tmp_path)
    got = {"y": torch.cat([s["y"] for s in seen], dim=2),
           "dx": torch.cat([s["dx"] for s in seen], dim=2),
           **{k: seen[0]["grads"][k] + seen[1]["grads"][k] for k in grads}}
    pooling = inputs["kind"] == "pooling"
    scale = _batchnorm_condition(inputs) if pooling else 1.0
    references = [{"y": y, "dx": dx, **grads}]
    if inputs["name"].startswith("uneven-"):  # and the JAX package's op
        references.append(_jax_halo(inputs))
        assert [s["y"].shape[2] for s in seen] == [-(-y.shape[2] // WORLD),
                                                    y.shape[2] // WORLD]
    for reference in references:
        for k, want in reference.items():
            torch.testing.assert_close(got[k], want, rtol=0,
                                       atol=1e-6 * scale * float(want.abs().max()), msg=k)
    for s in seen:  # one gather forward and one all-reduce backward, or the group sums
        want = ({"halo_gather": 0, "halo_reduce": 0, "group_sum": 2} if pooling else
                {"halo_gather": 1, "halo_reduce": 1, "group_sum": 0})
        assert s["collectives"] == want
        assert s["row_exchanges"] == 1  # the input's global height, the resize's output's too


# ---------------------------------------------------- (i) the spatial step
def test_spatial_train_step_matches_jax_two_device_step(ranks):
    """Data 1 x model 2: both ranks take all 8 images and 16 of their 32
    rows; the halos, the BatchNorm over the default group and the summed
    gradients give the JAX package's 2-device step."""
    jax_losses, sds = ranks["jax_step"]
    steps = [seen["spatial_step"] for seen in ranks["seen"]]
    for s in steps:
        assert s["all_reduces"] == 2 * s["batchnorms"]
        # 25 row windows (the stem, the pool, 18 strided or wider convs, the
        # two resizes): a gather each, an all-reduce each in the backward but
        # the stem's (the image takes no gradient); the pool's group sum twice
        assert s["collectives"] == {"halo_gather": 25, "halo_reduce": 24, "group_sum": 2}
    _same_on_both_ranks(steps)
    port = [(steps[0]["loss"], steps[0]["before"], steps[0]["after"], steps[0]["count"])]
    _check_step((jax_losses, sds, port), 0)


# ------------------------------- (i') the spatial step's options (Item 15)
def test_spatial_remat_step_is_the_spatial_step(ranks):
    """Remat under the split: each recomputed segment runs under the split
    of its first forward, so the step is the plain split step bit for bit.
    The recomputation gathers every window again but the final resize
    (outside the segments): 24 more gathers, no more all-reduce of halos
    (the backward's are the first forward's), the pooling branch's group sum
    once more; each BatchNorm's all-reduce three times; no row counts
    exchanged again (the heights are cached at the first forward)."""
    for seen in ranks["seen"]:
        remat, plain = seen["spatial_remat"], seen["spatial_step"]
        assert remat["loss"] == plain["loss"] and remat["count"] == 1
        assert remat["equal_to_like"] and remat["equal_to_rank_0"]  # the state after
        assert remat["recomputed"] == {"halo_gather": 24, "halo_reduce": 0, "group_sum": 1}
        assert remat["collectives"] == {
            k: plain["collectives"][k] + remat["recomputed"][k] for k in plain["collectives"]}
        assert remat["all_reduces"] == 3 * remat["batchnorms"]
        assert remat["row_exchanges"] == plain["row_exchanges"] > 0


def test_spatial_qat_step_matches_one_process_step(ranks):
    """QAT (delayed scales, gate 64) under the split: a routed conv fetches
    its halo and runs at H padding 0 (the ASPP's dilated 3x3s through
    ``int8_dilated_conv3x3`` too); its amax, a max over the halo-extended
    rows all-reduced over both ranks, is the global one.  The step is the
    one-process QAT step at the step tests' tolerances, the amaxes within
    1e-6 and equal on both ranks."""
    from ._torch_dist import QAT

    case = ranks["payload"]["step"]
    steps = [seen["spatial_qat"] for seen in ranks["seen"]]
    for s, plain in zip(steps, (seen["spatial_step"] for seen in ranks["seen"])):
        assert s["amax_all_reduces"] == s["routed"] > 20
        assert s["collectives"] == plain["collectives"]
    _same_kept_on_both_ranks(steps)
    loss, before, after, amaxes = _one_process_step(case, QAT, slice(None))
    assert set(amaxes) == set(steps[0]["amaxes"])
    for k, v in amaxes.items():
        torch.testing.assert_close(steps[0]["amaxes"][k], v, rtol=1e-6, atol=0)
    sds = [{k: v.numpy() for k, v in d.items()} for d in (before, after)]
    # the ranks start from the crossed weights, the one process's ``before``
    _check_step(([loss], sds, [(steps[0]["loss"], before, steps[0]["after"],
                                steps[0]["count"])]), 0)


def test_spatial_int8_bwd_qat_step_matches_one_process_step(ranks):
    """QAT's int8 backward under the split: the data gradient of the
    halo-extended rows goes back to their owners, the cotangent's amax is
    all-reduced over both ranks.  The step (chaotic, see the 2-rank int8
    backward test): equal on both ranks, the loss and the running amaxes
    those of the one-process step.  One conv site (3x3, stride 2, 10 rows
    split 5 / 5 to 5 output rows split 3 / 2) holds the arithmetic against
    one process: the output rows bit-equal (the same codes, the same global
    amax); dx bit-equal but on the row that rank 0 borrows, which sums each
    rank's dequantized part in float32 where one process dequantizes one
    int32 sum, and dw, summed over the ranks, within 1.5 float32 ulps of
    their largest."""
    from iswm_tpu_torch.ops import int8_train

    from ._torch_dist import QAT_BWD, int8_bwd_site

    case = ranks["payload"]["step"]
    steps = [seen["spatial_qat_bwd"] for seen in ranks["seen"]]
    for s in steps:
        assert s["amax_all_reduces"] == 2 * s["routed"] > 40
    _same_kept_on_both_ranks(steps)
    loss, _, _, amaxes = _one_process_step(case, QAT_BWD, slice(None))
    np.testing.assert_allclose(steps[0]["loss"], loss, rtol=1e-5)
    for k, v in amaxes.items():
        torch.testing.assert_close(steps[0]["amaxes"][k], v, rtol=1e-6, atol=0)

    conv_case = ranks["payload"]["spatial_int8_bwd_conv"]
    conv = int8_bwd_site(conv_case)
    x = torch.from_numpy(conv_case["x"]).requires_grad_()
    reduces = int8_train.amax_all_reduces
    out = conv(x)
    out.backward(torch.from_numpy(conv_case["g"]))
    assert int8_train.amax_all_reduces == reduces  # no group here: nothing to reduce
    seen = [s["spatial_int8_bwd_conv"] for s in ranks["seen"]]
    assert [s["out"].shape[2] for s in seen] == [3, 2]
    assert torch.equal(torch.cat([s["out"] for s in seen], dim=2), out.detach())
    dx = torch.cat([s["dx"] for s in seen], dim=2)
    borrowed = 5  # rank 1's first row, read by rank 0's last output row
    rows = [r for r in range(x.shape[2]) if r != borrowed]
    assert torch.equal(dx[:, :, rows], x.grad[:, :, rows])
    limit = 1.5 * np.spacing(np.float32(x.grad.abs().max()))
    assert float((dx - x.grad).abs().max()) <= limit
    limit = 1.5 * np.spacing(np.float32(conv.weight.grad.abs().max()))
    for s in seen:
        assert s["amax_all_reduces"] == 2  # x's amax forward, g's backward
        assert s["collectives"] == {"halo_gather": 1, "halo_reduce": 1, "group_sum": 0}
        assert float((s["dw"] - conv.weight.grad).abs().max()) <= limit


@pytest.mark.parametrize("backbone", ["mobilenetv2", "xception"])
def test_spatial_backbone_step_matches_one_process_step(ranks, tmp_path, backbone):
    """MobileNetV2 and Xception (seeded weights, crop 32) under the split.
    Xception's maps split unevenly: its VALID stems take the 16 + 16 rows to
    8 + 7 and 7 + 6, block1 to 4 + 3 (the low-level map), then 2 + 2 and
    1 + 1; the decoder resizes 1 + 1 rows to 4 + 3 and those to 16 + 16.
    The eval-mode forward under the split (the halos' arithmetic, apart from
    the train-mode BatchNorm's sums over both ranks, which a chaotic step
    amplifies) gives one process's logits within 1e-5; the step is held by
    ``_held_step`` against the one-process step at another thread count
    (each model's float32 step is chaotic at this size: that step moves
    some tensor's update by 0.9-1.7 times its largest and the median tensor
    by 0.2-0.4% of its largest, so no 2-rank step meets (d)'s per-update
    tolerance, and an ulp on 8 stem values is no yardstick); every rank
    makes the same collectives, and a second step exchanges no row counts
    and the same halos."""
    from ._torch_dist import step_model

    options = {"backbone": backbone}
    held = _held_step(ranks, tmp_path, f"spatial_{backbone}", options, None)
    seen = [s[f"spatial_{backbone}"] for s in ranks["seen"]]
    case = ranks["payload"]["step"]
    with torch.no_grad():
        want = step_model(case, options).eval()(
            torch.from_numpy(case["images"]).permute(0, 3, 1, 2))
    logits = torch.cat([s["eval_logits"] for s in seen], dim=2)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    for s in seen:
        assert s["collectives"] == seen[0]["collectives"]
        assert s["row_exchanges"] == seen[0]["row_exchanges"] > 0
        assert s["again"] == {"collectives": s["collectives"], "row_exchanges": 0}
    assert held["step"]["fused_calls"] == {"blocks": 0, "stem": 0}


# ------------------------------------------------ (j) the scene-parallel engine
@pytest.mark.parametrize("model", ["standin", "int8"])
def test_tile_engine_mesh_matches_one_rank_engine(ranks, model):
    from iswm_tpu_torch.infer.tiling import TileEngine

    from ._torch_dist import int8_serving_fn, standin_fn

    case = ranks["payload"]["tiles"]
    if model == "standin":
        want = TileEngine(standin_fn, tile=128, overlap=32, batch=2).infer_scene(
            torch.from_numpy(case["scene"]))
        shape, tol = (300, 280, 2), 1e-5
    else:
        fn = int8_serving_fn(case["x0"])
        want = TileEngine(fn, tile=32, overlap=8, batch=2).infer_scene(
            torch.from_numpy(case["int8_scene"]))
        shape, tol = (72, 64, 2), 1e-4
        assert [s["tiles"]["routed"] for s in ranks["seen"]] == [len(fn.routed_sites)] * 2
        assert len(fn.routed_sites) > 20
    for seen in ranks["seen"]:  # every rank blends the whole scene
        got = seen["tiles"][model]
        assert tuple(got.shape) == tuple(want.shape) == shape
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------ (k) the dry run
def test_dryrun_body_at_model_two(ranks):
    runs = [seen["dryrun"] for seen in ranks["seen"]]
    for run in runs:
        assert run["mesh"] == {"data": 1, "model": 2}
        assert run["step"] == 1 and np.isfinite(run["loss"])
        assert tuple(run["logits"].shape) == (72, 64, 2)
        assert bool(torch.isfinite(run["logits"]).all()) and run["routed"] > 20
    assert runs[0]["loss"] == runs[1]["loss"]
    assert torch.equal(runs[0]["logits"], runs[1]["logits"])
