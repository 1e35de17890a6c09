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
- (e) refusals at world size 2: ``model_axis > 1``, the fused stem and blocks
  under ``always`` / ``interpret``; ``auto`` resolves to ``never``;
  ``data_axis`` other than the world size and a batch that does not divide;
- (f) ``Trainer.fit`` of 2 steps and a validation on the two ranks: equal
  parameters on both, one checkpoint, written by rank 0.
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
    payload = {"ce_cases": _ce_cases(), "bn_cases": _bn_cases(),
               "step": {"ckpt": ckpt, "images": images, "labels": labels},
               "int8_bwd_conv": _int8_bwd_conv_case(),
               "fit_dir": str(root / "fit")}
    torch.save(payload, root / "payload.pt")
    context = start_ranks(str(root / "payload.pt"), str(root))

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    jax_ce = [_jax_sharded_ce(mesh, case) for case in payload["ce_cases"]]
    flax_bn = [_flax_batchnorm(case) for case in payload["bn_cases"]]
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp, torch.nn.Module())
        jax_loss, jax_state = _jax_step(mesh, jmodel, variables, images, labels)
    sds = [state_dict_from_jax(variables["params"], variables["batch_stats"],
                               backbone="resnet18"),
           state_dict_from_jax(jax_state.params, jax_state.batch_stats, backbone="resnet18")]
    seen = join_ranks(context, str(root), timeout=300)
    return {"payload": payload, "seen": seen, "jax_ce": jax_ce, "flax_bn": flax_bn,
            "jax_step": ([jax_loss], sds)}


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
        assert m["model_2"][0] == "NotImplementedError"
        assert "ROADMAP.md Queue 1, 'Spatial model axis'" in m["model_2"][1]


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
    from iswm_tpu_torch.models import layers

    before = layers.cross_replica_all_reduces
    BatchNorm2d(3).train()(torch.randn(2, 3, 4, 4))
    assert layers.cross_replica_all_reduces == before


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


def _same_on_both_ranks(steps) -> None:
    """The two ranks' losses, running amaxes and parameters after a step are
    the same."""
    for s in steps:
        assert s["loss"] == steps[0]["loss"]
        for k, v in s["amaxes"].items():
            assert torch.equal(v, steps[0]["amaxes"][k]), k
    for k, v in steps[0]["after"].items():
        assert torch.equal(v, steps[1]["after"][k]), k


def _one_process_step(case, quant: dict, rows, remat: bool = False) -> tuple:
    """(loss, state before, state after, running amaxes) of one step of the
    QAT model ``quant`` (``{}``: the plain model) in one process on ``rows``
    of the step's batch, with ``remat`` as the train step's."""
    from iswm_tpu_torch.compat import load_checkpoint
    from iswm_tpu_torch.config import ModelConfig, OptimConfig
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.models.layers import quant_state
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    from ._torch_dist import _dropout_off

    model = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32", **quant))
    model.load_state_dict(load_checkpoint(case["ckpt"]), strict=True)
    _dropout_off(model)
    factory, _ = make_optimizer(OptimConfig(), TOTAL)
    state = TrainState(model, *factory(model.parameters()), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = make_train_step(make_loss_fn("ce_loss", fused="interpret"), remat=remat)(
        state, torch.from_numpy(case["images"][rows]), torch.from_numpy(case["labels"][rows]))
    return float(loss), before, model.state_dict(), quant_state(model)


# ----------------------------------------------------------- (e) refusals
def test_refusals_and_auto_at_world_size_two(ranks):
    for seen in ranks["seen"]:
        r = seen["refusals"]
        assert r["auto"] == ("never", "never")
        for key in ("fused_stem=always", "fused_stem=interpret",
                    "fused_blocks=always", "fused_blocks=interpret"):
            assert r[key][0] == "NotImplementedError", key
            assert "ROADMAP.md Queue 1, 'Sharded fused stem and blocks'" in r[key][1]
        assert r["model_axis"][0] == "NotImplementedError"
        assert "ROADMAP.md Queue 1, 'Spatial model axis'" in r["model_axis"][1]
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
