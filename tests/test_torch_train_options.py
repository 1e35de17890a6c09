"""The port's two single-device training options on the CPU: activation
rematerialization (``parallel.remat``) and low-precision parameters
(``model.param_dtype``).

Remat recomputes each block's forward in the backward (``models/remat.py``)
with the same ops in the same order, so in float32 its step IS the plain
step: one or two steps from one state, dropout on and one torch seed for both runs,
give equal losses, parameters, running statistics (updated once a step),
``num_batches_tracked`` and running amaxes, bit for bit, for crossed
ResNet-18 weights, MobileNetV2, ResNet-50 with the fused stem and blocks
(their plain versions) and ResNet-18 with delayed QAT and its int8 backward.
It is held against the JAX package's remat step (``jax.checkpoint`` around
the forward) at ``test_torch_train_step.py``'s tolerance, on that file's
crossed weights and first batch, dropout off.

bf16 parameters: one step of the crossed ResNet-18 (float32 compute) against
JAX's with ``param_dtype="bfloat16"``: parameters and SGD momentum bf16,
BatchNorm statistics float32 on both sides; the loss within 1e-5 relative,
the statistics as in the step tests, and every parameter and momentum
element within ``BF16_ULPS`` bf16 ulps of JAX's (the two round the
gradient's float32 sums, and optax rounds ``-lr * update`` before the add
where torch rounds once: readings below).  Every backbone builds with bf16
and float16 parameters; a ``.pth`` stays float32 on disk and loads back
into them; a bf16-parameter model serves through ``Predictor``.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.compat import load_momentum, momentum_from_optax, state_dict_from_jax
from iswm_tpu_torch.config import ModelConfig, OptimConfig
from iswm_tpu_torch.models import BACKBONES, build_model, remat
from iswm_tpu_torch.models.layers import BatchNorm2d, quant_state
from iswm_tpu_torch.ops.losses import make_loss_fn
from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)
from .test_torch_train import _no_dropout, assert_bn_stats_close
from .test_torch_train_step import OPTIM, TOTAL, _batch, _check_step

# the largest distance from JAX's, in bf16 ulps (``bf16_ulps``), of any
# parameter or momentum element after the bf16-parameter step (readings: 3.25
# for the parameters, 4.0 for the momentum, at 2 torch threads): float32
# gradients that differ by summation order, rounded to bf16 on both sides
BF16_ULPS = 6
# the batch seed of the bf16-parameter step: seeds were tried in order from 1,
# and the first whose float32 step on the bf16-rounded weights passes
# ``_check_step`` (no ReLU or pool decision flipped) was kept
BF16_BATCH = 2

# name: (model settings, crossed ResNet-18 weights, segments a forward, steps)
REMAT_CASES = {
    "resnet18": (dict(backbone="resnet18"), True, 1 + 8 + 2, 2),
    "mobilenetv2": (dict(backbone="mobilenetv2"), False, 18 + 2, 1),
    "resnet50_fused": (dict(backbone="resnet50", fused_stem="interpret",
                            fused_blocks="interpret"), False, 1 + 16 + 2, 1),
    # a recomputation that read the updated amax instead of the first
    # forward's would change the codes already in step 1 (0 -> max |x|)
    "resnet18_qat": (dict(backbone="resnet18", int8_training=64, int8_scale_mode="delayed",
                          int8_training_bwd=True), True, 1 + 8 + 2, 1),
}


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """``test_torch_train_step.py``'s crossed ResNet-18: (JAX model, its
    variables, the port's state dict of them)."""
    from .test_torch_models import crossed_models

    jmodel, variables, model, _ = crossed_models(tmp_path_factory.mktemp("ckpt"),
                                                 "resnet18", 16)
    return jmodel, variables, {k: v.clone() for k, v in model.state_dict().items()}


def _port_steps(cfg, sd, images, labels, steps, remat_on, dropout=True):
    """(losses, state dict, running amaxes, segments run) of ``steps`` steps
    from the seeded or the given weights, the torch seed set first."""
    model = build_model(cfg)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    factory, _ = make_optimizer(OPTIM, TOTAL)
    state = TrainState(model, *factory(model.parameters()), 0)
    step = make_train_step(make_loss_fn("ce_loss", fused="interpret"), remat=remat_on)
    segments = []
    with pytest.MonkeyPatch.context() as mp:
        checkpoint = remat.checkpoint
        mp.setattr(remat, "checkpoint", lambda *a, **k: segments.append(1) or checkpoint(*a, **k))
        torch.manual_seed(0)
        losses = [float(step(state, images, labels)) for _ in range(steps)]
    return (losses, {k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in quant_state(model).items()}, len(segments), state)


@pytest.mark.parametrize("name", sorted(REMAT_CASES))
def test_remat_step_is_the_plain_step(name, crossed):
    settings, crossed_weights, segments, steps = REMAT_CASES[name]
    cfg = ModelConfig(compute_dtype="float32", **settings)
    gen = torch.Generator().manual_seed(5)
    images = torch.randn(2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 2, (2, 32, 32), generator=gen)
    sd = crossed[2] if crossed_weights else None
    plain = _port_steps(cfg, sd, images, labels, steps, False)
    again = _port_steps(cfg, sd, images, labels, steps, True)
    assert plain[3] == 0 and again[3] == steps * segments
    assert plain[0] == again[0] and np.isfinite(plain[0]).all()
    assert plain[1].keys() == again[1].keys()
    for k, v in plain[1].items():
        assert torch.equal(v, again[1][k]), k
        if k.endswith("num_batches_tracked"):
            assert int(v) == steps, k  # once a step
    assert plain[2].keys() == again[2].keys()
    assert bool(plain[2]) == (name == "resnet18_qat")
    for k, v in plain[2].items():
        assert torch.equal(v, again[2][k]) and float(v) > 0, k  # updated from 0


def _jax_step(jmodel, variables, images, labels, remat_on, param_dtype=None):
    """One JAX step (the fused CE in interpret mode, dropout off by the
    caller): (loss, state before, state after)."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.ops.pallas.fused_ce import fused_binary_ce
    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer
    from iswm_tpu.train.step import TrainState as JaxState
    from iswm_tpu.train.step import make_train_step as jax_make_train_step

    params = variables["params"]
    if param_dtype is not None:
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, param_dtype), params)
    tx, _ = jax_make_optimizer(OPTIM, TOTAL)
    ones = jnp.ones(2, jnp.float32)
    step = jax_make_train_step(jmodel, tx, lambda lg, lb: fused_binary_ce(lg, lb, ones, 255, True),
                               augment=None, donate=False, remat=remat_on)
    first = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=variables["batch_stats"], opt_state=tx.init(params))
    state, metrics = step(first, jnp.asarray(images), jnp.asarray(labels), jax.random.key(0))
    return float(metrics["loss"]), jax.device_get(first), jax.device_get(state)


def _sd(state):
    return state_dict_from_jax(state.params, state.batch_stats, backbone="resnet18")


def test_remat_step_matches_jax_remat_step(crossed, monkeypatch):
    jmodel, variables, sd = crossed
    images, labels = _batch(1)
    _no_dropout(monkeypatch, torch.nn.Module())  # flax's Dropout the identity
    loss, first, after = _jax_step(jmodel, variables, images, labels, True)
    losses, port_after, _, segments, _ = _port_steps(
        ModelConfig(backbone="resnet18", compute_dtype="float32"), sd,
        torch.from_numpy(images), torch.from_numpy(labels), 1, True, dropout=False)
    assert segments == REMAT_CASES["resnet18"][2]
    _check_step(([loss], [_sd(first), _sd(after)], [(losses[0], sd, port_after, 1)]), 0)


def bf16_ulps(got: torch.Tensor, want) -> float:
    """The largest distance of ``got`` from ``want`` in bf16 ulps, each
    element's ulp taken at its own magnitude but no finer than at 1/256 of
    the tensor's largest (bf16's resolution there: an element near 0 is not
    measured in ulps of 1e-30)."""
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), np.abs(want).max() / 256)
    ulp = np.spacing(scale.astype(np.float32)) * 2.0 ** 16  # float32's 23 bits -> bf16's 7
    return float((np.abs(got.float().numpy() - want) / ulp).max())


def test_bf16_parameter_step_matches_jax(crossed, monkeypatch):
    """Dtypes as the JAX package's (parameters, gradients and the SGD
    momentum bf16; the BatchNorm statistics float32; optax's count int32);
    each bf16 gradient is the float32 step's on the same (rounded) weights,
    rounded once; the step within ``BF16_ULPS`` of JAX's, and the momentum
    carried across by the bridge exactly."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.models import build_model as build_jax_model

    _, variables, sd = crossed
    jmodel = build_jax_model(JaxModelConfig(backbone="resnet18", compute_dtype="float32",
                                            param_dtype="bfloat16"))
    images, labels = _batch(BF16_BATCH)
    _no_dropout(monkeypatch, torch.nn.Module())  # flax's Dropout the identity
    loss, _, after = _jax_step(jmodel, variables, images, labels, False, jnp.bfloat16)
    leaves = jax.tree_util.tree_leaves
    assert {str(x.dtype) for x in leaves(after.params)} == {"bfloat16"}
    assert {str(x.dtype) for x in leaves(after.batch_stats)} == {"float32"}
    trace, count = after.opt_state[1][0].trace, after.opt_state[1][1].count
    assert {str(x.dtype) for x in leaves(trace)} == {"bfloat16"} and count.dtype == np.int32

    cfg = ModelConfig(backbone="resnet18", compute_dtype="float32", param_dtype="bfloat16")
    batch = torch.from_numpy(images), torch.from_numpy(labels)
    losses, port_after, _, _, state = _port_steps(cfg, sd, *batch, 1, False, dropout=False)
    model, optimizer = state.model, state.optimizer
    named = dict(model.named_parameters())
    assert {p.dtype for p in named.values()} == {torch.bfloat16}
    assert {p.grad.dtype for p in named.values()} == {torch.bfloat16}
    assert {optimizer.state[p]["momentum_buffer"].dtype
            for p in named.values()} == {torch.bfloat16}
    assert {v.dtype for k, v in port_after.items() if "running" in k} == {torch.float32}
    rounded = {k: v.to(torch.bfloat16).float() if k in named else v for k, v in sd.items()}
    f32 = _port_steps(ModelConfig(backbone="resnet18", compute_dtype="float32"), rounded,
                      *batch, 1, False, dropout=False)
    assert f32[0] == losses
    for k, p in f32[4].model.named_parameters():
        assert torch.equal(named[k].grad, p.grad.to(torch.bfloat16)), k

    jax_after = _sd(after)
    np.testing.assert_allclose(losses[0], loss, rtol=1e-5)
    assert_bn_stats_close(port_after, jax_after)
    assert max(bf16_ulps(port_after[k], jax_after[k]) for k in named) <= BF16_ULPS
    moved = sum(int((port_after[k] != sd[k].to(torch.bfloat16)).sum()) for k in named)
    assert moved > 1000  # the step moves parameters by an ulp or more
    buffers, steps = momentum_from_optax(after.opt_state, after.batch_stats, backbone="resnet18")
    assert steps == 1
    assert max(bf16_ulps(optimizer.state[p]["momentum_buffer"], buffers[k])
               for k, p in named.items()) <= BF16_ULPS
    fresh = make_optimizer(OPTIM, TOTAL)[0](model.parameters())[0]
    load_momentum(fresh, model, buffers)
    for k, p in named.items():
        got = fresh.state[p]["momentum_buffer"]
        assert got.dtype == torch.bfloat16 and bf16_ulps(got, buffers[k]) == 0, k


def test_every_backbone_builds_with_low_precision_parameters(monkeypatch):
    """Every backbone in bf16 and float16: parameters in ``param_dtype``,
    statistics float32 (the weights left uninitialized: the placement of
    dtypes does not depend on them); three backbones' bf16 weights are their
    float32 init rounded once."""
    import iswm_tpu_torch.models as models

    for backbone in ("resnet18", "mobilenetv2", "xception"):
        model = build_model(ModelConfig(backbone=backbone, param_dtype="bfloat16"))
        want = build_model(ModelConfig(backbone=backbone)).state_dict()
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), (backbone, k)
    monkeypatch.setattr(models, "init_weights", lambda model, generator: model)
    monkeypatch.setattr(torch.nn.Conv2d, "reset_parameters", lambda self: None)
    for backbone in BACKBONES:
        for dtype in (torch.bfloat16, torch.float16):
            model = build_model(ModelConfig(backbone=backbone, param_dtype=str(dtype)[6:]))
            assert {p.dtype for p in model.parameters()} == {dtype}, backbone
            assert {b.dtype for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))} == {torch.float32}, backbone


@pytest.mark.parametrize("backbone, param_dtype", [
    ("resnext50_32x4d", "bfloat16"), ("mobilenetv2", "float16"), ("xception", "bfloat16")])
def test_low_precision_parameters_train(backbone, param_dtype):
    """One remat step in bf16 compute: finite loss, parameters, gradients and
    momentum in ``param_dtype``, statistics float32, updated once (ResNet-18
    and ResNet-50's fused path: ``test_torch_train.py``'s Trainer cases)."""
    dtype = getattr(torch, param_dtype)
    cfg = ModelConfig(backbone=backbone, param_dtype=param_dtype)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 2, (2, 32, 32), generator=gen)
    losses, after, _, segments, state = _port_steps(cfg, None, images, labels, 1, True)
    assert np.isfinite(losses).all() and segments > 0
    assert {p.dtype for p in state.model.parameters()} == {dtype}
    assert {p.grad.dtype for p in state.model.parameters()} == {dtype}
    assert {state.optimizer.state[p]["momentum_buffer"].dtype
            for p in state.model.parameters()} == {dtype}
    for k, v in after.items():
        if "running" in k:
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_pth_is_float32_on_disk_and_param_dtype_in_memory(tmp_path):
    from iswm_tpu_torch.train import checkpoint as ckpt_lib

    cfg = ModelConfig(backbone="resnet18", param_dtype="bfloat16")
    model = build_model(cfg, seed=3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.normal_()
    factory, _ = make_optimizer(OptimConfig(), TOTAL)
    path = ckpt_lib.save_latest(str(tmp_path), TrainState(model, *factory(model.parameters())))
    on_disk = torch.load(path, weights_only=True)["model_state"]
    assert {v.dtype for v in on_disk.values() if v.is_floating_point()} == {torch.float32}
    fresh = build_model(cfg)
    ckpt_lib.restore(path, TrainState(fresh, *factory(fresh.parameters())), False)
    assert {p.dtype for p in fresh.parameters()} == {torch.bfloat16}
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_predictor_serves_bf16_parameters(tmp_path):
    """A bf16-parameter Predictor's products equal those of a float32 one
    holding the same (rounded) weights, in bf16 and int8_exec serving: every
    consumer of a weight widens it exactly."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.infer import Predictor
    from iswm_tpu_torch.train import checkpoint as ckpt_lib

    cfg = Config()
    cfg.model.backbone, cfg.model.param_dtype = "resnet18", "bfloat16"
    cfg.predict.tile_size, cfg.predict.tile_overlap, cfg.predict.tile_batch = 64, 16, 2
    model = build_model(cfg.model)
    factory, _ = make_optimizer(OptimConfig(), TOTAL)
    path = ckpt_lib.save_latest(str(tmp_path), TrainState(model, *factory(model.parameters())))
    image = np.random.default_rng(0).integers(0, 256, (80, 96, 3), dtype=np.uint8)
    for variant in ("bf16", "int8_exec"):
        cfg.predict.serving_variant = variant
        got = Predictor(cfg, ckpt_path=path, device="cpu")
        assert {p.dtype for p in got.model.parameters()} == {torch.bfloat16}
        cfg.model.param_dtype = "float32"
        want = Predictor(cfg, ckpt_path=path, device="cpu")
        cfg.model.param_dtype = "bfloat16"
        a, b = got.predict_image(image), want.predict_image(image)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{variant} {k}")
