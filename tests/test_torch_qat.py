"""Quantization-aware training of the port against the JAX package's
``iswm_tpu/ops/int8_train.py``, on the CPU (the kernels' plain versions).

- ``int8_conv_st`` and ``int8_conv_static_amax``: outputs (and new amaxes)
  bit-equal in float32 (the int32 sums are exact and every float step is the
  same IEEE operation); gradients within 1e-5 * max (the dense conv's VJP,
  summed in another order).  ``int8_dilated_conv3x3`` on planted integer
  grids (every scale exactly 1): output and straight-through gradients
  bit-equal, at d = 1, 2, 3, 6.  ``int8_cost_route`` equal on a grid.
- The routed sites of a forward equal the JAX package's key for key
  (``port_site_key``), train and eval mode, on six models: the JAX side is
  only traced (``jax.eval_shape``), its int8 functions wrapped to record the
  calling module.
- ResNet-18 at 32^2: the QAT eval forward within 1e-2 * max|logit| of the JAX
  package's with mask agreement >= 0.999 (the int8 rule: an ulp-level
  activation difference can flip one int8 level at a site); one train step in
  float64 (the QAT forward quantizes in float32 on both sides) with each
  parameter's update within 1e-6 of max|update|, in dynamic and delayed mode,
  and the delayed step's new amaxes equal to the JAX package's "quant"
  collection.
- ``conv_scales_from_quant``, the checkpoint's ``quant`` entry, and the
  int8 -> plain switch.

The ``cuda`` cases hold the device-scale entries (the amax as a device
tensor) bit-equal to the host-scale entries and to the plain versions, where
this file runs alone without jax:
``python -m pytest --noconftest tests/test_torch_qat.py -m cuda``.
"""

import copy
import itertools
import os

import numpy as np
import pytest
import torch

from iswm_tpu_torch.config import Config, ModelConfig, OptimConfig
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.models.layers import BatchNorm2d, quant_state, routed_sites
from iswm_tpu_torch.ops import int8_train as pt
from iswm_tpu_torch.ops.kernels import int8_conv as kc

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ----------------------------------------------------------------- the ops
@pytest.mark.parametrize("geo", [(1, 1, 1), (2, 1, 1), (1, 2, 2)])  # stride, pad, dilation
def test_int8_conv_st_matches_jax(geo):
    """Shapes of ``tests/test_int8_train.py``'s first two cases."""
    import jax

    from iswm_tpu.ops.int8_train import int8_conv_st

    s, p, d = geo
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 12, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 128)) * 0.05).astype(np.float32)
    want, vjp = jax.vjp(lambda x, w: int8_conv_st(x, w, (s, s), ((p, p), (p, p)), (d, d)),
                        x, w)
    g = rng.normal(size=want.shape).astype(np.float32)
    gx, gw = vjp(g)
    xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    out = pt.int8_conv_st(xt, wt, s, p, d)
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want))
    out.backward(_nchw(g))
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx)
    _close(wt.grad.permute(2, 3, 1, 0).numpy(), gw)


def test_int8_conv_static_amax_matches_jax():
    """Output and new amax bit-equal at a warm, a stale and a zero amax
    (scale 1); no gradient reaches the amax."""
    import jax.numpy as jnp

    from iswm_tpu.ops.int8_train import int8_conv_static_amax

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 12, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 128)) * 0.05).astype(np.float32)
    warm = jnp.max(jnp.abs(x))
    for amax in (warm, warm * 0.5, jnp.zeros((), jnp.float32)):
        want, want_new = int8_conv_static_amax(x, w, amax, (1, 1), ((1, 1), (1, 1)), (1, 1))
        a = torch.tensor(np.asarray(amax))
        xt = _nchw(x).requires_grad_()
        out, new = pt.int8_conv_static_amax(xt, _oihw(w), a, 1, 1, 1)
        np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want))
        assert new.dtype == torch.float32 and float(new) == float(want_new)
        out.sum().backward()
        assert a.grad is None and xt.grad is not None


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_int8_dilated_conv3x3_exact_on_grid(d):
    """``tests/test_int8_train.py``'s planted grid, ``int8_bwd=False``: the
    int8 forward equals the dense dilated conv and JAX's, the
    straight-through gradients JAX's, bit for bit (integer sums < 2^24)."""
    import jax

    from iswm_tpu.ops.int8_train import int8_dilated_conv3x3

    rng = np.random.default_rng(13)

    def mk(shape):
        a = rng.integers(-126, 127, shape).astype(np.float32)
        a.flat[0] = 127.0
        return a

    x, w = mk((2, 10, 9, 4)), mk((3, 3, 4, 6))
    w[0, 0, 0, :] = 127.0
    want, vjp = jax.vjp(lambda x, w: int8_dilated_conv3x3(x, w, d, False), x, w)
    g = mk(want.shape)
    gx, gw = vjp(g)
    xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    out = pt.int8_dilated_conv3x3(xt, wt, d)
    dense = torch.nn.functional.conv2d(_nchw(x), _oihw(w), None, 1, d, d)
    np.testing.assert_array_equal(out.detach().numpy(), dense.numpy())
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want))
    out.backward(_nchw(g))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx))
    np.testing.assert_array_equal(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gw))
    # every scale is 1 here, so the int8 backward gives the same bits
    xb, wb = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    pt.int8_dilated_conv3x3(xb, wb, d, int8_bwd=True).backward(_nchw(g))
    assert torch.equal(xb.grad, xt.grad) and torch.equal(wb.grad, wt.grad)


def test_int8_cost_route_matches_jax():
    from iswm_tpu.ops.int8_train import int8_cost_route

    grid = itertools.product((48, 64, 256, 512, 2048), (2, 48, 64, 256, 512, 1024), (1, 3),
                             (1, 2), (False, True), (False, True), (3.0, 1.5))
    n = 0
    for cin, cout, k, s, delayed, bwd, qb in grid:
        kw = dict(delayed=delayed, want_bwd=bwd, quant_bytes=qb)
        assert pt.int8_cost_route(cin, cout, k, s, **kw) == int8_cost_route(cin, cout, k, s,
                                                                             **kw)
        n += 1
    assert n == 960


# ---------------------------------------------------------- routed sites
SITE_CASES = {  # ModelConfig fields; routed sites of an eval and a train forward
    "resnet50_gate256": (dict(backbone="resnet50", int8_training=256), (45, 49)),
    "mobilenetv2": (dict(backbone="mobilenetv2", int8_training=64), None),
    "xception": (dict(backbone="xception", int8_training=256), None),
    "v3_resnet18": (dict(name="deeplabv3", backbone="resnet18", int8_training=64), None),
    "separable_resnet18": (dict(backbone="resnet18", separable_conv=True, int8_training=64),
                           None),
    "cost_resnet50": (dict(backbone="resnet50", int8_training=64, int8_route="cost",
                           int8_scale_mode="delayed", int8_training_bwd=True), None),
}


def _jax_routed(fields: dict, with_bwd: bool = False) -> tuple:
    """The sites a JAX eval and train forward route, traced only (the eval
    one is init's forward): the calling module of each int8 function,
    ``<path>/pointwise`` for a separable conv's half and ``<path>#p{i}`` for
    a concat conv's part; ``with_bwd``: (site, whether its backward is int8).
    Traced once a configuration in this module."""
    key = tuple(sorted(fields.items()))
    if key not in _ROUTED:
        _ROUTED[key] = _trace_jax_routed(fields)
    sites = _ROUTED[key]
    return sites if with_bwd else tuple([path for path, _ in mode] for mode in sites)


_ROUTED = {}


def _trace_jax_routed(fields: dict) -> tuple:
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.models import build_model as build_jax_model
    from iswm_tpu.models import layers as jl
    from iswm_tpu.models.xception import SepConvBN
    from iswm_tpu.ops import int8_train as jt

    model = build_jax_model(JaxModelConfig(compute_dtype="float32", **fields))
    stack, sites = [], []

    def interceptor(next_fun, args, kwargs, context):
        stack.append((context.module, context.method_name, args))
        try:
            return next_fun(*args, **kwargs)
        finally:
            stack.pop()

    def recorded(fn, name):
        def wrapped(*a, **k):
            module, method, margs = stack[-1]
            path = "/".join(module.path)
            if method == "_int8_part_conv":
                path += f"#p{margs[0]}"
            elif isinstance(module, (jl.SeparableConvBN, SepConvBN)):
                path += "/pointwise"
            bwd = name.startswith("int8_conv_fullq") or (name == "int8_dilated_conv3x3"
                                                         and bool(a[3]))
            sites.append((path, bwd))
            return fn(*a, **k)

        return wrapped

    x = jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32)
    with pytest.MonkeyPatch.context() as mp, fnn.intercept_methods(interceptor):
        for name in ("int8_conv_st", "int8_conv_static_amax", "int8_dilated_conv3x3",
                     "int8_conv_fullq", "int8_conv_fullq_static"):
            mp.setattr(jt, name, recorded(getattr(jt, name), name))
        variables = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), x)
        eval_sites = sites[:]
        del sites[:]
        jax.eval_shape(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats", "quant"],
            rngs={"dropout": jax.random.key(1)}), variables, x)
    return eval_sites, sites


def _count_quantizes(mp, record) -> None:
    """Call ``record()`` at each quantize that makes codes: ``quantize_s8``
    (a group's route, after the all-reduce) or ``quantize_s8_reduce`` in its
    dynamic or delayed mode."""
    mp.setattr(pt, "quantize_s8", lambda *a: record() or kc.quantize_s8(*a))
    mp.setattr(pt, "quantize_s8_reduce",
               lambda x, mode, *a: (mode != "amax" and record()) or kc.quantize_s8_reduce(
                   x, mode, *a))


@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_routed_sites_match_jax(case):
    fields, counts = SITE_CASES[case]
    model = build_model(ModelConfig(compute_dtype="float32", **fields))
    keys = dict(backbone=fields["backbone"], head=fields.get("name", "deeplabv3plus"))
    for train, jax_sites in zip((False, True), _jax_routed(fields)):
        want = sorted(pq.port_site_key(k, **keys) for k in jax_sites)
        got = sorted(routed_sites(model, train))
        assert got == want, (train, sorted(set(got) ^ set(want)))
        if counts:
            assert len(got) == counts[train]
    # a forward runs exactly those: one quantize and one dense conv a site
    model.train(False)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _count_quantizes(mp, lambda: calls.append(1))
        with torch.no_grad():
            model(torch.zeros(1, 3, 32, 32))
    assert len(calls) == len(routed_sites(model, False))


# ------------------------------------------------------- ResNet-18 at 32^2
QAT = dict(backbone="resnet18", int8_training=64)


@pytest.fixture(scope="module")
def trees():
    """ResNet-18's JAX (params, batch_stats) from the port's seeded init (no
    JAX compile), BatchNorm perturbed (QAT adds no variable to them), and the
    port's state dict of them."""
    import jax

    from iswm_tpu.compat.torch_import import export_torch_state_dict

    from .test_torch_models import perturbed_trees, port_init

    _, _, params, stats = port_init("resnet18", 16)
    params, stats = perturbed_trees(jax.device_get(params), jax.device_get(stats))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(
        params, stats, backbone="resnet18").items()}
    return params, stats, sd


def _models(trees, **fields):
    """(JAX model, params, batch_stats, port model loaded ``strict=True``)
    of ``QAT`` and ``fields``, on the crossed weights."""
    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.models import build_model as build_jax_model

    params, stats, sd = trees
    fields = dict(compute_dtype="float32", **QAT, **fields)
    model = build_model(ModelConfig(**fields))
    model.load_state_dict(sd, strict=True)
    return build_jax_model(JaxModelConfig(**fields)), params, stats, model


def _quant_tree(jmodel, values) -> dict:
    """The JAX model's "quant" collection (the structure its init makes,
    traced only) with the ASPP projection's train-only parts, the leaves
    drawn in order from ``values``."""
    import jax

    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), np.zeros((1, 32, 32, 3)),
                                                train=False))["quant"]
    shapes = jax.tree_util.tree_map(lambda a: a, shapes)
    shapes["head"]["aspp"]["project"].update({f"x_amax_p{i}": 0 for i in range(5)})
    return jax.tree_util.tree_map(lambda _: np.float32(next(values)), shapes)


def test_resnet18_qat_forward_matches_jax(trees):
    import jax

    jmodel, params, stats, model = _models(trees)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x))
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 2)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


# XLA's algebraic simplifier turns ``amax / 127.0`` into a product with the
# reciprocal, one ulp off the IEEE quotient in some weight scales, which moves
# int8 codes: the step is compiled without it, so that it computes the
# division the JAX function writes (what it computes op by op, and the port)
IEEE_XLA = {"xla_disable_hlo_passes": "algsimp"}


def _jax_quant_key(path: tuple) -> str:
    """A leaf path of the JAX "quant" collection -> the port's buffer key."""
    return f"{pq.port_site_key('/'.join(path[:-1]), backbone='resnet18')}.{path[-1]}"


def _jax_step64(jmodel_fields, params, stats, quant, images, labels, optim, total):
    """(state after, {parameter: update}) of one JAX float64 step, dropout off,
    compiled with ``IEEE_XLA``."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from iswm_tpu import models as jax_models
    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer
    from iswm_tpu.train.step import TrainState as JaxState
    from iswm_tpu.train.step import make_train_step as jax_make_train_step
    from iswm_tpu_torch.compat import state_dict_from_jax

    from .test_torch_zoo import _ce64

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax_models, "_dtype", lambda name: jnp.float64)
        jmodel = jax_models.build_model(JaxModelConfig(**jmodel_fields))
        params, stats = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
                         for t in (params, stats))
        tx, _ = jax_make_optimizer(optim, total)
        jstep = jax_make_train_step(jmodel, tx, _ce64, augment=None, donate=False)
        first = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), quant=quant)
        args = (first, jnp.asarray(images), jnp.asarray(labels), jax.random.key(0))
        compiled = jstep.lower(*args).compile(compiler_options=IEEE_XLA)
        state, _ = jax.device_get(compiled(*args))
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                    state.params, params)
    return state, {k: v.double() for k, v in state_dict_from_jax(
        update, stats, backbone="resnet18").items()}


@pytest.mark.parametrize("mode", ["dynamic", "delayed"])
def test_resnet18_qat_step_float64_matches_jax(trees, mode):
    """One step from the crossed weights, batch 8 at 32^2, no augmentation,
    dropout off, ``ce_loss``, everything in float64 but the int8 forward's
    float32 quantize and epilogue (the same on both sides).  Delayed: the
    amaxes start from values planted on both sides (the trainer's start is 0
    everywhere), the ASPP projection's train-only parts included; JAX's
    collection also holds the eval-only projection's ``x_amax``, which no
    train forward reads or writes and which the port does not keep."""
    import jax

    from iswm_tpu_torch.data import generate_scene, normalize
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    jmodel, params, stats, model = _models(trees, int8_scale_mode=mode)
    rng = np.random.default_rng(1)
    images, labels = zip(*(generate_scene(rng, size=(32, 32)) for _ in range(8)))
    images = normalize(torch.from_numpy(np.stack(images)).float() / 255.0).numpy()
    labels = np.stack(labels).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255

    quant = {}
    if mode == "delayed":
        quant = _quant_tree(jmodel, itertools.count(1.5, 0.25))
        amaxes = quant_state(model)
        for path, value in jax.tree_util.tree_flatten_with_path(quant)[0]:
            key = _jax_quant_key(tuple(p.key for p in path))
            if key in amaxes:
                amaxes[key].fill_(float(value))
    optim, total = OptimConfig(), 50
    state, want = _jax_step64({**QAT, "int8_scale_mode": mode}, params, stats, quant,
                              images.astype(np.float64), labels, optim, total)

    model = copy.deepcopy(model).to(torch.float64)
    model.compute_dtype = torch.float64
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    factory, _ = make_optimizer(optim, total)
    tstate = TrainState(model, *factory(model.parameters()), 0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm2d, "forward", lambda self, x: torch.nn.functional.batch_norm(
            x, None, None, self.weight, self.bias, True, 0.0, self.eps))
        make_train_step(make_loss_fn("ce_loss", fused="never"))(
            tstate, torch.from_numpy(images).double(), torch.from_numpy(labels))
    for k, v in model.named_parameters():
        got = (v.detach() - before[k]).double()
        assert float((got - want[k]).abs().max()) <= 1e-6 * float(want[k].abs().max()), k

    if mode == "delayed":
        jax_amaxes = {_jax_quant_key(tuple(p.key for p in path)): float(v) for path, v in
                      jax.tree_util.tree_flatten_with_path(state.quant)[0]}
        got = {k: float(v) for k, v in quant_state(model).items()}
        assert set(jax_amaxes) - set(got) == {"classifier.aspp.project.0.x_amax"}
        assert got == {k: jax_amaxes[k] for k in got}
        assert sum(k.startswith("classifier.aspp.project.0.x_amax_p") for k in got) == 5


# --------------------------------------------- scales, checkpoints, switch
def test_conv_scales_from_quant_matches_jax(trees):
    """Equal keys (``port_site_key``) and scales, and the int8_exec_xla
    serving fn of a plain model runs with them merged over calibration."""
    import jax

    from iswm_tpu.infer.quantization import conv_scales_from_quant

    jmodel, params, stats, model = _models(trees, int8_scale_mode="delayed")
    quant = _quant_tree(jmodel, iter(np.linspace(0.0, 9.0, 64, dtype=np.float32)))
    port_quant = {_jax_quant_key(tuple(p.key for p in path)): torch.tensor(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(quant)[0]}
    want = {pq.port_site_key(k, backbone="resnet18"): s
            for k, s in conv_scales_from_quant(quant).items()}
    got = pq.conv_scales_from_quant(port_quant)
    assert got == want and any(k.endswith("#p1") for k in got) and 1.0 in got.values()

    plain = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32"))
    plain.load_state_dict(model.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 3, 32, 32)).astype(np.float32))
    calibrated = pq.calibrate_conv_inputs(plain, [x], wide=True)
    learned = pq.conv_scales_from_quant(quant_state(model))
    assert learned and set(learned) - set(calibrated) == {
        f"classifier.aspp.project.0#p{i}" for i in range(5)}
    fn = pq.make_int8_exec_fn(plain, {**calibrated, **learned}, backend="xla")
    assert fn.routed_sites and torch.isfinite(fn(x.permute(0, 2, 3, 1))).all()


def test_checkpoint_quant_round_trip(tmp_path):
    """The amaxes ride the payload's ``quant`` beside ``model_state``: a QAT
    model gets them back exactly, a plain model loads ``strict=True``, the
    JAX package reads the file, a plain run writes no ``quant``."""
    from iswm_tpu.compat.torch_import import load_reference_checkpoint
    from iswm_tpu_torch.train import TrainState, make_optimizer
    from iswm_tpu_torch.train import checkpoint as ckpt

    def state_of(**fields):
        model = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32",
                                        **fields))
        factory, _ = make_optimizer(OptimConfig(), 10)
        return TrainState(model, *factory(model.parameters()), 3)

    qat = state_of(int8_training=64, int8_scale_mode="delayed")
    marked = quant_state(qat.model)
    for i, v in enumerate(marked.values()):
        v.fill_(3.25 + i)
    path = ckpt.save_latest(str(tmp_path), qat)
    payload = torch.load(path, weights_only=True)
    assert set(payload["quant"]) == set(marked)
    assert not any("x_amax" in k for k in payload["model_state"])

    fresh = state_of(int8_training=64, int8_scale_mode="delayed")
    meta = ckpt.restore(path, fresh, continue_training=True)
    assert "quant" not in meta and fresh.step == 3
    assert {k: float(v) for k, v in quant_state(fresh.model).items()} == {
        k: float(v) for k, v in marked.items()}
    plain = state_of()
    ckpt.restore(path, plain, continue_training=False)
    assert not quant_state(plain.model) and len(ckpt.load_quant(path)) == len(marked)
    params, _, _ = load_reference_checkpoint(path, backbone="resnet18")
    assert "backbone" in params
    assert "quant" not in torch.load(ckpt.save_latest(str(tmp_path / "plain"), plain),
                                     weights_only=True)


def test_int8_switch_iter_keeps_parameters(tmp_path):
    """A 4-step run switching at 2 (delayed scales): steps 0-1 route, 2-3 run
    the plain convs; the optimizer keeps its parameter objects and state,
    the amaxes are dropped.  The switch opens the fused-block gate again."""
    from iswm_tpu_torch.data import ArrayDataset
    from iswm_tpu_torch.models.layers import switch_off_int8
    from iswm_tpu_torch.models.resnet import Bottleneck
    from iswm_tpu_torch.train import Trainer

    bottlenecks = build_model(ModelConfig(int8_training=256, fused_blocks="always"))
    gate = [m for m in bottlenecks.modules() if isinstance(m, Bottleneck)]
    assert gate and not any(m.fuses_on(torch.device("cpu")) for m in gate)
    switch_off_int8(bottlenecks)
    assert gate[1].fuses_on(torch.device("cpu")) and not routed_sites(bottlenecks, True)

    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                      rng.integers(0, 2, (8, 32, 32), dtype=np.uint8))
    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = "resnet18", "float32"
    cfg.model.int8_training, cfg.model.int8_scale_mode = 64, "delayed"
    cfg.data.crop_size, cfg.data.batch_size, cfg.data.val_batch_size = 32, 4, 4
    cfg.train.total_itrs, cfg.train.val_interval, cfg.train.print_interval = 4, 4, 2
    cfg.train.int8_switch_iter, cfg.train.save_val_results = 2, False
    cfg.metrics.sequence_length = 3
    for key in ("checkpoints_dir", "log_dir", "val_results_dir", "metrics_plots_dir"):
        setattr(cfg.train, key, os.path.join(tmp_path, key))
    trainer = Trainer(cfg, device="cpu", train_ds=ds, val_ds=ds)
    model = trainer.state.model
    params = list(model.parameters())
    assert model.quant.int8 and quant_state(model) and routed_sites(model, True)
    launched = []
    orig = trainer.train_step

    def counted(state, images, labels):
        kc.launches_quantize = 0
        with pytest.MonkeyPatch.context() as mp:
            _count_quantizes(mp, lambda: launched.append(state.step))
            return orig(state, images, labels)

    trainer.train_step = counted
    trainer.fit()
    assert trainer.state.step == 4 and trainer._switch_iter == 0
    assert set(launched) == {0, 1}  # validation at 4 runs the plain model too
    assert not model.quant.int8 and not quant_state(model) and not routed_sites(model, True)
    assert list(model.parameters()) == params
    opt = trainer.state.optimizer
    assert all(p in opt.state and "momentum_buffer" in opt.state[p] for p in params
               if p.grad is not None)
    assert all(not getattr(m, "qat", False) for m in model.modules())
    assert np.isfinite(trainer.logger.history["train_loss"]).all()


def test_int8_training_bwd_is_refused():
    """Refused no longer: ``int8_training_bwd`` builds, and a train forward
    routes each site with the JAX package's (forward, backward) pair, the
    cost route deciding the backward per site and per concat part (the
    delayed mode's ``int8_conv_fullq_static``, the ASPP branches'
    ``int8_dilated_conv3x3(..., True)``)."""
    from iswm_tpu_torch.models import build_model_by_name
    from iswm_tpu_torch.models.layers import QatConv2d

    fields = SITE_CASES["cost_resnet50"][0]
    assert fields["int8_training_bwd"] and fields["int8_route"] == "cost"
    model = build_model(ModelConfig(compute_dtype="float32", **fields))
    got = {}
    for name, m in model.named_modules():
        if isinstance(m, QatConv2d):
            if m.runs_parts(True):
                got.update({k: m.part_bwd[int(k.rsplit("#p", 1)[1])]
                            for k in m.routed_sites(name, True)})
            else:
                got.update({k: m.int8_bwd for k in m.routed_sites(name, True)})
    want = {pq.port_site_key(k, backbone="resnet50"): bwd
            for k, bwd in _jax_routed(fields, with_bwd=True)[1]}
    assert got == want
    assert any(want.values()) and not all(want.values())
    # without int8_training the flag routes nothing, as in the JAX package
    assert not routed_sites(build_model_by_name("deeplabv3plus_resnet18",
                                                int8_training_bwd=True), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_quantize_plain_is_amax_then_quantize(dtype):
    """The reducing quantize's plain version in its three modes: the amax
    ``activation_amax``'s bit for bit, the codes ``quantize_s8_plain``'s with
    it (dynamic) or with the running amax (delayed, beside ``max |x|``); and
    ``quantize_activation`` (NCHW x, its NHWC rows) the same, dynamic and
    delayed, at a warm, a stale and a zero running amax."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 24, 7, 5)).astype(np.float32) * 3).to(dtype)
    rows = x.permute(0, 2, 3, 1)
    amax = pt.activation_amax(x)
    for xt in (rows, rows[..., 8:16], torch.zeros_like(rows)):
        a = pt.activation_amax(xt)
        q, got = kc.quantize_s8_reduce(xt, "dynamic")
        assert got.dtype == torch.float32 and torch.equal(got, a)
        assert torch.equal(q, kc.quantize_s8_plain(xt, a))
        assert kc.quantize_s8_reduce(xt, "amax")[0] is None
        assert torch.equal(kc.quantize_s8_reduce(xt, "amax")[1], a)
        for running in (a, a * 0.5, torch.zeros(())):
            q, cur = kc.quantize_s8_reduce(xt, "delayed", running)
            assert torch.equal(cur, a) and torch.equal(q, kc.quantize_s8_plain(xt, running))
    x_q, got, cur = pt.quantize_activation(x)
    assert torch.equal(got, amax) and got is cur
    assert torch.equal(x_q, kc.quantize_s8_plain(rows, amax))
    for running in (amax, amax * 0.5, torch.zeros(())):
        x_q, got, cur = pt.quantize_activation(x, running=running)
        assert got is running and torch.equal(cur, amax)
        assert torch.equal(x_q, kc.quantize_s8_plain(rows, running))
    with pytest.raises(ValueError, match="mode"):
        kc.quantize_s8_reduce(rows, "static")


# -------------------------------------------------------------- on the card
CUDA_SHAPES = ((8, 32, 32, 256, 64, 1, 1, 0, 1), (2, 33, 17, 256, 256, 3, 2, 1, 1),
               (8, 16, 16, 512, 256, 3, 1, 6, 6), (8, 1, 1, 512, 256, 1, 1, 0, 1),
               (2, 9, 7, 48, 24, 3, 1, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_device_scale_entries_bit_equal(shape):
    """The amax entries equal the host-scale entries fed the scale they form,
    and the plain versions, in float32 and bf16, for a positive and a zero
    amax; the launches count by the scale's source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, n, k, s, p, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (n, k, k, c), generator=gen, device="cuda").to(torch.int8)
    w_s = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
    for amax in (pt.activation_amax(x), torch.zeros((), device="cuda")):
        scale = float(kc.scale_of(amax, "cuda"))
        before = {e: dict(v) for e, v in kc.launches_by_scale.items()}
        x_q = kc.quantize_s8(x, amax)
        assert torch.equal(x_q, kc.quantize_s8(x, scale))
        assert torch.equal(x_q, kc.quantize_s8_plain(x, amax))
        for dt in (torch.float32, torch.bfloat16):
            got = kc.conv_s8_igemm(x_q, w_q, w_s, amax, None, s, p, d, out_dtype=dt)
            assert torch.equal(got, kc.conv_s8_igemm(x_q, w_q, w_s, scale, None, s, p, d,
                                                     out_dtype=dt))
            assert torch.equal(got, kc.conv_s8_plain(x_q, w_q, w_s, amax, None, s, p, d,
                                                     out_dtype=dt))
        assert kc.launches_by_scale["quantize"]["device"] == before["quantize"]["device"] + 1
        assert kc.launches_by_scale["igemm"]["device"] == before["igemm"]["device"] + 2
        assert kc.launches_by_scale["igemm"]["host"] == before["igemm"]["host"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_reduce_quantize_bit_equal(shape):
    """``quantize_s8_reduce`` in its three modes equals ``activation_amax`` +
    ``quantize_s8_plain``: the amax bit for bit, the codes, the delayed
    mode's ``max |x|`` beside the codes of a stale and a zero running amax;
    in float32 and bf16, contiguous, as a channel slice and all zeros (and,
    once, the dynamic mode on a 64 MB tensor: two iterations a pass); one
    launch a call, counted by mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        base = (torch.randn((b, h, w, c + 16), generator=gen, device="cuda") * 3).to(dt)
        for x in (base[..., 16:].contiguous(), base[..., :c], torch.zeros_like(base[..., :c])):
            amax = pt.activation_amax(x)
            before = dict(kc.launches_reduce), kc.launches_quantize
            q, got = kc.quantize_s8_reduce(x, "dynamic")
            assert torch.equal(got, amax) and torch.equal(q, kc.quantize_s8_plain(x, amax))
            none, got = kc.quantize_s8_reduce(x, "amax")
            assert none is None and torch.equal(got, amax)
            for running in (amax * 0.5, torch.zeros((), device="cuda")):
                q, cur = kc.quantize_s8_reduce(x, "delayed", running)
                assert torch.equal(cur, amax) and torch.equal(q, kc.quantize_s8_plain(x, running))
            torch.cuda.synchronize()
            assert kc.launches_reduce == {"dynamic": before[0]["dynamic"] + 1,
                                          "amax": before[0]["amax"] + 1,
                                          "delayed": before[0]["delayed"] + 2}
            assert kc.launches_quantize == before[1] + 3
    if shape == CUDA_SHAPES[0]:  # 64 MB of bf16
        x = torch.randn((8, 64, 64, 1024), generator=gen, device="cuda").to(torch.bfloat16)
        q, got = kc.quantize_s8_reduce(x, "dynamic")
        amax = pt.activation_amax(x)
        assert torch.equal(got, amax) and torch.equal(q, kc.quantize_s8_plain(x, amax))
