"""The rest of the model zoo against the JAX package, on the CPU in float32
at 32x32: MobileNetV2 and Xception, the plain DeepLabV3 head and the
separable head convs; cache-only pretrained backbones; feature maps.

Weights cross as in ``test_torch_models`` (BatchNorm perturbed first): the
JAX package's own export where it has one, the port's bridge for the
separable head, which that export lacks, each loaded with ``strict=True``.
Logits may differ only by summation order: max abs difference <= 1e-4 *
max |logit|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iswm_tpu.compat import pretrained as jax_pretrained
from iswm_tpu.compat.torch_import import export_torch_state_dict
from iswm_tpu.config import Config, ModelConfig, OptimConfig
from iswm_tpu.infer import quantization as jq
from iswm_tpu_torch.compat import pretrained
from iswm_tpu_torch.compat import state_dict_from_jax
from iswm_tpu_torch.data import generate_scene, normalize
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.models.layers import BatchNorm2d
from iswm_tpu_torch.ops.losses import make_loss_fn
from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)
from .test_torch_models import jax_init, perturbed_trees
from .test_torch_train import _no_dropout, assert_bn_stats_close, imagenet_file

# (head, backbone, output stride, separable_conv)
ZOO = {
    "mobilenetv2_os16": ("deeplabv3plus", "mobilenetv2", 16, False),
    "mobilenetv2_os8": ("deeplabv3plus", "mobilenetv2", 8, False),
    "xception_os16": ("deeplabv3plus", "xception", 16, False),
    "v3_resnet18": ("deeplabv3", "resnet18", 16, False),
    "separable_resnet18": ("deeplabv3plus", "resnet18", 16, True),
}


def crossed(case, seed=0):
    """(JAX model, JAX variables, port model) with one perturbed set of
    weights, the port's loaded ``strict=True``."""
    head, backbone, output_stride, separable = ZOO[case]
    cfg, jmodel, params, stats = jax_init(backbone, output_stride, seed, name=head,
                                          separable_conv=separable)
    params, stats = perturbed_trees(jax.device_get(params), jax.device_get(stats), seed)
    if separable:
        sd = state_dict_from_jax(params, stats, backbone=backbone, head=head)
    else:
        sd = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(
            params, stats, backbone=backbone, head=head).items()}
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return jmodel, {"params": params, "batch_stats": stats}, model


@pytest.fixture(scope="module")
def zoo():
    """``crossed`` once per case in this module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = crossed(case)
        return cache[case]

    return get


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_logits_match_jax(zoo, case):
    jmodel, variables, model = zoo(case)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# --------------------------------------------------------------- int8 sites
@pytest.mark.parametrize("case", ["mobilenetv2_os16", "separable_resnet18", "v3_resnet18",
                                  "xception_os16"])
def test_quantization_sites_match_jax(zoo, case):
    """The activation sites (int8_act), the wide calibration's conv sites
    and the int8_exec routes are the JAX package's, key for key through
    ``port_act_site_key`` / ``port_site_key``, with equal scales."""
    head, backbone = ZOO[case][:2]
    jmodel, v, model = zoo(case)
    images = list(np.random.default_rng(2).normal(size=(2, 1, 32, 32, 3)).astype(np.float32))
    keys = {"backbone": backbone, "head": head}

    want = {pq.port_act_site_key(k, **keys): s for k, s in jq.calibrate_activations(
        jmodel, v["params"], v["batch_stats"], images).items()}
    got = pq.calibrate_activations(model, [_nchw(x) for x in images])
    assert set(got) == set(want) == set(pq.activation_sites(model))
    for name, scale in want.items():
        np.testing.assert_allclose(got[name], scale, rtol=1e-5, err_msg=name)

    jax_scales = jq.calibrate_conv_inputs(jmodel, v["params"], v["batch_stats"], images,
                                          wide=True)
    want = {pq.port_site_key(key, **keys): scale  # a concat conv's parts as "#p{i}"
            for key, scale in jax_scales.items()}
    got = pq.calibrate_conv_inputs(model, [_nchw(x) for x in images], wide=True)
    assert set(got) == set(want)
    for name, scale in want.items():
        np.testing.assert_allclose(got[name], scale, rtol=1e-5, err_msg=name)

    jfn = jq.make_variant_fn(jmodel, v["batch_stats"], v["params"], "int8_exec",
                             conv_scales=jax_scales)
    jfn.inner.lower(jnp.asarray(images[0]), *jfn.bound_args)  # tracing records the routes
    fn = pq.make_variant_fn(model, "int8_exec", conv_scales=got)
    assert set(fn.routed_sites) == {pq.port_site_key(k, **keys) for k in jfn.routed_sites}
    assert len(fn.routed_sites) == {"mobilenetv2_os16": 1, "xception_os16": 8,
                                    "separable_resnet18": 8, "v3_resnet18": 4}[case]


# --------------------------------------------------------------- pretrained
@pytest.mark.parametrize("backbone,file_name", [("resnet18", "resnet18-f37072fd.pth"),
                                                ("mobilenetv2", "mobilenet_v2-b0353104.pth")])
def test_pretrained_overlay_equals_jax(tmp_path, monkeypatch, backbone, file_name):
    imagenet_file(tmp_path / file_name, backbone)
    monkeypatch.setenv("ISWM_PRETRAINED_DIR", str(tmp_path))
    cfg, _, params, stats = jax_init(backbone, 16)
    params, stats, src = jax_pretrained.apply_pretrained_backbone(params, stats, cfg)
    want = export_torch_state_dict(jax.device_get(params), jax.device_get(stats),
                                   backbone=backbone)
    model = build_model(cfg)
    head = {k: v.clone() for k, v in model.classifier.state_dict().items()}
    assert pretrained.apply_pretrained_backbone(model, backbone) == src == str(
        tmp_path / file_name)
    for key, value in model.backbone.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), want[f"backbone.{key}"], err_msg=key)
        else:
            assert int(value) == 0, key  # the file's counters are not read
    for key, value in model.classifier.state_dict().items():
        assert torch.equal(value, head[key]), key  # the head keeps its seeded weights


@pytest.mark.parametrize("in_channels", [1, 5])
def test_stem_adaptation_equals_jax(tmp_path, monkeypatch, in_channels):
    from iswm_tpu.compat.torch_import import adapt_stem_in_channels

    w = np.random.default_rng(in_channels).normal(size=(64, 3, 7, 7)).astype(np.float32)
    tree = {"backbone": {"stem": {"conv": {"kernel": w.transpose(2, 3, 1, 0)}, "bn": {}}}}
    want = adapt_stem_in_channels(tree, in_channels)["backbone"]["stem"]["conv"]["kernel"]
    got = pretrained.adapt_stem_in_channels(torch.from_numpy(w), in_channels)
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want, rtol=1e-6, atol=0)
    # and through the overlay of a model with that stem
    sd = imagenet_file(tmp_path / "resnet18.pth", "resnet18")
    monkeypatch.setenv("ISWM_PRETRAINED_DIR", str(tmp_path))
    model = build_model(ModelConfig(backbone="resnet18", in_channels=in_channels))
    assert pretrained.apply_pretrained_backbone(model, "resnet18", in_channels)
    assert torch.equal(model.backbone.conv1.weight,
                       pretrained.adapt_stem_in_channels(sd["conv1.weight"], in_channels))


def test_missing_cache_warns_or_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ISWM_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))  # the two caches under ~ are empty
    monkeypatch.delenv("ISWM_REQUIRE_PRETRAINED", raising=False)
    model = build_model(ModelConfig(backbone="xception"))
    before = copy.deepcopy(model.state_dict())
    with pytest.warns(UserWarning, match="no cached ImageNet weights found for 'xception'"):
        assert pretrained.apply_pretrained_backbone(model, "xception") is None
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    monkeypatch.setenv("ISWM_REQUIRE_PRETRAINED", "1")
    with pytest.raises(FileNotFoundError, match="continuing with random"):
        pretrained.apply_pretrained_backbone(model, "xception")


def test_shape_mismatch_is_refused(tmp_path, monkeypatch):
    sd = imagenet_file(tmp_path / "resnet18.pth", "resnet18")
    sd["layer1.0.conv1.weight"] = sd["layer1.0.conv1.weight"][:32]
    torch.save(sd, str(tmp_path / "resnet18.pth"))
    monkeypatch.setenv("ISWM_PRETRAINED_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="layer1.0.conv1.weight"):
        pretrained.apply_pretrained_backbone(build_model(ModelConfig(backbone="resnet18")),
                                             "resnet18")


# ------------------------------------------------------------- feature maps
def test_feature_maps_match_jax(tmp_path):
    from iswm_tpu.compat.torch_import import save_reference_checkpoint
    from iswm_tpu.infer.predictor import Predictor as JaxPredictor
    from iswm_tpu_torch.infer import Predictor

    _, variables, _ = crossed("mobilenetv2_os16", seed=5)
    ckpt = str(tmp_path / "mobilenetv2.pth")
    save_reference_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                              backbone="mobilenetv2")
    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = "mobilenetv2", "float32"
    cfg.predict.tile_size, cfg.predict.tile_overlap = 32, 8
    image = np.random.default_rng(6).integers(0, 256, (40, 24, 3), dtype=np.uint8)
    want = JaxPredictor(cfg, ckpt_path=ckpt).extract_feature_maps(image)
    got = Predictor(cfg, ckpt_path=ckpt, device="cpu").extract_feature_maps(image)
    assert list(got) == list(want) == ["backbone_low_level", "backbone_out", "aspp"]
    for label, fmap in want.items():
        assert got[label].shape == fmap.shape and got[label].dtype == np.float32, label
        assert 0.0 <= got[label].min() and got[label].max() <= 1.0, label
        np.testing.assert_allclose(got[label], fmap, atol=1e-4, err_msg=label)


# ---------------------------------------------------------------- training
BATCH = 8
STAT_TOL = 5e-5
F64_TOL = 1e-6  # each tensor's float64 update, the port's against JAX's
F32_LIMIT = 0.2  # each tensor's float32 update against the float64 one, either side


def _port_update(model, images, labels, optim, total, dtype):
    """(loss, the stepped copy, {parameter: new - old in float64}) of one port
    step in ``dtype`` from ``model``'s weights (a copy), dropout off.  float32
    takes the fused CE's plain version and the port's BatchNorm; float64 the
    autograd loss and ``F.batch_norm`` with batch statistics (the port's
    BatchNorm computes in float32)."""
    model = copy.deepcopy(model).to(dtype)
    model.compute_dtype = dtype
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    factory, _ = make_optimizer(optim, total)
    state = TrainState(model, *factory(model.parameters()), 0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        if dtype == torch.float64:
            mp.setattr(BatchNorm2d, "forward", lambda self, x: torch.nn.functional.batch_norm(
                x, None, None, self.weight, self.bias, True, 0.0, self.eps))
        loss = make_train_step(make_loss_fn(
            "ce_loss", fused="interpret" if dtype == torch.float32 else "never"))(
            state, torch.from_numpy(images).to(dtype), torch.from_numpy(labels))
    return float(loss), model, {k: (v.detach() - before[k]).double()
                                for k, v in model.named_parameters()}


def _ce64(logits, labels):
    """``ce_loss`` in the logits' dtype (the JAX package's takes float32)."""
    valid = labels != 255
    picked = jnp.take_along_axis(logits, jnp.where(valid, labels, 0)[..., None], axis=-1)
    ce = jax.nn.logsumexp(logits, axis=-1) - picked[..., 0]
    return jnp.sum(jnp.where(valid, ce, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


def _jax_update(jmodel, params, stats, images, labels, optim, total, loss_fn):
    """(loss, state after, {parameter: new - old}) of one JAX step, the
    update taken in the trees' dtype and then exported."""
    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer
    from iswm_tpu.train.step import TrainState as JaxState
    from iswm_tpu.train.step import make_train_step as jax_make_train_step

    tx, _ = jax_make_optimizer(optim, total)
    jstep = jax_make_train_step(jmodel, tx, loss_fn, augment=None, donate=False)
    first = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                     opt_state=tx.init(params))
    state, metrics = jax.device_get(jstep(first, jnp.asarray(images), jnp.asarray(labels),
                                          jax.random.key(0)))
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                    state.params, params)
    return (float(metrics["loss"]), state,
            {k: v.double() for k, v in state_dict_from_jax(
                update, stats, backbone="mobilenetv2").items()})


def _update_distance(update, exact, after):
    """max over a tensor of |update - exact| beyond one float32 ulp of the
    new parameter (the resolution of new - old), over max |exact|."""
    out = {}
    for k, want in exact.items():
        ulp = torch.from_numpy(np.spacing(np.abs(after[k].numpy())).astype(np.float64))
        out[k] = float(((update[k] - want).abs() - ulp).clamp(min=0).max() / want.abs().max())
    return out


def test_mobilenetv2_train_step_matches_jax(zoo):
    """One step from the crossed weights, batch 8 at 32x32, no augmentation,
    dropout off, ``ce_loss``; float32 through the fused CE (the port's plain
    version; JAX's Pallas kernel in interpret mode), float64 through the
    plain CE with the JAX model built in float64.

    The float32 loss within 1e-5 relative, as ``test_torch_train_step`` holds
    it.  Batch 8, not 2: at batch 2 the ASPP pooling branch's BatchNorm
    normalizes two values per channel and the losses differ by 6e-5.  The
    running statistics at ``STAT_TOL``: 17 blocks of float32 convs in two
    summation orders move the deepest BatchNorm inputs apart (measured
    1.4e-5 of max|var| at ``features.16.conv.0.1``).

    Every parameter's update is held in float64, the port's against JAX's,
    within ``F64_TOL`` of the tensor's max|update| (measured 1.1e-7 over four
    batch seeds).  In float32 this step is ill-conditioned, so that
    ``test_torch_train_step``'s 1e-3 cannot hold: beyond one ulp, the median
    tensor lies 3e-3 to 2.8e-2 from the float64 step on either side over
    four batch seeds, and the worst tensors are BatchNorm biases whose exact
    gradient is 0 or that normalize eight values a channel (the project BNs,
    the ASPP pooling branch).  Each tensor of both float32 updates is held
    within ``F32_LIMIT`` of the float64 one: the worst JAX reaches over those
    seeds is 0.19; at this batch JAX's worst is 6.9e-2 and the port's
    8.1e-2."""
    from iswm_tpu import models as jax_models
    from iswm_tpu.ops.pallas.fused_ce import fused_binary_ce

    jmodel, variables, model = zoo("mobilenetv2_os16")
    rng = np.random.default_rng(1)
    images, labels = zip(*(generate_scene(rng, size=(32, 32)) for _ in range(BATCH)))
    images = normalize(torch.from_numpy(np.stack(images)).float() / 255.0).numpy()
    labels = np.stack(labels).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255

    optim, total = OptimConfig(), 50
    ones = jnp.ones(2, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp, model)
        jax_loss, state, jax_update = _jax_update(
            jmodel, variables["params"], variables["batch_stats"], images, labels, optim,
            total, lambda lg, lb: fused_binary_ce(lg, lb, ones, 255, True))
        mp.setattr(jax_models, "_dtype", lambda name: jnp.float64)  # every dtype of the model
        with jax.enable_x64(True):
            jmodel64 = jax_models.build_model(ModelConfig(backbone="mobilenetv2"))
            params, stats = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                    variables[c]) for c in ("params", "batch_stats"))
            _, _, jax_exact = _jax_update(jmodel64, params, stats, images.astype(np.float64),
                                          labels, optim, total, _ce64)
    after_sd = state_dict_from_jax(state.params, state.batch_stats, backbone="mobilenetv2")

    loss, stepped, update = _port_update(model, images, labels, optim, total, torch.float32)
    _, _, exact = _port_update(model, images, labels, optim, total, torch.float64)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    assert assert_bn_stats_close(stepped.state_dict(), after_sd, STAT_TOL) == 51 + 9

    assert set(exact) <= set(jax_exact)
    for k, got in exact.items():
        want = jax_exact[k]
        assert float((got - want).abs().max()) <= F64_TOL * float(want.abs().max()), k
    for side, got in (("port", update), ("jax", jax_update)):
        dist = _update_distance(got, exact, stepped.state_dict() if side == "port" else after_sd)
        worst = max(dist, key=dist.get)
        assert dist[worst] <= F32_LIMIT, (side, worst, dist[worst])
