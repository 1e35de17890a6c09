"""The port's serving path against the JAX package's, on the CPU.

Calibration, int8 routing, the tile engine, the Predictor end to end and
the numpy copies of the JAX package's helpers.  Weights cross through a
perturbed reference-format .pth as in test_torch_models.py.  The JAX int8
kernel runs in interpret mode (the JAX package's own CPU route).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iswm_tpu.config import Config
from iswm_tpu.data.datasets import decode_target as jax_decode_target
from iswm_tpu.data.transforms import val_transform_batch as jax_val_transform_batch
from iswm_tpu.infer import products as jax_products
from iswm_tpu.infer import quantization as jq
from iswm_tpu.infer import tiling as jax_tiling
from iswm_tpu.infer.predictor import Predictor as JaxPredictor
from iswm_tpu_torch.data import decode_target, val_transform_batch
from iswm_tpu_torch.infer import products, tiling
from iswm_tpu_torch.compat import state_dict_from_jax
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.infer.predictor import Predictor

from .test_torch_models import crossed_models, jax_init

BACKBONE = "resnet18"


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    return crossed_models(tmp_path_factory.mktemp("ckpt"), BACKBONE, 16)


@pytest.fixture(scope="module")
def calib_images():
    return np.random.default_rng(2).normal(size=(2, 1, 32, 32, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_scales(crossed, calib_images):
    jmodel, v, _, _ = crossed
    return jq.calibrate_conv_inputs(
        jmodel, v["params"], v["batch_stats"], list(calib_images), wide=True
    )


def test_port_site_key_maps_jax_paths():
    assert pq.port_site_key("backbone/layer2_0/conv1/conv") == "backbone.layer2.0.conv1"
    assert pq.port_site_key("backbone/layer4_0/downsample/conv") == (
        "backbone.layer4.0.downsample.0")
    assert pq.port_site_key("head/aspp/pool/conv") == "classifier.aspp.convs.4.1"
    assert pq.port_site_key("head/cls0#p1") == "classifier.classifier.0#p1"
    assert pq.port_site_key("head/cls_out") == "classifier.classifier.6"


def test_calibration_scales_match_jax(crossed, calib_images, jax_scales):
    _, _, model, _ = crossed
    got = pq.calibrate_conv_inputs(model, [_nchw(x) for x in calib_images], wide=True)
    want = {pq.port_site_key(key): scale for key, scale in jax_scales.items()}
    assert set(got) == set(want) and "classifier.classifier.0#p1" in got  # a part each
    for name, scale in want.items():
        np.testing.assert_allclose(got[name], scale, rtol=1e-5, err_msg=name)


def test_int8_exec_routing_and_logits_match_jax(crossed, jax_scales):
    jmodel, v, model, _ = crossed
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jfn = jq.make_variant_fn(jmodel, v["batch_stats"], v["params"], "int8_exec",
                             conv_scales=jax_scales)
    want = np.asarray(jfn(jnp.asarray(x)))
    port_scales = {pq.port_site_key(k): s for k, s in jax_scales.items()
                   if "#p" not in k}
    fn = pq.make_variant_fn(model, "int8_exec", conv_scales=port_scales)
    assert set(fn.routed_sites) == {pq.port_site_key(k) for k in jfn.routed_sites}
    assert len(fn.routed_sites) == 4
    got = fn(torch.from_numpy(x)).numpy()
    agree, _ = pq.logit_diff_verdict(got, want)
    assert agree >= 0.999
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("output_stride,n_sites", [(16, 30), (8, 31)])
def test_resnet50_routes_the_jax_sites(output_stride, n_sites):
    """Each side calibrates itself; the routed 1x1 sites are the same
    (30 at OS 16; at OS 8 layer3.0's downsample has stride 1 too)."""
    cfg, jmodel, params, stats = jax_init("resnet50", output_stride)
    x = np.random.default_rng(8).normal(size=(1, 32, 32, 3)).astype(np.float32)
    jfn = jq.make_variant_fn(
        jmodel, stats, params, "int8_exec",
        conv_scales=jq.calibrate_conv_inputs(jmodel, params, stats, [x], wide=True),
    )
    jfn.inner.lower(jnp.asarray(x), *jfn.bound_args)  # tracing records the routes
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, stats, backbone="resnet50"))
    fn = pq.make_variant_fn(model, "int8_exec", conv_scales=pq.calibrate_conv_inputs(
        model, [_nchw(x)], wide=True))
    assert len(fn.routed_sites) == n_sites
    assert set(fn.routed_sites) == {pq.port_site_key(k) for k in jfn.routed_sites}


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_variants_match_jax(crossed, variant):
    jmodel, v, model, _ = crossed
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jq.make_variant_fn(
        jmodel, v["batch_stats"], v["params"], variant)(jnp.asarray(x)))
    fn = pq.make_variant_fn(model, variant)
    got = fn(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert pq.param_bytes(fn.stored_params) == jq.param_bytes(
        jq.make_variant_fn(jmodel, v["batch_stats"], v["params"], variant).stored_params)


def test_unported_variants_are_refused(crossed):
    """int8_exec_xla is ported: make_variant_fn and compare_variants run it;
    what stays refused or needs its calibration says so."""
    model = crossed[2]
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 32, 32, 3)).astype(np.float32))
    scales = pq.calibrate_conv_inputs(model, [x.permute(0, 3, 1, 2)], wide=True)
    fn = pq.make_variant_fn(model, "int8_exec_xla", conv_scales=scales)
    assert len(fn.routed_sites) == 29 and torch.isfinite(fn(x)).all()
    from .test_torch_evaluate_quantization import _scenes

    report = pq.compare_variants(model, _scenes(2, seed=9), ("f32", "int8_exec_xla"),
                                 sequence_length=3)
    r = report["int8_exec_xla"]
    assert np.isfinite([r[k] for k in ("avg_latency_ms", "miou", "mask_agreement")]).all()
    assert r["size_mb"] == pq.param_bytes(fn.stored_params) / 1e6
    with pytest.raises(ValueError, match="conv_scales"):
        pq.make_variant_fn(model, "int8_exec_xla")
    # int8_exec ignores int8_grouped / int8_stem, as the JAX package does
    assert pq.make_variant_fn(model, "int8_exec", conv_scales=scales, grouped=True,
                              stem=True).routed_sites == pq.make_variant_fn(
        model, "int8_exec", conv_scales=scales).routed_sites
    with pytest.raises(ValueError, match="act_scales"):  # ported: needs its calibration
        pq.make_variant_fn(model, "int8_act")
    # a QAT model serves: its routed convs run int8 with dynamic scales in
    # eval mode; only QAT's int8 backward stays refused
    from iswm_tpu_torch.models import build_model_by_name

    qat = build_model_by_name("deeplabv3plus_resnet18", int8_training=64,
                              compute_dtype="float32")
    qat.load_state_dict(model.state_dict(), strict=True)
    assert torch.isfinite(pq.make_variant_fn(qat, "bf16")(x)).all()
    with pytest.raises(NotImplementedError,
                       match="'Quantization-aware training, int8 backward'"):
        build_model_by_name("deeplabv3plus_resnet18", int8_training=64, int8_training_bwd=True)


@pytest.mark.parametrize("hw", [(100, 150), (20, 25)])  # ragged; under half a tile
def test_tile_engine_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(5)
    scene = rng.normal(size=(h, w, 3)).astype(np.float32)
    mix = rng.normal(size=(3, 2)).astype(np.float32)

    jengine = jax_tiling.TileEngine(lambda t: jnp.tanh(t @ mix), tile=64,
                                    overlap=16, batch=3)
    mix_t = torch.from_numpy(mix)
    engine = tiling.TileEngine(lambda t: torch.tanh(t @ mix_t), tile=64,
                               overlap=16, batch=3)
    want = np.asarray(jengine.infer_scene(jnp.asarray(scene)))
    got = engine.infer_scene(torch.from_numpy(scene)).numpy()
    assert got.shape == (h, w, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["bf16", "int8_exec"])
def test_predictor_matches_jax(crossed, variant):
    ckpt = crossed[3]
    cfg = Config()
    cfg.model.backbone = BACKBONE
    cfg.model.compute_dtype = "float32"
    cfg.predict.serving_variant = variant
    cfg.predict.tile_size, cfg.predict.tile_overlap, cfg.predict.tile_batch = 64, 16, 2
    image = np.random.default_rng(6).integers(0, 256, (100, 150, 3), dtype=np.uint8)
    jpred = JaxPredictor(cfg, ckpt_path=ckpt)
    pred = Predictor(cfg, ckpt_path=ckpt, device="cpu")
    want, got = jpred.predict_image(image), pred.predict_image(image)
    assert (got["mask"] == want["mask"]).mean() >= 0.999
    if variant == "bf16":
        np.testing.assert_allclose(got["prob_fg"], want["prob_fg"], atol=1e-4)
    else:
        # Each side calibrates its own scales; ulp-level activation
        # differences then flip single int8 levels, which move the logits
        # of one region by ~0.5% of max |logit| on this scene, so the
        # engines' logits are held to the int8 bound of the logits test.
        want_l = np.asarray(jpred.engine.infer_scene(
            jax_val_transform_batch(jnp.asarray(image)[None])[0]))
        got_l = pred.engine.infer_scene(
            val_transform_batch(torch.from_numpy(image))).numpy()
        assert np.abs(got_l - want_l).max() <= 1e-2 * np.abs(want_l).max()
    for key in ("mask", "confidence", "rgb"):
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype


def test_numpy_copies_equal_jax():
    rng = np.random.default_rng(7)
    prob = rng.random((40, 60)).astype(np.float32)
    np.testing.assert_array_equal(products.prob_to_mask(prob, 0.3),
                                  jax_products.prob_to_mask(prob, 0.3))
    conf = products.confidence_map(prob)
    np.testing.assert_array_equal(conf, jax_products.confidence_map(prob))
    mask = products.prob_to_mask(prob, 0.9)
    np.testing.assert_array_equal(decode_target(mask), jax_decode_target(mask))
    assert products.has_internal_wave(mask) == jax_products.has_internal_wave(mask)
    kw = dict(min_prob=0.2, max_prob=0.7, pred_mask=decode_target(mask * 0),
              enable_wave_processing=True, synthetic_prob=1.0, force_style="linear")
    np.testing.assert_array_equal(
        products.binarize_confidence_map(conf, rng=random.Random(0), **kw),
        jax_products.binarize_confidence_map(conf, rng=random.Random(0), **kw),
    )
    for size, tile, stride in ((100, 64, 48), (64, 64, 48), (30, 64, 48), (1000, 512, 448)):
        np.testing.assert_array_equal(tiling.tile_origins(size, tile, stride),
                                      jax_tiling.tile_origins(size, tile, stride))
    for tile, overlap in ((64, 16), (512, 64), (32, 0)):
        np.testing.assert_array_equal(tiling._blend_window(tile, overlap),
                                      jax_tiling._blend_window(tile, overlap))


@pytest.mark.parametrize("size,padded", [(5, 64), (1, 4), (7, 7), (3, 10)])
def test_reflect_indices_match_numpy(size, padded):
    x = np.arange(size)
    np.testing.assert_array_equal(tiling._reflect_indices(size, padded),
                                  np.pad(x, (0, padded - size), mode="reflect"))
