"""The port's evaluation paths against the JAX package's, on the CPU:
activation calibration and the ``int8_act`` variant, ``evaluate_variant``,
``compare_variants``, ``format_report``, ``EvaluationDataset``, the
quantization CLI's refusals and the trainer's quick-eval series.

resnet18, float32, 32x32 inputs made from numpy seeds; the weights cross
through a perturbed reference-format .pth as in test_torch_models.py.
Tolerances: calibrated scales 1e-5 relative (an absmax of float32
activations that differ by summation order); ``int8_act`` logits
1e-2 * max|logit| with mask agreement >= 0.99 (an ulp-level difference in an
activation can flip one int8 level at a site, as for ``int8_exec``);
float32 reports equal in every metric.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iswm_tpu.data.datasets import EvaluationDataset as JaxEvaluationDataset
from iswm_tpu.infer import quantization as jq
from iswm_tpu_torch.cli import evaluate_quantization as cli
from iswm_tpu_torch.config import Config
from iswm_tpu_torch.data import ArrayDataset, EvaluationDataset, batch_iterator, generate_scene
from iswm_tpu_torch.data.synthetic import write_dataset
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.metrics.device import foreground_metrics_from_cm
from iswm_tpu_torch.ops.kernels import confusion as pcm
from iswm_tpu_torch.train import Trainer
from iswm_tpu_torch.utils import Visualizer

from .test_torch_models import crossed_models
from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    return crossed_models(tmp_path_factory.mktemp("ckpt"), "resnet18", 16)


@pytest.fixture(scope="module")
def calib_images():
    return np.random.default_rng(2).normal(size=(2, 1, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_act_scales(crossed, calib_images):
    jmodel, v, _, _ = crossed
    return jq.calibrate_activations(jmodel, v["params"], v["batch_stats"], list(calib_images))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _scenes(n, seed=0, size=(32, 32)):
    rng = np.random.default_rng(seed)
    images, masks = zip(*(generate_scene(rng, size=size) for _ in range(n)))
    return ArrayDataset(np.stack(images), np.stack(masks))


# ------------------------------------------------------------ activation sites
def test_port_act_site_key_maps_jax_paths():
    assert pq.port_act_site_key("backbone/stem") == "backbone.conv1"
    assert pq.port_act_site_key("backbone/layer2_0/conv1") == "backbone.layer2.0.conv1"
    assert pq.port_act_site_key("backbone/layer4_0/downsample") == (
        "backbone.layer4.0.downsample.0")
    assert pq.port_act_site_key("head/aspp/pool") == "classifier.aspp.convs.4.1"
    assert pq.port_act_site_key("head/cls1") == "classifier.classifier.3"
    with pytest.raises(KeyError):
        pq.port_act_site_key("head/nowhere")


def test_activation_scales_match_jax_site_by_site(crossed, calib_images, jax_act_scales):
    _, _, model, _ = crossed
    got = pq.calibrate_activations(model, [_nchw(x) for x in calib_images])
    want = {pq.port_act_site_key(k): s for k, s in jax_act_scales.items()}
    assert len(want) == len(jax_act_scales) == 28
    assert set(got) == set(want) == set(pq.activation_sites(model))
    assert "classifier.classifier.0" not in got  # the concat conv is no site in JAX
    for name, scale in want.items():
        np.testing.assert_allclose(got[name], scale, rtol=1e-5, err_msg=name)
    # max_batches cuts the pass short, as in JAX
    one = pq.calibrate_activations(model, [_nchw(x) for x in calib_images], max_batches=1)
    j_one = jq.calibrate_activations(crossed[0], crossed[1]["params"],
                                     crossed[1]["batch_stats"], list(calib_images), 1)
    for key, scale in j_one.items():
        np.testing.assert_allclose(one[pq.port_act_site_key(key)], scale, rtol=1e-5)


def test_resnet50_sites_are_the_jax_sites():
    """Bottlenecks: conv1/conv2 after their ReLU, conv3 and downsample after
    their BatchNorm."""
    from iswm_tpu_torch.models import build_model_by_name

    from .test_torch_models import port_init

    _, jmodel, params, stats = port_init("resnet50", 16)
    x = np.zeros((1, 32, 32, 3), np.float32)
    keys = jq.calibrate_activations(jmodel, params, stats, [jnp.asarray(x)])
    model = build_model_by_name("deeplabv3plus_resnet50", compute_dtype="float32")
    sites = pq.activation_sites(model)
    assert {pq.port_act_site_key(k) for k in keys} == set(sites) and len(sites) == 61
    block = model.backbone.layer1[0]
    assert sites["backbone.layer1.0.conv2"] is block.relu2
    assert sites["backbone.layer1.0.conv3"] is block.bn3
    assert sites["backbone.layer1.0.downsample.0"] is block.downsample[1]
    assert sites["backbone.conv1"] is model.backbone.relu
    assert block.relu is not block.relu1 and "backbone.layer1.0.relu" not in "".join(sites)


def test_zero_activation_site_gets_scale_one(crossed):
    _, _, model, _ = crossed
    import copy

    dead = copy.deepcopy(model)
    with torch.no_grad():
        dead.classifier.project[1].weight.zero_()
        dead.classifier.project[1].bias.fill_(-1.0)  # ReLU of a negative constant: all 0
    scales = pq.calibrate_activations(dead, [torch.zeros(1, 3, 32, 32)])
    assert scales["classifier.project.0"] == 1.0


# -------------------------------------------------------------------- int8_act
def test_int8_act_logits_match_jax(crossed, jax_act_scales):
    jmodel, v, model, _ = crossed
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jfn = jq.make_variant_fn(jmodel, v["batch_stats"], v["params"], "int8_act",
                             act_scales=jax_act_scales)
    want = np.asarray(jfn(jnp.asarray(x)))
    # JAX-calibrated scales load into the port through port_act_site_key
    scales = {pq.port_act_site_key(k): s for k, s in jax_act_scales.items()}
    fn = pq.make_variant_fn(model, "int8_act", act_scales=scales)
    got = fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    agree, _ = pq.logit_diff_verdict(got, want)
    assert agree >= 0.99
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert pq.param_bytes(fn.stored_params) == jq.param_bytes(jfn.stored_params)
    # the fake quantization is there: int8_act differs from weight-only int8,
    # and the source model is left without hooks
    weight_only = pq.make_variant_fn(model, "int8")(torch.from_numpy(x)).numpy()
    assert np.abs(got - weight_only).max() > 0
    assert not any(m._forward_hooks for m in model.modules())
    with pytest.raises(ValueError, match="act_scales"):
        pq.make_variant_fn(model, "int8_act")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fake_quantize_matches_jax_rounding(dtype):
    """Half to even, clipped at 127 levels, back in the activation's dtype."""
    scale = 0.5
    x = np.array([0.25, 0.75, 1.25, 100.0, -0.25, -3.1, 0.0], np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = (jnp.clip(jnp.round(jx.astype(jnp.float32) / scale), -127, 127) * scale).astype(dtype)
    out = pq.fake_quantize(torch.from_numpy(x).to(getattr(torch, dtype)), scale)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(out.float().numpy(), [0.0, 1.0, 1.0, 63.5, -0.0, -3.0, 0.0])


# ------------------------------------------------------------ evaluate_variant
class _OracleFn:
    """A 'model' whose logits are the one-hot of a stored mask per call."""

    device = torch.device("cpu")

    def __init__(self, masks, framework):
        self.masks, self.framework, self.calls = masks, framework, 0

    def __call__(self, x):
        onehot = np.eye(2, dtype=np.float32)[self.masks[self.calls]][None]
        self.calls += 1
        return jnp.asarray(onehot) if self.framework == "jax" else torch.from_numpy(onehot)


@pytest.mark.parametrize("n", [2, 5])
def test_evaluate_variant_windows_match_jax(n):
    """Five samples: three windows of three frames; two: each alone."""
    ds = _scenes(n, seed=4)
    rng = np.random.default_rng(5)
    preds = [np.where(rng.random(m.shape) < 0.1, 1 - m, m) for m in ds._masks]
    want = jq.evaluate_variant(_OracleFn(preds, "jax"), ds, sequence_length=3)
    got = pq.evaluate_variant(_OracleFn(preds, "torch"), ds, sequence_length=3)
    assert set(got) == set(want) == {"avg_latency_ms", "miou", "fiou", "ff1", "weighted"}
    for key in ("miou", "fiou", "ff1", "weighted"):
        assert got[key] == want[key], key
    assert got["avg_latency_ms"] > 0
    cut = pq.evaluate_variant(_OracleFn(preds, "torch"), ds, sequence_length=3, max_images=1)
    assert cut["avg_latency_ms"] == 0.0  # the first image is the warm-up


# ------------------------------------------------------------ compare_variants
def test_compare_variants_report_matches_jax(crossed):
    jmodel, v, model, _ = crossed
    ds = _scenes(4, seed=6)
    variants = ("f32", "int8_act")
    want = jq.compare_variants(jmodel, v["params"], v["batch_stats"], ds, variants,
                               sequence_length=3, calibration_batches=2)
    got = pq.compare_variants(model, ds, variants, sequence_length=3, calibration_batches=2)
    assert list(got) == list(want) == list(variants)
    for name in variants:
        assert set(got[name]) == set(want[name]), name
    for key in ("miou", "fiou", "ff1", "weighted", "size_mb", "mask_agreement", "verdict"):
        assert got["f32"][key] == want["f32"][key], key  # the float32 reference: equal
    assert got["f32"]["verdict"] == "reference variant"
    q, jq_ = got["int8_act"], want["int8_act"]
    assert q["size_mb"] == jq_["size_mb"] and q["size_reduction"] == jq_["size_reduction"]
    assert abs(q["mask_agreement"] - jq_["mask_agreement"]) <= 5e-3
    bounds = [b for b, _ in pq.AGREEMENT_TIERS]
    if not any(min(q["mask_agreement"], jq_["mask_agreement"]) < b
               <= max(q["mask_agreement"], jq_["mask_agreement"]) for b in bounds):
        assert q["verdict"] == jq_["verdict"]
    for key in ("miou", "fiou", "ff1"):
        assert abs(q[key] - jq_[key]) <= 1e-2, key
        assert q[f"{key}_delta"] == q[key] - got["f32"][key]
    assert q["speedup"] > 0


def test_compare_variants_runs_every_ported_variant(tmp_path):
    from iswm_tpu_torch.models import build_model_by_name

    model = build_model_by_name("deeplabv3plus_resnet18", compute_dtype="float32")
    variants = ("f32", "bf16", "int8", "int8_act", "int8_exec")
    report = pq.compare_variants(model, _scenes(3, seed=8), variants, sequence_length=7,
                                 comparison_dir=str(tmp_path))
    assert list(report) == list(variants)
    for name, r in report.items():
        assert np.isfinite([r[k] for k in ("avg_latency_ms", "miou", "fiou", "ff1",
                                           "weighted", "size_mb", "mask_agreement")]).all()
    assert report["f32"]["size_mb"] == 2 * report["bf16"]["size_mb"]
    assert report["int8"]["size_mb"] == report["int8_act"]["size_mb"] == (
        report["int8_exec"]["size_mb"])
    assert (tmp_path / "variant_comparison.png").stat().st_size > 0
    text = pq.format_report(report)
    assert len(text.splitlines()) == 7


def _report():
    base = {"avg_latency_ms": 12.3456, "size_mb": 161.39, "miou": 0.61234, "fiou": 0.3,
            "ff1": 0.46, "weighted": 0.5, "mask_agreement": 1.0, "verdict": "reference variant"}
    other = dict(base, avg_latency_ms=6.5, size_mb=40.52, miou=0.6, miou_delta=-0.01234,
                 speedup=1.8993, mask_agreement=0.99912,
                 verdict=pq.AGREEMENT_TIERS[0][1])
    return base, other


def test_format_report_equals_jax():
    base, other = _report()
    report = {"f32": base, "bf16": other, "int8_exec": dict(other, verdict="")}
    assert pq.format_report(report) == jq.format_report(report)
    with_note = {"f32": base, "int8": other}
    got, want = pq.format_report(with_note), jq.format_report(with_note)
    assert got.splitlines()[:-1] == want.splitlines()[:-1]  # the table, letter for letter
    note = got.splitlines()[-1]
    assert note.startswith("note: 'int8' is weight-only") and "CUDA kernel" in note
    assert "MXU" not in note and "v5e" not in note
    assert pq.AGREEMENT_TIERS == jq.AGREEMENT_TIERS


# ------------------------------------------------------ dataset, panels, CLI
def test_evaluation_dataset_matches_jax(tmp_path):
    write_dataset(str(tmp_path), n_train=3, n_val=0, size=(24, 30), seed=1)
    root = str(tmp_path / "train")  # a flat root with imgs/ + masks/
    (tmp_path / "train" / "masks" / "H09_20250101_0015_mask.png").unlink()
    want, got = JaxEvaluationDataset(root, split=""), EvaluationDataset(root, split="")
    assert got.images == want.images and len(got) == len(want) == 3
    for i in range(3):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
        assert got[i][2] == got.images[i] and got[i][1].dtype == np.uint8
    assert not got[1][1].any()  # a missing mask reads as background


def test_visualizer_writes_panels(tmp_path):
    vis = Visualizer(str(tmp_path / "vis"))
    image, mask = generate_scene(np.random.default_rng(0), size=(24, 24))
    path = vis.vis_segmentation_panel("a panel", image, gt=mask * 255, pred=mask * 255)
    assert path.endswith("a_panel.png")
    for p in (path, vis.vis_scalar("loss", [3.0, 2.0, 1.0]), vis.vis_image("img", image)):
        assert (tmp_path / "vis").joinpath(p.rsplit("/", 1)[1]).stat().st_size > 0


def test_cli_flags_and_refusals(tmp_path, capsys):
    import iswm_tpu.cli.evaluate_quantization as jax_cli

    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices, a.required)
                for a in parser._actions if a.dest not in (
                    "help", "platform", "device", "int8_grouped", "int8_stem")}

    assert actions(cli.get_argparser()) == actions(jax_cli.get_argparser())
    assert cli.get_argparser().parse_args(["--data_dir", "x"]).device == "cuda"
    write_dataset(str(tmp_path), n_train=2, n_val=0, size=(24, 24), seed=2)
    data = str(tmp_path / "train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["--data_dir", data])
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="iswm_tpu.cli.export_torch"):
        cli.main(["--data_dir", data, "--device", "cpu", "--ckpt", str(orbax),
                  "--model", "deeplabv3plus_resnet18"])
    assert cli.main(["--data_dir", data, "--device", "cpu", "--variants", "f32,int8_exec_xla",
                     "--model", "deeplabv3plus_resnet18", "--compute_dtype", "float32",
                     "--int8_stem", "--sequence_length", "3"]) == 0
    assert "int8_exec_xla" in capsys.readouterr().out


# ------------------------------------------------------------------ quick-eval
def test_quick_eval_series(tmp_path):
    """quick_eval_interval emits CM-metric points between full validations:
    steps 2 and 4 quick-eval; step 6 is the full validation instead."""
    cfg = Config()
    cfg.model.backbone = "resnet18"
    cfg.model.compute_dtype = "float32"
    cfg.data.data_root = str(tmp_path / "data")
    cfg.data.synthetic = True
    cfg.data.synthetic_image_size = 40
    cfg.data.crop_size = 32
    cfg.data.batch_size = 8
    cfg.data.synthetic_train_size = 8
    cfg.data.synthetic_val_size = 4
    cfg.data.val_batch_size = 2
    cfg.metrics.sequence_length = 3
    cfg.train.total_itrs = 6
    cfg.train.val_interval = 6
    cfg.train.quick_eval_interval = 2
    cfg.train.print_interval = 2
    cfg.train.save_val_results = False
    for k in ("log_dir", "checkpoints_dir", "val_results_dir", "metrics_plots_dir"):
        setattr(cfg.train, k, str(tmp_path / k))
    before = pcm.launches
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    assert pcm.launches == before  # CPU tensors: the plain version, no launch

    quick = {}
    with open(tmp_path / "log_dir" / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if "quick_fiou" in rec:
                quick[rec["step"]] = rec
                assert 0.0 <= rec["quick_miou"] <= 1.0
                assert {"quick_miou", "quick_fiou", "quick_precision", "quick_recall",
                        "quick_f1"} <= set(rec)
    assert sorted(quick) == [2, 4]
    assert trainer.logger.history["quick_miou"] and len(trainer.logger.history["quick_f1"]) == 2

    # the quick metrics are those of a confusion matrix counted pixel by pixel
    # from the same model's predictions
    again = trainer.quick_eval()
    counted = np.zeros((2, 2), np.float32)
    for images, labels in batch_iterator(trainer.val_ds, 2, epochs=1):
        preds = trainer.eval_step(torch.from_numpy(images))["preds"].numpy()
        for g, p in zip(labels.ravel(), preds.ravel()):
            if g in (0, 1):
                counted[g, p] += 1
    want = foreground_metrics_from_cm(torch.from_numpy(counted))
    assert sorted(again) == sorted(want)
    for key, value in again.items():
        assert value == pytest.approx(float(want[key]), abs=1e-6), key
