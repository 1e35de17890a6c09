"""The port's own copies of the JAX package's framework-free modules are
equal to the originals: configuration, the host metrics engine, the
reference-format weight bridge and the train CLI's parser.

Same numpy code on the same seeded inputs, so every comparison is exact.
"""

import dataclasses

import jax
import numpy as np
import pytest

import iswm_tpu.config as jax_config
import iswm_tpu.metrics as jax_metrics
import iswm_tpu_torch.config as port_config
import iswm_tpu_torch.metrics as port_metrics
from iswm_tpu.cli import train as jax_train_cli
from iswm_tpu.compat import torch_import as jax_bridge
from iswm_tpu_torch.cli import train as port_train_cli
from iswm_tpu_torch.compat import torch_import as port_bridge
from iswm_tpu_torch.data.synthetic import generate_scene

from .test_torch_models import jax_init

SECTIONS = [f.name for f in dataclasses.fields(jax_config.Config)]


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("section", SECTIONS)
def test_config_section_equals_jax(section):
    """Field for field: names, order, types and defaults."""
    want = type(getattr(jax_config.Config(), section))
    got = type(getattr(port_config.Config(), section))
    assert got.__name__ == want.__name__
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == [
        (f.name, f.type) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def test_config_yaml_round_trip_crosses_packages(tmp_path):
    cfg = port_config.Config()
    cfg.model.backbone, cfg.data.scale_range = "resnet18", (0.75, 1.5)
    cfg.train.quick_eval_interval, cfg.metrics.weights["MIoU"] = 7, 0.5
    cfg.to_yaml(str(tmp_path / "port.yaml"))
    theirs = jax_config.Config.from_yaml(str(tmp_path / "port.yaml"))
    assert theirs.to_dict() == cfg.to_dict()
    assert theirs.data.scale_range == (0.75, 1.5)  # tuples survive the YAML lists
    theirs.to_yaml(str(tmp_path / "jax.yaml"))
    assert port_config.Config.from_yaml(str(tmp_path / "jax.yaml")).to_dict() == cfg.to_dict()
    assert port_config.aspp_dilations(8) == jax_config.aspp_dilations(8) == (12, 24, 36)
    assert port_config.aspp_dilations(16) == jax_config.aspp_dilations(16) == (6, 12, 18)


BAD_CONFIGS = {
    "output_stride": ("model", "output_stride", 4),
    "loss_type": ("loss", "loss_type", "dice"),
    "optimizer": ("optim", "optimizer", "lamb"),
    "schedule": ("optim", "schedule", "step"),
    "num_classes": ("model", "num_classes", 1),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_config_validate_refuses_as_jax(name):
    section, key, value = BAD_CONFIGS[name]
    messages = []
    for module in (jax_config, port_config):
        cfg = module.Config()
        assert cfg.validate() is cfg
        setattr(getattr(cfg, section), key, value)
        with pytest.raises(ValueError) as err:
            cfg.validate()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("bad", [{"nope": {}}, {"model": {"nope": 1}}, {"model": 3}])
def test_config_from_dict_refuses_as_jax(bad):
    errors = []
    for module in (jax_config, port_config):
        with pytest.raises((KeyError, TypeError)) as err:
            module.Config.from_dict(bad)
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------- metrics
def _random_windows(seed, n=4, t=5, hw=(40, 48)):
    rng = np.random.default_rng(seed)
    gts = (rng.random((n, t, *hw)) < 0.3).astype(np.uint8)
    preds = np.where(rng.random(gts.shape) < 0.15, 1 - gts, gts).astype(np.uint8)
    gts[0, 0, :3] = 255
    return gts, preds


def _wave_windows(seed, n=3, t=5, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    gts = np.stack([np.stack([generate_scene(rng, size=hw)[1] for _ in range(t)])
                    for _ in range(n)])
    preds = np.roll(gts, 2, axis=-1)  # the same fronts, two columns to the right
    preds[:, -1] = 0  # and a missed last frame
    return gts, preds


@pytest.mark.parametrize("make", [_random_windows, _wave_windows])
@pytest.mark.parametrize("sequence_data", [True, False])
def test_stream_metrics_equal_jax(make, sequence_data):
    gts, preds = make(11)
    results = []
    for module in (jax_metrics, port_metrics):
        m = module.StreamMetrics(2, sequence_length=gts.shape[1])
        for g, p in zip(gts, preds):
            if sequence_data:
                m.update(g, p, sequence_data=True)
            else:
                for gi, pi in zip(g, p):
                    m.update(gi, pi, sequence_data=False)
        res = m.get_results()
        results.append((res, m.confusion_matrix.copy(), module.weighted_score(res)))
    (want, want_cm, want_ws), (got, got_cm, got_ws) = results
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got_cm, want_cm)
    assert got_ws == want_ws
    assert port_metrics.DEFAULT_WEIGHTS == jax_metrics.DEFAULT_WEIGHTS
    assert port_metrics.MAX_FTE == jax_metrics.MAX_FTE


EVALUATORS = {
    # name: (constructor arguments, the summaries compared)
    "FrontTrackingMetrics": ({}, ("get_mean_error",)),
    "TemporalMetrics": ({"sequence_length": 3}, ("get_mean_score", "get_latest_score",
                                                 "get_detailed_statistics")),
    "RegionMetrics": ({}, ("get_mean_score", "get_statistics")),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
@pytest.mark.parametrize("make", [_random_windows, _wave_windows])
def test_evaluators_equal_jax(name, make):
    """Frame by frame: each update's return value, then the summaries."""
    gts, preds = make(5)
    kwargs, summaries = EVALUATORS[name]
    outs = []
    for module in (jax_metrics, port_metrics):
        ev = getattr(module, name)(**kwargs)
        per_frame = [ev.update(p, g) for gw, pw in zip(gts, preds) for g, p in zip(gw, pw)]
        outs.append((per_frame, [getattr(ev, fn)() for fn in summaries]))
    assert repr(outs[0]) == repr(outs[1])
    assert any(v is not None for v in outs[1][0])


@pytest.mark.parametrize("make", [_random_windows, _wave_windows])
def test_mask_primitives_equal_jax(make):
    gts, preds = make(9)
    for fn in ("preprocess_mask", "find_front_positions", "check_wave_presence"):
        for mask in (gts[0, 1], preds[1, 0]):
            want = getattr(jax_metrics, fn)(mask)
            got = getattr(port_metrics, fn)(mask)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=fn)
    for fn in ("calculate_motion", "calculate_stability"):
        want = getattr(jax_metrics, fn)(gts[1, 0], gts[1, 1])
        got = getattr(port_metrics, fn)(gts[1, 0], gts[1, 1])
        assert got == want, fn
    g, p = gts[0, 1].ravel(), preds[0, 1].ravel()
    hist = port_metrics.fast_hist(g, p, 2)
    np.testing.assert_array_equal(hist, jax_metrics.fast_hist(g, p, 2))
    assert port_metrics.foreground_metrics(hist) == jax_metrics.foreground_metrics(hist)


# ------------------------------------------------------------ weight bridge
@pytest.mark.parametrize("backbone", ["mobilenetv2", "resnet18", "resnet50", "xception"])
def test_state_dict_bridge_equals_jax(backbone):
    _, _, params, stats = jax_init(backbone, 16, seed=3)
    params, stats = jax.device_get(params), jax.device_get(stats)
    want = jax_bridge.export_torch_state_dict(params, stats, backbone=backbone)
    got = port_bridge.export_torch_state_dict(params, stats, backbone=backbone)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    sd = {f"module.{k}": v for k, v in want.items()}  # a DataParallel checkpoint
    want_trees = jax_bridge.import_torch_state_dict(sd, backbone=backbone)
    got_trees = port_bridge.import_torch_state_dict(sd, backbone=backbone)
    for got_tree, want_tree, original in zip(got_trees, want_trees, (params, stats)):
        assert (jax.tree_util.tree_structure(got_tree)
                == jax.tree_util.tree_structure(want_tree))
        for g, w, o in zip(*(jax.tree_util.tree_leaves(t)
                             for t in (got_tree, want_tree, original))):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, np.asarray(o))  # and the round trip
    assert port_bridge.strip_module_prefix(sd).keys() == want.keys()


def test_reference_checkpoint_loads_as_jax(tmp_path):
    _, _, params, stats = jax_init("resnet18", 16, seed=4)
    path = str(tmp_path / "ref.pth")
    jax_bridge.save_reference_checkpoint(path, params, stats, backbone="resnet18",
                                         cur_itrs=12)
    want = jax_bridge.load_reference_checkpoint(path, backbone="resnet18")
    got = port_bridge.load_reference_checkpoint(path, backbone="resnet18")
    assert got[2] == want[2] == {"cur_itrs": 12}
    for g, w in zip(jax.tree_util.tree_leaves(got[:2]), jax.tree_util.tree_leaves(want[:2])):
        np.testing.assert_array_equal(g, w)


def test_bridge_refuses_an_unknown_backbone():
    for fn, args in ((port_bridge.export_torch_state_dict, ({}, {})),
                     (port_bridge.import_torch_state_dict, ({},))):
        with pytest.raises(ValueError, match="unknown backbone"):
            fn(*args, backbone="vgg16")


# --------------------------------------------------------------- train CLI
def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_train_parser_has_the_jax_flags_and_defaults():
    want, got = _actions(jax_train_cli.get_argparser()), _actions(port_train_cli.get_argparser())
    assert set(want) - {"platform"} == set(got) - {"device"}
    assert got["device"].default == "cuda"
    for dest in set(want) - {"platform"}:
        for attr in ("option_strings", "default", "type", "choices", "const", "nargs",
                     "required"):
            assert getattr(got[dest], attr) == getattr(want[dest], attr), (dest, attr)


FLAG_SETS = {
    "defaults": [],
    "synthetic_small": ["--synthetic", "--model", "deeplabv3plus_resnet18",
                        "--compute_dtype", "float32", "--crop_size", "32", "--batch_size", "2",
                        "--total_itrs", "6", "--val_interval", "3", "--sequence_length", "3",
                        "--quick_eval_interval", "2", "--sequence_val"],
    "optim": ["--optimizer", "adamw", "--lr", "0.001", "--weight_decay", "0.01",
              "--lr_schedule", "poly", "--loss_type", "IWce_loss", "--output_stride", "8",
              "--random_seed", "7", "--print_interval", "5"],
    "outputs": ["--ckpt", "a.pth", "--continue_training", "--checkpoints_dir", "c",
                "--val_results_dir", "v", "--metrics_plots_dir", "m", "--log_dir", "l",
                "--save_confidence_map", "--val_dump_limit", "0", "--enable_mlflow",
                "--data_root", "d", "--dataset", "binary", "--num_classes", "3",
                "--val_batch_size", "2"],
    "unported": ["--model", "deeplabv3_mobilenet", "--separable_conv", "--pretrained_backbone",
                 "--int8_training", "64", "--int8_scale_mode", "delayed", "--int8_bwd", "1",
                 "--int8_switch_iter", "100", "--int8_route", "cost", "--int8_cost_bytes",
                 "2.5", "--grouped_blockdiag", "256", "--test_only", "--step_size", "3",
                 "--training_stage", "x", "--gpu_id", "0", "--enable_vis"],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_build_config_equals_jax(name, capsys):
    flags = FLAG_SETS[name]
    want = jax_train_cli.build_config(jax_train_cli.get_argparser().parse_args(flags))
    want_out = capsys.readouterr().out
    got = port_train_cli.build_config(port_train_cli.get_argparser().parse_args(flags))
    assert capsys.readouterr().out == want_out  # the notes on dead flags
    assert isinstance(got, port_config.Config)
    assert got.to_dict() == want.to_dict()
