"""The port's ``Trainer`` end to end on the CPU: synthetic data written to
disk, resnet18 at crop 32, batch 2, six steps, a validation every three
with 3-frame windows, the best checkpoint, and a continued run."""

import json

import numpy as np
import pytest
import torch

from iswm_tpu.compat.torch_import import load_reference_checkpoint
from iswm_tpu.config import Config
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.train import Trainer
from iswm_tpu_torch.train import checkpoint as ckpt_lib

from .test_torch_train import few_torch_threads  # noqa: F401  (an autouse fixture)


def _config(root):
    cfg = Config()
    cfg.model.backbone = "resnet18"
    cfg.model.compute_dtype = "float32"
    cfg.data.data_root = str(root / "data")
    cfg.data.synthetic = True
    cfg.data.synthetic_train_size = 6
    cfg.data.synthetic_val_size = 8
    cfg.data.synthetic_image_size = 40
    cfg.data.crop_size = 32
    cfg.data.batch_size = 2
    cfg.data.val_batch_size = 4
    cfg.metrics.sequence_length = 3
    cfg.train.total_itrs = 6
    cfg.train.val_interval = 3
    cfg.train.print_interval = 2
    cfg.train.val_dump_limit = 2
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(root / name))
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("run")
    trainer = Trainer(_config(root), device="cpu")
    result = trainer.fit()
    return root, trainer, result


def test_fit_runs_steps_logs_and_validates(trained):
    root, trainer, result = trained
    assert trainer.state.step == 6
    records = [json.loads(line) for line in (root / "log_dir" / "metrics.jsonl").open()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert [r["step"] for r in records if "train_loss" in r] == [2, 4, 6]
    assert all(np.isfinite(losses))
    assert [r["step"] for r in records if "weighted_score" in r] == [3, 6]
    assert result["best_weighted_score"] == trainer.best_weighted
    lrs = [r["lr"] for r in records if "lr" in r]
    assert lrs == sorted(lrs, reverse=True)  # cosine decay
    assert (root / "log_dir" / "config.yaml").exists()


def test_best_checkpoint_is_reference_format(trained):
    root, trainer, _ = trained
    path = ckpt_lib.find_best(str(root / "checkpoints_dir"))
    assert path == trainer.best_path and path.endswith(".pth")
    assert "best_deeplabv3plus_resnet18_binary_os16_weighted" in path
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state", "optimizer_state", "scheduler_state", "cur_itrs",
                "best_score", "weighted_score", "val_score", "save_time", "model_config"):
        assert key in payload, key
    params, batch_stats, meta = load_reference_checkpoint(path, backbone="resnet18")
    assert meta["cur_itrs"] == payload["cur_itrs"] in (3, 6)
    np.testing.assert_array_equal(
        np.asarray(params["head"]["cls_out"]["kernel"])[0, 0],
        payload["model_state"]["classifier.classifier.6.weight"][:, :, 0, 0].numpy().T)
    fresh = build_model(trainer.cfg.model)
    fresh.load_state_dict(payload["model_state"], strict=True)
    dumps = list((root / "val_results_dir").glob("best_model_iter_*"))
    assert dumps and all(len(list(d.glob("*_overlay.png"))) == 2 for d in dumps)


def test_continue_training_restores_step_and_optimizer(trained, tmp_path):
    root, trainer, _ = trained
    latest = ckpt_lib.save_latest(str(tmp_path), trainer.state, weighted_score=0.5)
    cfg = _config(root)
    cfg.train.ckpt = latest
    cfg.train.continue_training = True
    cfg.train.total_itrs = 7
    cfg.train.log_dir = str(tmp_path / "logs")
    again = Trainer(cfg, device="cpu")
    assert again.state.step == 6 and again.best_weighted == 0.5
    assert again.state.scheduler.last_epoch == trainer.state.scheduler.last_epoch == 6
    want = trainer.state.optimizer.state_dict()["state"]
    got = again.state.optimizer.state_dict()["state"]
    assert set(got) == set(want) and len(got) > 50
    for i in want:
        assert torch.equal(got[i]["momentum_buffer"], want[i]["momentum_buffer"])
    again.fit()
    assert again.state.step == 7
    # without continue_training only the weights load; the step starts at 0
    cfg.train.continue_training = False
    fresh = Trainer(cfg, device="cpu")
    assert fresh.state.step == 0 and not fresh.state.optimizer.state_dict()["state"]
    sd = fresh.state.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in trainer.state.model.state_dict().items())
