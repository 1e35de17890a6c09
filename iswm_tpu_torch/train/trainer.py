"""The training orchestrator, the counterpart of ``iswm_tpu/train/trainer.py``.

``Trainer(cfg, device, train_ds, val_ds).fit()``: prefetched uint8 batches
-> train step on the device (augment + forward + loss through the fused CE
kernel + backward + optimizer + schedule) -> every ``val_interval`` a
whole-set validation, sorted by file name and scored in
``sequence_length``-frame windows by the host ``StreamMetrics`` -> the best
checkpoint (``.pth``) and a dump of validation images.  Between validations,
every ``quick_eval_interval`` a quick-eval scores the validation set from a
confusion matrix kept on the device.  Losses stay on the device and are
read once per ``print_interval``.

In a process group (``parallel.maybe_initialize_distributed``) every rank
runs this loop on its rows of each global batch of ``cfg.data.batch_size``,
through the data-parallel step (``train/step.py``); validation, quick-eval,
checkpoints, logs and plots run on rank 0 while the others wait.

Quantization-aware training (``model.int8_training``) runs in the model's
routed convs; with ``train.int8_switch_iter`` the iterations from that one on
run the plain model: the same modules with QAT switched off
(``switch_off_int8``), so the optimizer's parameters and state carry over,
and the delayed mode's running amaxes are dropped.

``parallel.remat`` recomputes the forward's activations in the backward,
block by block (``models/remat.py``); ``model.param_dtype`` stores the
parameters, and so the gradients and the optimizer's state, in bfloat16 or
float16.

``parallel.model_axis`` above 1 splits the image rows of each step over the
ranks of a model group (``parallel/spatial.py``): the ranks form a (data,
model) grid (``parallel.make_mesh``), every rank of a model group reads the
rows of its data index and augments them alike.  Every backbone, QAT (with
its int8 backward) and remat run on a rank's rows, and the fused stem and
blocks on their model group's whole maps; the maps may split unevenly
(Xception's), so the crop size need only split evenly over the model axis
and leave every rank rows of the deepest map (``output_stride *
model_axis`` at least).

An option that the port does not carry would be refused with
``NotImplementedError`` naming its ROADMAP item (``refuse_unported``); none
is refused now.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..compat.pretrained import apply_pretrained_backbone
from ..config import Config
from ..data.class_weights import calculate_class_weights
from ..data.datasets import BinarySegmentation, batch_iterator, decode_target
from ..data.loader import device_prefetch_iterator
from ..data.synthetic import write_dataset, write_sequence_dataset
from ..data.transforms import AugmentConfig
from ..metrics import StreamMetrics
from ..metrics.device import DeviceEvalAccumulator
from ..models import build_model
from ..models.layers import switch_off_int8
from ..ops.losses import make_loss_fn
from ..parallel import is_initialized, local_device, make_mesh, rank
from . import checkpoint as ckpt_lib
from .best_score import is_best_score, update_best_score
from .logging import MetricsLogger, try_setup_mlflow
from .optim import make_optimizer
from .step import TrainState, data_parallel, make_eval_step, make_train_step


def refuse_unported(cfg: Config) -> None:
    """The one place where an option of ``cfg`` that the port does not carry
    yet is refused, with ``NotImplementedError`` naming its ROADMAP item.
    The port carries every option of the JAX package's ``Config``, the fused
    stem and blocks under a model axis above 1 the last: none is refused."""


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's random streams: ``seed`` on rank 0, so that one
    process draws as before, and apart on the others.  Augmentation takes
    the data index for ``rank`` (a model group crops and flips alike),
    dropout the rank."""
    return seed + (rank << 32)


class Trainer:
    """One training run on one device (``cuda``, ``cuda:1`` or ``cpu``), or
    one rank of a data-parallel run in the default process group, where
    ``cuda`` means this rank's card (``cuda:LOCAL_RANK``).

    Without ``train_ds`` / ``val_ds`` the data come from ``cfg.data``: the
    synthetic tree written under ``data_root/synthetic`` when
    ``cfg.data.synthetic``, else ``data_root/{train,val}``.  Any object with
    ``images``, ``__len__`` and ``__getitem__`` (``data.ArrayDataset``)
    serves as a dataset."""

    def __init__(self, cfg: Config, device: str = "cuda", train_ds=None, val_ds=None):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        refuse_unported(cfg)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for, but no CUDA card is "
                               "available (pass device='cpu' to train on the CPU)")
        self.mesh = make_mesh(cfg.parallel.data_axis, cfg.parallel.model_axis)
        if cfg.data.batch_size % self.mesh.data != 0:
            raise ValueError(
                f"batch_size ({cfg.data.batch_size}) must be divisible by the "
                f"mesh data axis ({self.mesh.data} devices); adjust batch_size "
                f"or pass a smaller mesh")
        crop, rows = cfg.data.crop_size, cfg.model.output_stride * self.mesh.model
        if self.mesh.model > 1 and (crop % self.mesh.model or crop < rows):
            raise ValueError(
                f"crop_size ({crop}) must be a multiple of model_axis ({self.mesh.model}), "
                f"and at least output_stride * model_axis ({cfg.model.output_stride} * "
                f"{self.mesh.model} = {rows}): the images split evenly over the model axis, "
                f"and every rank holds rows of the deepest map")
        if is_initialized() and self.device.type == "cuda" and self.device.index is None:
            self.device = local_device()
        self.rank = rank()
        self.lead = self.rank == 0  # validates, checkpoints and logs
        # the default generators (dropout) by rank, the augmentation by data index
        torch.manual_seed(rank_seed(cfg.train.random_seed, self.rank))
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # autotuned convs, as XLA's

        # ------------------------------------------------------------ data
        if train_ds is None or val_ds is None:
            root = self._data_root()
            train_ds = train_ds or BinarySegmentation(
                root, split="train", cache=cfg.data.cache_in_memory)
            val_ds = val_ds or BinarySegmentation(
                root, split="val", cache=cfg.data.cache_in_memory)
        self.train_ds, self.val_ds = train_ds, val_ds

        # ----------------------------------------------------------- model
        model = build_model(cfg.model, seed=cfg.train.random_seed)
        if cfg.model.pretrained_backbone:
            # the reference's default: ImageNet backbone, fresh head
            src = apply_pretrained_backbone(model, cfg.model.backbone, cfg.model.in_channels)
            if src and self.lead:
                print(f"initialized {cfg.model.backbone} backbone from {src}")
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        model.to(self.device, memory_format=memory_format)

        # ------------------------------------------------------------ loss
        self.class_weights = None
        if cfg.loss.loss_type == "IWce_loss":
            self.class_weights = calculate_class_weights(
                lbl for _, lbl in batch_iterator(self.train_ds, cfg.data.batch_size,
                                                 epochs=1))
            if self.lead:
                print(f"Class weights: {self.class_weights}")
        self.loss_fn = make_loss_fn(
            cfg.loss.loss_type, class_weights=self.class_weights,
            ignore_index=cfg.loss.ignore_index, focal_alpha=cfg.loss.focal_alpha,
            focal_gamma=cfg.loss.focal_gamma, fused=cfg.loss.fused_kernel,
            num_classes=cfg.model.num_classes, device=self.device,
        )

        # -------------------------------------------- optimizer and steps
        factory, self.schedule = make_optimizer(cfg.optim, cfg.train.total_itrs)
        optimizer, scheduler = factory(model.parameters())
        self.state = TrainState(model, optimizer, scheduler, 0,
                                data_parallel(model) if is_initialized() else None)
        self.augment = AugmentConfig(
            crop_size=cfg.data.crop_size, scale_min=cfg.data.scale_range[0],
            scale_max=cfg.data.scale_range[1], hflip_prob=cfg.data.hflip_prob,
            mean=tuple(cfg.data.mean), std=tuple(cfg.data.std),
        )
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.train.random_seed, self.mesh.data_index))
        self.train_step = make_train_step(self.loss_fn, augment=self.augment,
                                          generator=self.generator,
                                          remat=cfg.parallel.remat, mesh=self.mesh)
        self.eval_step = make_eval_step(model, want=("preds",))
        # the int8 -> plain switch (0: none)
        self._switch_iter = cfg.train.int8_switch_iter if cfg.model.int8_training else 0
        self.best_score: Optional[Dict[str, float]] = None
        self.best_weighted = 0.0
        self.best_path: Optional[str] = None

        # --------------------------------------------------------- logging
        self.logger = None
        if self.lead:
            self._start_logging()

        # --------------------------------------------------------- restore
        if cfg.train.ckpt:
            self._restore(cfg.train.ckpt, continue_training=cfg.train.continue_training)
        elif cfg.train.auto_resume:
            latest = ckpt_lib.find_latest(cfg.train.checkpoints_dir)
            if latest is not None:
                self._restore(latest, continue_training=True)

    def _start_logging(self) -> None:
        cfg = self.cfg
        tag = cfg.train.experiment_tag or time.strftime("%Y%m%d_%H%M%S")
        exp_name = (f"DeepLabV3Plus_{cfg.model.backbone}_{cfg.loss.loss_type}_"
                    f"{cfg.optim.optimizer}_os{cfg.model.output_stride}_{tag}")
        mlflow = try_setup_mlflow(exp_name, cfg.train.use_mlflow)
        self.logger = MetricsLogger(cfg.train.log_dir, mlflow)
        cfg.to_yaml(os.path.join(cfg.train.log_dir, "config.yaml"))
        if mlflow is not None:
            try:
                mlflow.start_run()
                mlflow.log_params({f"{s}.{k}": str(v) for s, sub in cfg.to_dict().items()
                                   for k, v in sub.items()})
            except Exception:
                pass

    def _data_root(self) -> str:
        cfg = self.cfg
        if not cfg.data.synthetic:
            return cfg.data.data_root
        root = os.path.join(cfg.data.data_root, "synthetic")
        if self.lead and not os.path.isdir(os.path.join(root, "train")):
            size = (cfg.data.synthetic_image_size,) * 2
            sequence_val = cfg.data.synthetic_sequence_val
            write_dataset(root, n_train=cfg.data.synthetic_train_size,
                          n_val=0 if sequence_val else cfg.data.synthetic_val_size,
                          size=size, seed=cfg.train.random_seed)
            if sequence_val:
                length = cfg.metrics.sequence_length
                write_sequence_dataset(
                    root, n_sequences=max(1, cfg.data.synthetic_val_size // length),
                    length=length, size=size, seed=cfg.train.random_seed + 1,
                    split="val")
        self._sync()
        return root

    def _sync(self) -> None:
        """Wait for every rank of the process group (a no-op without one)."""
        if is_initialized():
            dist.barrier()

    def _restore(self, path: str, continue_training: bool) -> None:
        meta = ckpt_lib.restore(path, self.state, continue_training)
        if continue_training:
            self.best_weighted = float(meta.get("weighted_score", 0.0))
            self.best_score = meta.get("best_score") or None
            print(f"Resumed at iter {self.state.step} (best {self.best_weighted:.4f})")
        else:
            print(f"Loaded model weights from {path}")

    # --------------------------------------------------------------- train
    def fit(self) -> Dict[str, float]:
        cfg = self.cfg
        it = device_prefetch_iterator(
            batch_iterator(self.train_ds, cfg.data.batch_size, shuffle=True,
                           drop_last=True, seed=cfg.train.random_seed, epochs=None,
                           shard=(self.mesh.data_index, self.mesh.data)),
            device=self.device, depth=cfg.data.num_workers // 2 or 2,
        )
        pending = []
        t0 = time.time()
        profiler = None
        try:
            while self.state.step < cfg.train.total_itrs:
                step = self.state.step
                if self._switch_iter and step >= self._switch_iter:
                    self._switch_to_plain()
                if cfg.train.profile_steps:
                    if step == cfg.train.profile_start and profiler is None:
                        profiler = self._start_profiler()
                    elif (profiler is not None
                          and step >= cfg.train.profile_start + cfg.train.profile_steps):
                        profiler.stop()
                        profiler = None
                images, labels = next(it)
                pending.append(self.train_step(self.state, images, labels))
                step = self.state.step

                if step % cfg.train.print_interval == 0:
                    # one host sync; the losses are the global batch's on every rank
                    losses = torch.stack(pending).float().cpu()
                    if self.lead:
                        self._log_losses(step, float(losses.mean()), len(pending), t0)
                    pending, t0 = [], time.time()
                if cfg.train.latest_interval and step % cfg.train.latest_interval == 0:
                    if self.lead:
                        ckpt_lib.save_latest(cfg.train.checkpoints_dir, self.state,
                                             weighted_score=self.best_weighted,
                                             best_score=self.best_score or {})
                    self._sync()
                if (cfg.train.quick_eval_interval
                        and step % cfg.train.quick_eval_interval == 0
                        and step % cfg.train.val_interval != 0):
                    if self.lead:
                        qm = self.quick_eval()
                        self.logger.log_step(step, {f"quick_{k}": v for k, v in qm.items()})
                        print(f"[quick-eval @ {step}] "
                              + " ".join(f"{k} {v:.4f}" for k, v in qm.items()))
                    self._sync()
                if step % cfg.train.val_interval == 0:
                    if self.lead:
                        self.validate_and_save(step)
                    self._sync()
        finally:
            it.close()  # stops the prefetch thread
            if profiler is not None:
                profiler.stop()
            if self.logger is not None:
                self._stop_logging()
        return {"best_weighted_score": self.best_weighted}

    def _switch_to_plain(self) -> None:
        """int8-early / plain-finish (``train.int8_switch_iter``): QAT off on
        the model's own modules; parameters, BatchNorm statistics and the
        optimizer's state carry over, the running amaxes are dropped.  The
        train step, and its ``remat``, stay: it reads the model as it is at
        each call (the JAX package rebuilds its jitted step here)."""
        import dataclasses

        model = self.state.model
        switch_off_int8(model)
        model.quant = dataclasses.replace(model.quant, int8_min_channels=0, int8_bwd=False)
        if self.lead:
            print(f"[int8_switch @ {self.state.step}] train step switched int8 -> "
                  f"{self.cfg.model.compute_dtype} (hybrid schedule)")
        self._switch_iter = 0

    def _log_losses(self, step: int, avg: float, steps: int, t0: float) -> None:
        cfg = self.cfg
        lr = self.schedule(step)
        self.logger.log_step(step, {
            "train_loss": avg, "lr": lr,
            "epoch": step * cfg.data.batch_size / len(self.train_ds),
        })
        rate = steps * cfg.data.batch_size / (time.time() - t0)
        print(f"it {step}/{cfg.train.total_itrs} loss {avg:.4f} "
              f"lr {lr:.5f} ({rate:.1f} img/s)")

    def _stop_logging(self) -> None:
        self.logger.save_plots(self.cfg.train.metrics_plots_dir)
        if self.logger.mlflow is not None:
            try:
                self.logger.mlflow.log_metric("best_weighted_score", self.best_weighted)
                self.logger.mlflow.set_tag("status", "completed")
                self.logger.mlflow.end_run()
            except Exception:
                pass
        self.logger.close()

    def _start_profiler(self):
        """``torch.profiler`` over ``profile_steps`` steps; the trace goes to
        ``log_dir/profile``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                os.path.join(self.cfg.train.log_dir, "profile")),
        )
        prof.start()
        return prof

    # ---------------------------------------------------------- validation
    def quick_eval(self) -> Dict[str, float]:
        """CM-only eval over the val set on the device (no per-image host
        transfer, no front-tracking): miou/fiou/precision/recall/f1 from a
        streaming confusion matrix (``metrics/device.py``; with two classes
        each batch goes through the confusion kernel on the card).  Labels
        and predictions stay on the device; the five floats come to the host
        once.  This is the cheap monitor; the full ``StreamMetrics``
        validation at ``val_interval`` keeps gating the best checkpoint."""
        cfg = self.cfg
        acc = DeviceEvalAccumulator(cfg.model.num_classes)
        for images, labels in batch_iterator(self.val_ds, cfg.data.val_batch_size,
                                             epochs=1):
            preds = self.eval_step(torch.from_numpy(images).to(self.device))["preds"]
            acc.update(torch.from_numpy(labels).to(self.device), preds)
        return acc.results()

    def validate(self) -> Tuple[Dict[str, float], StreamMetrics, list]:
        """Whole-set validation -> sliding-window metrics."""
        cfg = self.cfg
        metrics = StreamMetrics(
            cfg.model.num_classes, sequence_length=cfg.metrics.sequence_length,
            threshold=cfg.metrics.wave_presence_threshold,
            weights=cfg.metrics.weights, max_fte=cfg.metrics.max_fte,
        )
        samples = []
        for images, labels in batch_iterator(self.val_ds, cfg.data.val_batch_size,
                                             epochs=1):
            preds = self.eval_step(torch.from_numpy(images).to(self.device))["preds"]
            for pred, label in zip(preds.cpu().numpy(), labels):
                samples.append((self.val_ds.images[len(samples)], pred, label))

        length = cfg.metrics.sequence_length
        if len(samples) < length:
            print("Not enough samples for sequence evaluation.")
            for _, p, g in samples:
                metrics.update(g, p, sequence_data=False)
        else:
            samples.sort(key=lambda s: s[0])
            for i in range(len(samples) - length + 1):
                window = samples[i:i + length]
                metrics.update(np.stack([s[2] for s in window]),
                               np.stack([s[1] for s in window]), sequence_data=True)
        return metrics.get_results(), metrics, samples

    def validate_and_save(self, step: int) -> Dict[str, float]:
        cfg = self.cfg
        val_score, metrics, samples = self.validate()
        ws = self.logger.log_validation(step, val_score, cfg.metrics.weights)
        print(f"[val @ {step}] weighted {ws:.4f} | " + ", ".join(
            f"{k} {val_score[k]:.4f}" for k in ("MIoU", "Foreground IoU", "Foreground F1")))
        if is_best_score(val_score, self.best_score, cfg.metrics.weights):
            self.best_score = update_best_score(val_score)
            self.best_weighted = ws
            self.best_path = ckpt_lib.save_best(
                cfg.train.checkpoints_dir, self.state,
                model_name=f"{cfg.model.name}_{cfg.model.backbone}",
                dataset=cfg.data.dataset, output_stride=cfg.model.output_stride,
                num_classes=cfg.model.num_classes, weighted=ws, val_score=val_score,
                best_score=self.best_score,
            )
            print(f"New best ({ws:.4f}) -> {self.best_path}")
            if cfg.train.save_val_results:
                limit = cfg.train.val_dump_limit
                save_validation_results(
                    os.path.join(cfg.train.val_results_dir,
                                 f"best_model_iter_{step}_score_{ws:.4f}"),
                    samples[:limit] if limit else samples, self.val_ds)
        self.logger.save_confusion_matrix(metrics.confusion_matrix,
                                          cfg.train.metrics_plots_dir, step)
        return val_score


def save_validation_results(out_dir: str, samples, dataset) -> None:
    """Per-sample (image, GT, prediction, overlay) PNGs of a new best."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    name_to_idx = {n: i for i, n in enumerate(dataset.images)}
    for name, pred, gt in samples:
        stem = os.path.splitext(name)[0]
        img, _ = dataset[name_to_idx[name]]
        Image.fromarray(img).save(os.path.join(out_dir, f"{stem}_image.png"))
        Image.fromarray(decode_target(gt)).save(os.path.join(out_dir, f"{stem}_gt.png"))
        Image.fromarray(decode_target(pred)).save(os.path.join(out_dir, f"{stem}_pred.png"))
        overlay = img.astype(np.float32).copy()
        overlay[pred == 1] = 0.3 * overlay[pred == 1] + 0.7 * np.array([255, 0, 0])
        Image.fromarray(overlay.astype(np.uint8)).save(
            os.path.join(out_dir, f"{stem}_overlay.png"))
