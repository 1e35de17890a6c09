"""Unified configuration of the PyTorch port.

The port's own copy of ``iswm_tpu/config.py``: the same dataclass tree,
field for field and default for default, so a YAML file or a flag set
written for one package configures the other
(``tests/test_torch_shared.py`` holds the two equal).  One tree is built
from YAML, from CLI flags, or programmatically.  A field whose feature the
port has not reached yet keeps its place and default here; the module that
would consume it refuses any other value and names its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

try:  # PyYAML is optional: JSON takes its place
    import yaml

    _HAS_YAML = True
except Exception:  # pragma: no cover
    _HAS_YAML = False


@dataclass
class ModelConfig:
    """Model zoo selection (reference network/modeling.py:12-83)."""

    name: str = "deeplabv3plus"  # deeplabv3plus | deeplabv3
    backbone: str = "resnet50"  # resnet18/34/50/101/152 | resnext50_32x4d |
    #   resnext101_32x8d | wide_resnet50_2 | wide_resnet101_2 | mobilenetv2 | xception
    num_classes: int = 2
    output_stride: int = 16  # 8 -> aspp [12,24,36]; 16 -> [6,12,18]
    in_channels: int = 3
    separable_conv: bool = False  # atrous separable convs in the head
    pretrained_backbone: bool = False
    compute_dtype: str = "bfloat16"  # dtype of activations/matmuls
    param_dtype: str = "float32"  # dtype of parameters (BN stats stay float32)
    bn_momentum: float = 0.9  # flax convention = 1 - torch momentum (0.1)
    bn_epsilon: float = 1e-5
    # Fused conv + BatchNorm-statistics residual blocks for training:
    # auto | always | never | interpret (tests).
    fused_blocks: str = "never"
    # Fused stem tail (BN + ReLU + max-pool, forward and backward); same
    # auto|always|never|interpret settings (interpret = always: a CPU tensor
    # takes the kernels' plain versions either way).  Its pool gradient splits ties
    # equally and it propagates no gradient to the input image: keep
    # "never" for workflows that differentiate w.r.t. the image.
    fused_stem: str = "never"
    # EXPERIMENTAL quantization-aware training: forward convs (dilation < 6,
    # input channels >= this gate; True = 64, 0/False = off) execute in int8
    # with straight-through gradients.  A deliberate change of training
    # numerics.
    int8_training: int = 0
    # Activation-scale mode of the int8_training convs: "dynamic" = per-step
    # absmax; "delayed" = quantize with the running amax carried in the
    # model's "quant" state, the current absmax feeding the next step.
    int8_scale_mode: str = "dynamic"
    # EXPERIMENTAL int8 backward of the int8_training convs (quantized
    # cotangent; wgrad reuses the forward's quantized activations).
    int8_training_bwd: bool = False
    # How int8_training picks conv sites: "gate" = every eligible conv at or
    # above the channel threshold; "cost" = a per-site roofline model with
    # the threshold as an eligibility floor.
    int8_route: str = "gate"
    # Incremental bytes/value the cost model charges one dynamic quantize
    # pass (delayed scaling is charged a third).
    int8_cost_bytes: float = 3.0
    # Execute grouped convs whose input channels are <= this as one dense
    # conv with a block-diagonal kernel (-1 = auto, 0 = off).  The math is
    # the same either way and the parameters keep the grouped layout; the
    # port always runs native ``groups=`` convs.
    grouped_blockdiag: int = -1


@dataclass
class DataConfig:
    """Dataset + augmentation chain (reference train.py:355-380, utils/ext_transforms.py)."""

    data_root: str = "./datasets/data"
    dataset: str = "binary"
    crop_size: int = 513  # reference default; production runs use 200 (run_ce_loss.sh:47)
    scale_range: tuple = (0.5, 2.0)  # ExtRandomScale (ext_transforms.py:94)
    hflip_prob: float = 0.5  # ExtRandomHorizontalFlip (ext_transforms.py:212)
    # ImageNet constants (reference train.py:360-361, predict.py:95-96)
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)
    ignore_index: int = 255
    batch_size: int = 64
    val_batch_size: int = 4
    num_workers: int = 4
    # synthetic fixture generator
    synthetic: bool = False
    synthetic_train_size: int = 64
    synthetic_val_size: int = 16
    synthetic_image_size: int = 200
    # validation split as temporally-coherent sequences (exercises the
    # 7-frame temporal metrics with real wave motion)
    synthetic_sequence_val: bool = False
    cache_in_memory: bool = True  # keep decoded arrays in host RAM


@dataclass
class LossConfig:
    """Loss selection (reference train.py:454-459, utils/loss.py:14-39)."""

    loss_type: str = "ce_loss"  # ce_loss | IWce_loss | focal_loss
    focal_alpha: float = 1.0
    focal_gamma: float = 0.0
    ignore_index: int = 255
    # fused softmax-CE kernel for binary CE:
    # auto | always | never | interpret (CPU tests)
    fused_kernel: str = "auto"


@dataclass
class OptimConfig:
    """Optimizer + LR schedule (reference train.py:421-452)."""

    optimizer: str = "sgd"  # sgd | adam | adamw
    lr: float = 0.01
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-4
    schedule: str = "cosine"  # cosine (reference default, per-iteration) | poly
    # cosine: eta_min = lr * cosine_min_factor (reference train.py:449-451)
    cosine_min_factor: float = 0.01
    # poly: (1 - it/max)^power with min_lr floor (reference utils/scheduler.py:3-12)
    poly_power: float = 0.9
    poly_min_lr: float = 1e-6


@dataclass
class MetricsConfig:
    """Composite weighted score (reference train.py:842-850, stream_metrics.py:65-100)."""

    sequence_length: int = 7
    wave_presence_threshold: float = 0.005
    max_fte: float = 10.0
    weights: dict = field(
        default_factory=lambda: {
            "MIoU": 0.05,
            "Foreground IoU": 0.25,
            "Foreground F1": 0.25,
            "Front Tracking Error": 0.25,
            "Temporal Consistency": 0.10,
            "Region Continuity": 0.10,
        }
    )


@dataclass
class TrainConfig:
    """Training loop (reference train.py:272-351, 840-1116)."""

    total_itrs: int = 30_000
    val_interval: int = 500
    # cheap device-side CM-only eval every N iters (0 = off): preds stay on
    # the device, only a CxC matrix crosses to the host — monitoring between
    # the full (host StreamMetrics) validations that gate the best checkpoint
    quick_eval_interval: int = 0
    print_interval: int = 10
    random_seed: int = 1
    continue_training: bool = False
    ckpt: Optional[str] = None
    checkpoints_dir: str = "checkpoints"
    val_results_dir: str = "val_results"
    metrics_plots_dir: str = "metrics_plots"
    save_val_results: bool = True
    # How many val samples to dump on a new best.  The reference dumps the
    # WHOLE val set (reference train.py:461-523); the default of 8 bounds
    # disk/IO on large val sets — set 0 for reference parity (dump all).
    val_dump_limit: int = 8
    save_confidence_map: bool = False
    log_dir: str = "logs"  # JSONL metric log (MLflow-compatible names)
    use_mlflow: bool = False  # enable if mlflow importable + MLFLOW_TRACKING_URI set
    experiment_tag: str = ""
    # profiler: trace this many steps starting at profile_start (0 = off)
    profile_steps: int = 0
    profile_start: int = 10
    # fault tolerance: write a rolling 'latest' checkpoint every N iters
    # (0 = off); auto_resume restores it at startup when present
    latest_interval: int = 0
    auto_resume: bool = False
    # int8-early / bf16-finish hybrid schedule (0 = off): with
    # model.int8_training > 0, iterations >= this switch the train step
    # (and validation forward) to the plain bf16 model — parameters,
    # optimizer state and BN stats carry over unchanged.
    int8_switch_iter: int = 0


@dataclass
class ParallelConfig:
    """Device layout (the reference used nn.DataParallel, train.py:970)."""

    data_axis: int = -1  # -1: all devices on the data axis
    model_axis: int = 1  # >1 enables spatial/channel model parallelism
    axis_names: tuple = ("data", "model")
    # activation rematerialization: memory for recomputation
    remat: bool = False


@dataclass
class PredictConfig:
    """Inference products (reference predict.py:19-67)."""

    input_dir: str = ""
    output_dir: str = "predictions"
    pred_threshold: float = 0.5  # fg-prob threshold (predict.py:275)
    use_argmax: bool = False  # validation semantics (train.py:644) vs predict's threshold
    save_confidence: bool = False
    save_binary: bool = False
    binary_threshold: int = 200
    min_prob: float = 0.2  # broken-area band (predict.py:214-256)
    max_prob: float = 0.7
    enable_wave_processing: bool = False
    save_feature_maps: bool = False  # backbone/ASPP activation heatmaps
    synthetic_damage_prob: float = 0.8  # predict.py:144
    synthetic_damage_ratio: float = 0.05  # predict.py:152
    # Tile engine (whole scenes are served as overlapping tiles)
    tile_size: int = 512
    tile_overlap: int = 64
    tile_batch: int = 8
    # Serving precision: bf16 | int8 (weight-only, 4x smaller at rest) |
    # int8_exec (eligible 1x1 convs executed in int8; calibrates
    # activation scales on the first scene's tiles) | int8_exec_xla (every
    # dense conv in int8)
    serving_variant: str = "bf16"
    # With int8_exec_xla: also route grouped/depthwise convs (exact under
    # per-output-channel weight scales); off by default.
    int8_grouped: bool = False
    # With int8_exec_xla: also route the stem conv (quantize first, then an
    # int8 conv); off by default.
    int8_stem: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    predict: PredictConfig = field(default_factory=PredictConfig)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            if _HAS_YAML:
                yaml.safe_dump(_plain(self.to_dict()), f, sort_keys=False)
            else:  # pragma: no cover
                json.dump(_plain(self.to_dict()), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for section, values in (d or {}).items():
            if not hasattr(cfg, section):
                raise KeyError(f"Unknown config section: {section!r}")
            sub = getattr(cfg, section)
            if not isinstance(values, dict):
                raise TypeError(f"Section {section!r} must be a mapping")
            for k, v in values.items():
                if not hasattr(sub, k):
                    raise KeyError(f"Unknown config key: {section}.{k}")
                cur = getattr(sub, k)
                if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                    v = tuple(v)
                setattr(sub, k, v)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            if _HAS_YAML:
                d = yaml.safe_load(f)
            else:  # pragma: no cover
                d = json.load(f)
        return cls.from_dict(d or {})

    def validate(self) -> "Config":
        if self.model.output_stride not in (8, 16):
            raise ValueError("output_stride must be 8 or 16")
        if self.loss.loss_type not in ("ce_loss", "IWce_loss", "focal_loss"):
            raise ValueError(f"unknown loss_type {self.loss.loss_type!r}")
        if self.optim.optimizer not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown optimizer {self.optim.optimizer!r}")
        if self.optim.schedule not in ("cosine", "poly"):
            raise ValueError(f"unknown schedule {self.optim.schedule!r}")
        if self.model.num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        return self


def _plain(obj: Any) -> Any:
    """Recursively convert tuples to lists for YAML friendliness."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def aspp_dilations(output_stride: int) -> Sequence[int]:
    """ASPP rates per output stride (reference network/modeling.py:14-19)."""
    if output_stride == 8:
        return (12, 24, 36)
    return (6, 12, 18)
