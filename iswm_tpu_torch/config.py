"""Configuration: the JAX package's dataclasses, used as they are (the
module is framework-free)."""

from iswm_tpu.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    PredictConfig,
    TrainConfig,
    aspp_dilations,
)

__all__ = [
    "Config",
    "DataConfig",
    "LossConfig",
    "ModelConfig",
    "OptimConfig",
    "PredictConfig",
    "TrainConfig",
    "aspp_dilations",
]
