from .class_weights import calculate_class_weights
from .datasets import (
    IMG_EXTENSIONS,
    ArrayDataset,
    BinarySegmentation,
    EvaluationDataset,
    batch_iterator,
    decode_target,
)
from .synthetic import generate_scene, write_dataset
from .transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    AugmentConfig,
    augment_batch,
    augment_resample,
    draw_augment_params,
    normalize,
    val_transform_batch,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "IMG_EXTENSIONS",
    "ArrayDataset",
    "AugmentConfig",
    "BinarySegmentation",
    "EvaluationDataset",
    "augment_batch",
    "augment_resample",
    "batch_iterator",
    "calculate_class_weights",
    "decode_target",
    "draw_augment_params",
    "generate_scene",
    "normalize",
    "val_transform_batch",
    "write_dataset",
]
