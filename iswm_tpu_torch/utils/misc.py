"""Small utilities, the counterpart of ``iswm_tpu/utils/misc.py`` (the
reference's utils/utils.py and metrics/utils/decorators.py).

BatchNorm control: momentum is ``ModelConfig.bn_momentum`` and a frozen
BatchNorm is the module in eval mode, so no mutation helpers are needed.
The JAX package's ``enable_compilation_cache`` configures XLA's cache and has
no counterpart: the port's kernels are built once into ``build/kernels/``
(``ops/kernels/build.py``), keyed by a hash of their source.
"""

from __future__ import annotations

import functools
import os
import time
import traceback
from typing import Sequence

import numpy as np


class Denormalize:
    """Invert (x - mean)/std; accepts HWC or CHW numpy arrays
    (reference utils/utils.py:14-24)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, tensor: np.ndarray) -> np.ndarray:
        arr = np.asarray(tensor, dtype=np.float32)
        if arr.ndim == 3 and arr.shape[0] == len(self.mean):  # CHW
            return arr * self.std.reshape(-1, 1, 1) + self.mean.reshape(-1, 1, 1)
        return arr * self.std + self.mean  # HWC / NHWC


def denormalize(tensor: np.ndarray, mean, std) -> np.ndarray:
    return Denormalize(mean, std)(tensor)


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def safe_process(error_value=None):
    """try/except decorator returning a typed sentinel on failure
    (reference metrics/utils/decorators.py:4-16)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            try:
                return func(*args, **kwargs)
            except Exception as e:
                print(f"Error in {func.__name__}: {e}")
                print(f"Traceback: {traceback.format_exc()}")
                return error_value

        return wrapper

    return decorator


def timing_debug(func):
    """Wall-clock print decorator (reference metrics/utils/decorators.py:18-27)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        print(f"{func.__name__} took {time.time() - start:.4f} seconds to execute")
        return result

    return wrapper
