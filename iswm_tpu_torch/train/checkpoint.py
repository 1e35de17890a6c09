"""Checkpoints, the counterpart of ``iswm_tpu/train/checkpoint.py``, with the
same policy and a reference-format ``.pth`` payload in place of Orbax:

  - best-only: earlier ``best_*`` checkpoints are deleted before a save;
  - the name embeds the weighted score,
    ``best_{model}_{dataset}_os{OS}_weighted{score:.3f}.pth``;
  - written to a temporary file, then published with ``os.replace``;
  - a warning when less than 1 GB of disk is free;
  - payload: ``model_state`` (the reference key layout, float32 whatever the
    model's ``param_dtype``, as the JAX package exports it) + ``optimizer_state``,
    ``scheduler_state``, ``cur_itrs``, ``best_score``, ``weighted_score``,
    ``val_score``, ``save_time``, ``model_config``;
  - ``quant``, where the model carries the running amaxes of delayed-mode
    QAT: ``{<conv>.x_amax[_p{i}]: 0-d float32}``, beside ``model_state`` and
    not in it (the JAX package's "quant" sidecar), so that the state dict
    stays the reference layout.

``iswm_tpu.compat.torch_import.load_reference_checkpoint`` reads the
payload, so the JAX package loads what the port trains.  ``restore``
loads the model alone or, to continue training, the optimizer, the
scheduler and the step as well.
"""

from __future__ import annotations

import glob
import math
import os
import shutil
import time
from typing import Any, Optional

import torch

from ..models.layers import quant_state
from .step import TrainState

MIN_FREE_BYTES = 1 << 30  # 1 GB warning threshold


def _check_disk_space(directory: str) -> None:
    try:
        free = shutil.disk_usage(directory).free
    except OSError:
        return
    if free < MIN_FREE_BYTES:
        print(f"WARNING: low disk space ({free / 1e9:.2f} GB free) in {directory}")


def best_checkpoint_name(model_name: str, dataset: str, output_stride: int,
                         weighted: float) -> str:
    return f"best_{model_name}_{dataset}_os{output_stride}_weighted{weighted:.3f}.pth"


def _plain(obj: Any) -> Any:
    """Python floats / ints / strings only (NaN and inf as strings)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item"):
        obj = obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _save(path: str, state: TrainState, **meta: Any) -> str:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    _check_disk_space(directory)
    payload = {
        "model_state": {k: v.float() if v.is_floating_point() else v
                        for k, v in _to_cpu(state.model.state_dict()).items()},
        "optimizer_state": _to_cpu(state.optimizer.state_dict()),
        "scheduler_state": state.scheduler.state_dict(),
        "cur_itrs": int(state.step),
        "save_time": time.strftime("%Y-%m-%d %H:%M:%S"),
        **_plain(meta),
    }
    quant = quant_state(state.model)
    if quant:
        payload["quant"] = _to_cpu(quant)
    tmp = os.path.join(directory, f".tmp_{os.path.basename(path)}_{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic publish
    return path


def save_best(
    checkpoints_dir: str,
    state: TrainState,
    *,
    model_name: str,
    dataset: str,
    output_stride: int,
    num_classes: int,
    weighted: float,
    val_score: Optional[dict] = None,
    best_score: Optional[dict] = None,
) -> str:
    """Save ``state`` as the new best checkpoint; returns its path."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    for old in glob.glob(os.path.join(checkpoints_dir, "best_*")):
        os.remove(old)  # best-only policy
    path = os.path.join(checkpoints_dir, best_checkpoint_name(
        model_name, dataset, output_stride, weighted))
    return _save(
        path, state, weighted_score=float(weighted), val_score=val_score or {},
        best_score=best_score or {},
        model_config={"model_name": model_name, "dataset": dataset,
                      "output_stride": output_stride, "num_classes": num_classes},
    )


def find_best(checkpoints_dir: str) -> Optional[str]:
    cands = sorted(glob.glob(os.path.join(checkpoints_dir, "best_*.pth")))
    return cands[-1] if cands else None


def save_latest(checkpoints_dir: str, state: TrainState, **meta_extra: Any) -> str:
    """Rolling fault-tolerance checkpoint ``latest.pth``, independent of the
    best-only policy."""
    return _save(os.path.join(checkpoints_dir, "latest.pth"), state, **meta_extra)


def find_latest(checkpoints_dir: str) -> Optional[str]:
    p = os.path.join(checkpoints_dir, "latest.pth")
    return p if os.path.isfile(p) else None


def load_quant(path: str) -> dict:
    """The running amaxes a checkpoint carries (``quant``; empty without)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return dict(payload.get("quant", {})) if isinstance(payload, dict) else {}


def restore(path: str, state: TrainState, continue_training: bool) -> dict:
    """Load a checkpoint into ``state`` (model weights, ``strict=True``, cast
    to the parameters' dtype, and the running amaxes of the sites the model
    and the checkpoint both have; with ``continue_training`` also the
    optimizer, scheduler and step).
    Returns the payload's metadata."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model_state"], strict=True)
    amaxes = quant_state(state.model)
    with torch.no_grad():
        for key, value in payload.get("quant", {}).items():
            if key in amaxes:
                amaxes[key].copy_(value)
    if continue_training:
        state.optimizer.load_state_dict(payload["optimizer_state"])
        state.scheduler.load_state_dict(payload["scheduler_state"])
        state.step = int(payload["cur_itrs"])
    return {k: v for k, v in payload.items()
            if k not in ("model_state", "optimizer_state", "scheduler_state", "quant")}
