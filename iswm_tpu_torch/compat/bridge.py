"""Weights into the port: from the JAX package's trees or a reference .pth;
and the SGD momentum of a JAX training state, so that it continues here.

Both go through the reference-format bridge ``.torch_import`` (the port's
copy of ``iswm_tpu/compat/torch_import.py``), whose key layout the port's
modules reproduce, so the result loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .torch_import import export_torch_state_dict, strip_module_prefix


def state_dict_from_jax(
    params: Any, batch_stats: Any, backbone: str = "resnet50",
    head: str = "deeplabv3plus",
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``params`` / ``batch_stats`` trees (numpy leaves)
    -> a reference-format torch state dict."""
    sd = export_torch_state_dict(params, batch_stats, backbone=backbone, head=head)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pth``/``.pt`` (bare state dict or a payload with
    ``model_state``) -> state dict, ``module.`` prefixes stripped.

    An Orbax checkpoint directory of the JAX package needs jax to read; it
    is refused with the command that converts it."""
    if os.path.isdir(path) or not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"{path!r} is not a .pth/.pt file.  An Orbax checkpoint of the JAX "
            "package converts with: python -m iswm_tpu.cli.export_torch "
            f"--ckpt {path} --out model.pth"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model_state" in payload:
        payload = payload["model_state"]
    return strip_module_prefix(payload)


def momentum_from_optax(
    opt_state: Any, batch_stats: Any, backbone: str = "resnet50",
    head: str = "deeplabv3plus",
) -> Tuple[Dict[str, torch.Tensor], int]:
    """The JAX package's SGD optimizer state -> (torch SGD momentum buffers by
    parameter name, step count).

    ``opt_state`` is ``optax.chain(add_decayed_weights, sgd)``'s state,
    ``(EmptyState, (TraceState(trace), ScaleByScheduleState(count)))``; its
    ``trace`` tree has the parameters' structure and is torch SGD's
    ``momentum_buffer`` (``b = m * b + g``, nesterov or not), so it goes
    through the parameters' own export.  ``batch_stats`` only fills the
    export's BatchNorm buffers, which are dropped."""
    trace_state, schedule_state = opt_state[1]
    sd = state_dict_from_jax(trace_state.trace, batch_stats, backbone=backbone, head=head)
    buffers = {k: v for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    return buffers, int(np.asarray(schedule_state.count))


def load_momentum(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                  buffers: Dict[str, torch.Tensor]) -> None:
    """Set each parameter's ``momentum_buffer`` in a torch SGD ``optimizer``
    from :func:`momentum_from_optax`'s buffers (every parameter needs one)."""
    named = dict(model.named_parameters())
    if set(named) != set(buffers):
        raise KeyError(f"momentum buffers do not match the model's parameters: "
                       f"{sorted(set(named) ^ set(buffers))[:5]}")
    for name, p in named.items():
        optimizer.state[p]["momentum_buffer"] = buffers[name].to(
            device=p.device, dtype=p.dtype).clone()
