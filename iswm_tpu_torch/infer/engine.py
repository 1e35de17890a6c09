"""Shape-specialized inference engines, the counterpart of
``iswm_tpu/infer/engine.py`` (the analogue of the reference's TensorRT engine
build, reference tensorrt_tools/build_engine.py:27-114).

  - ``build_engine``: warms ``model_fn`` up on a side stream and captures
    one ``torch.cuda.CUDAGraph`` of it with a static input and output
    buffer for a fixed input signature; a call copies the input into the
    static buffer and replays the graph, so the host launches one graph in
    place of every kernel of the forward.  The capture IS the engine build,
    as the compile is in the JAX package.  The hand-written kernels launch
    on ``torch.cuda.current_stream()``, so they are captured like the
    library's.  A fn that synchronizes with the host (``.item()``, a copy to
    the host) cannot be captured: ``build_engine`` finds that in a second
    warm-up under ``torch.cuda.set_sync_debug_mode("error")`` and refuses it
    (``CaptureRefused``); a capture that fails raises.  Neither falls back
    to eager execution.  On a CPU device, which the caller must ask for, the
    engine runs ``model_fn`` eagerly.
  - ``serialize`` / ``deserialize``: a self-contained artifact through
    ``torch.export`` (``torch.export.save`` bytes; the closed-over weights
    are baked in as constants, TRT-engine semantics: the blob alone serves).
    The hand-written kernels that serving reaches are operators of the
    dispatcher (``torch.ops.iswm``, ``ops/kernels/__init__.py``): the trace
    runs their fakes and records each call as one node, and the loaded
    artifact launches the kernels on the card (their plain versions on the
    CPU).  A fn that reaches a wrapper that still launches through ctypes
    (training's, marked by ``ops.kernels.ctypes_entry``) is refused.

The JAX package's ``enable_persistent_cache`` configures XLA's compilation
cache and has no counterpart: the port compiles its kernels once into
``build/kernels/`` (``ops/kernels/build.py``), keyed by a hash of their
source, and a CUDA graph is captured per process.

Engines are shape-specialized like TRT profiles with min=opt=max; build one
for each (batch, size) served.
"""

from __future__ import annotations

import gc
import io
from typing import Callable, Optional, Tuple

import torch

from ..ops.kernels import refusing_ctypes_entries

WARMUP_CALLS = 3


class CaptureRefused(RuntimeError):
    """``build_engine`` refuses a fn that a CUDA graph cannot capture."""


class Engine:
    """A shape-specialized inference executable: a captured CUDA graph with
    its static input and output buffers, or ``model_fn`` itself on the CPU."""

    def __init__(self, model_fn: Callable, input_shape: Tuple[int, ...], dtype,
                 device: torch.device, graph: Optional[torch.cuda.CUDAGraph] = None,
                 static_input: Optional[torch.Tensor] = None,
                 static_output: Optional[torch.Tensor] = None,
                 flops: Optional[float] = None, pool_bytes: Optional[int] = None):
        self.model_fn = model_fn
        self.input_shape = tuple(input_shape)
        self.dtype = dtype
        self.device = device
        self.graph = graph
        self.static_input = static_input
        self.static_output = static_output
        self._flops = flops
        self._pool_bytes = pool_bytes

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.input_shape:
            raise ValueError(
                f"engine built for {self.input_shape}, got {tuple(x.shape)} — "
                "build a separate engine per served shape (TRT-profile semantics)"
            )
        if self.graph is None:
            with torch.inference_mode():
                return self.model_fn(x.to(self.device, self.dtype))
        self.static_input.copy_(x)  # the cast and the copy onto the card
        self.graph.replay()
        # a copy: the next replay overwrites the static output
        return self.static_output.clone()

    @property
    def flops(self) -> Optional[float]:
        """The floating-point operations of one call that
        ``torch.utils.flop_counter`` counted at build time (the library's
        matmuls and convs; a hand-written kernel is not seen)."""
        return self._flops

    @property
    def memory_analysis(self) -> Optional[dict]:
        """``{"graph_pool_bytes": ...}``: the device memory the capture
        reserved for the graph's private pool, or None (an eager engine)."""
        return None if self._pool_bytes is None else {"graph_pool_bytes": self._pool_bytes}


def _count_flops(model_fn: Callable, x: torch.Tensor) -> float:
    """The floating-point operations ``FlopCounterMode`` counts in one call
    of ``model_fn``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model_fn(x)
    return float(counter.get_total_flops())


def _warm_up(model_fn: Callable, x: torch.Tensor, device: torch.device) -> None:
    """``WARMUP_CALLS`` calls on a side stream (lazy initialization, kernel
    builds, cuDNN's autotuning), the last under the sync debug mode
    "error": a host synchronization there is one a replay could not make."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), torch.inference_mode():
        for _ in range(WARMUP_CALLS - 1):
            model_fn(x)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model_fn(x)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            raise CaptureRefused(
                f"a CUDA graph cannot capture {getattr(model_fn, '__name__', model_fn)!r}: "
                f"it synchronizes with the host ({e})") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream(device).wait_stream(side)


def _engine_device(device) -> torch.device:
    """``device`` as a ``torch.device``: "cpu", or "cuda" (the current card)
    or "cuda:N", which needs a card (there is no fallback)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"an engine runs on 'cuda' or 'cpu', not {device.type!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an engine on 'cuda' needs a CUDA card "
                               "(pass device='cpu' to run on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_engine(
    model_fn: Callable,
    input_shape: Tuple[int, ...],
    dtype=torch.bfloat16,
    device="cuda",
) -> Engine:
    """Capture ``model_fn`` for a fixed input signature (see the module).

    ``device`` "cuda" (the current card) or "cuda:N": a CUDA graph, which
    needs a card (there is no fallback); "cpu": ``model_fn`` eagerly."""
    device = _engine_device(device)
    if device.type == "cpu":
        x = torch.zeros(input_shape, dtype=dtype)
        return Engine(model_fn, input_shape, dtype, device, flops=_count_flops(model_fn, x))
    with torch.cuda.device(device):
        static_input = torch.zeros(input_shape, dtype=dtype, device=device)
        flops = _count_flops(model_fn, static_input)
        _warm_up(model_fn, static_input, device)
        # the capture empties the allocator's cache as it starts: empty it
        # first, so that what is reserved after it is the graph's pool
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph), torch.inference_mode():
                static_output = model_fn(static_input)
        except Exception as e:
            raise RuntimeError(f"the CUDA graph capture of {input_shape} failed: {e}") from e
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
    if not isinstance(static_output, torch.Tensor):
        raise TypeError(f"an engine serves a fn that returns one tensor, "
                        f"not {type(static_output).__name__}")
    return Engine(model_fn, input_shape, dtype, device, graph, static_input, static_output,
                  flops, pool_bytes)


class _Exportable(torch.nn.Module):
    def __init__(self, model_fn: Callable):
        super().__init__()
        self.model_fn = model_fn

    def forward(self, x):
        return self.model_fn(x)


def serialize(model_fn: Callable, input_shape: Tuple[int, ...], dtype=torch.bfloat16,
              device="cuda") -> bytes:
    """A self-contained engine artifact: ``torch.export`` of ``model_fn`` at
    a fixed input signature, traced on an example input on ``device`` (as
    ``build_engine``: the card unless the caller asks for "cpu"; the fn's
    weights must lie there too), saved with ``torch.export.save``.
    ``model_fn``'s closed-over weights are baked into the artifact as
    constants on their device, so artifacts for large models are
    weight-sized; ``deserialize`` puts them back there.

    The hand kernels' operators trace as graph nodes: the trace runs only
    their fakes, so it launches nothing and runs no plain version.  Raises
    ``NotImplementedError`` for a fn that reaches a wrapper that launches
    through ctypes (training's, ``ops.kernels.ctypes_entry``):
    ``torch.export`` cannot trace that launch, and on a CPU tensor it would
    trace the plain version in its place.  The trace stops as it enters that
    wrapper, so that its body does not run (or count a launch) on the
    trace's storage-less tensors."""
    device = _engine_device(device)
    example = torch.zeros(input_shape, dtype=dtype, device=device)
    with refusing_ctypes_entries() as reached:
        try:
            exported = torch.export.export(_Exportable(model_fn), (example,), strict=False)
            error = None
        except Exception as e:  # raised below, after the check for a ctypes wrapper
            error = e
    if reached:
        raise NotImplementedError(
            f"serialize: the fn reaches {reached[0]}, a training kernel's wrapper that "
            f"launches through ctypes, which torch.export cannot trace") from error
    if error is not None:
        raise error
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    return buffer.getvalue()


def deserialize(blob: bytes) -> Callable:
    """Load a serialized engine; returns a callable module.  The hand
    kernels' operators are registered (by the import above) before the load,
    so that an artifact loads in a fresh interpreter."""
    return torch.export.load(io.BytesIO(blob)).module()
