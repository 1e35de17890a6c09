"""Image rows split over the ranks of a model group: what GSPMD does for the
JAX package's ``P(data, model)`` images (``__graft_entry__.py``
``dryrun_multichip``, ``parallel/mesh.py`` ``spatial_sharding``).

Each rank of a model group of M ranks holds rows ``[m * H / M, (m + 1) * H /
M)`` of every activation of the train forward.  An operator that reads
across a row boundary fetches a halo first: the rows of its neighbours (or
farther ranks, where the halo is taller than a shard) that its own output
rows need, with a fill value for rows outside the global image (0 for a
conv's padding, -inf for the max-pool's).  The operators that do so check
:func:`current` (``models/layers.py`` ``Conv2d``, ``MaxPool2d``,
``GlobalAvgPool2d``; ``ops/resize.py``); outside :func:`spatially_split`
they run as on one device, so validation, evaluation and serving make no
collective.

Every other part of the step needs nothing new: a rank's pixels are its own,
so the cross-replica BatchNorm, the sharded CE and the summing gradient
reduction over the default group give the global batch's numbers.  The ASPP
pooling branch is the one tensor replicated over a model group; its group
sum's backward is a group sum, so that each rank's partial gradient reaches
every rank's rows.

The exchange is one simple scheme: every rank all-gathers its first and last
``E`` rows (E the deepest halo any rank needs, at most its shard), and builds
its halo from them; the backward all-reduces the gathered rows' gradients
and takes back its own.  Every rank makes both collectives of a window,
whether or not it borrows a row, and keeps its activations' memory format
(channels last on the card), so that no conv converts its input.
``all_gather`` and ``all_reduce`` are in both ``gloo`` and ``nccl``.
``collectives`` and ``collective_bytes`` count the calls and the bytes of
the tensors they produce, forward and backward.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from . import distributed

# calls and bytes (of each collective's output tensor) since the last reset
collectives = {"halo_gather": 0, "halo_reduce": 0, "group_sum": 0}
collective_bytes = {"halo_gather": 0, "halo_reduce": 0, "group_sum": 0}


def reset_counts() -> None:
    for d in (collectives, collective_bytes):
        for k in d:
            d[k] = 0


@dataclass(frozen=True)
class Split:
    """The model group a rank's rows are split over: its process group,
    size M and this rank's index m in it."""

    group: object
    size: int
    index: int


# module-wide, not thread-local: the autograd engine runs a CUDA backward on
# its own thread
_split: Optional[Split] = None


@contextlib.contextmanager
def spatially_split(mesh=None):
    """Within: the spatial operators treat every activation as this rank's
    rows of the model group of ``mesh`` (a ``parallel.Mesh``); ``mesh`` None
    or with a model axis of 1 is a no-op."""
    global _split
    previous = _split
    if mesh is not None and mesh.model > 1:
        _split = Split(mesh.group, mesh.model, mesh.model_index)
    try:
        yield
    finally:
        _split = previous


def current() -> Optional[Split]:
    """The split in force, or None."""
    return _split


def _count(kind: str, t: torch.Tensor) -> None:
    collectives[kind] += 1
    collective_bytes[kind] += t.numel() * t.element_size()


def _layout(x: torch.Tensor):
    """The memory format whose strides ``x``'s are (a slice of): channels
    last where the channels are innermost, as the model's activations on the
    card.  Every tensor made here keeps it, so that no conv converts."""
    return (torch.channels_last if x.dim() == 4 and x.stride(1) == 1 and x.shape[1] > 1
            else torch.contiguous_format)


class _FetchRows(torch.autograd.Function):
    """The halo exchange of :func:`fetch_rows`: all-gather every rank's edge
    rows (its first and last ``e``, or all ``h`` when ``e == h``), then
    concatenate ``pieces``, each ``("local", a, b)`` (rows of ``x``),
    ``("gathered", a, b)`` (rows of the gathered edges, rank q's at ``[q *
    slot, (q + 1) * slot)``) or ``("fill", n)``.  The backward scatters the
    output's gradient back, all-reduces the gathered rows' part over the
    group and adds this rank's slot of it to its edge rows."""

    @staticmethod
    def forward(ctx, x, split, e, pieces, fill):
        layout = _layout(x)
        h = x.shape[2]
        edges = x[:, :, :e] if e == h else torch.cat([x[:, :, :e], x[:, :, h - e:]], dim=2)
        edges = edges.contiguous(memory_format=layout)
        parts = [torch.empty_like(edges) for _ in range(split.size)]
        dist.all_gather(parts, edges, group=split.group)
        gathered = torch.cat(parts, dim=2)
        _count("halo_gather", gathered)
        out = []
        for kind, *span in pieces:
            if kind == "fill":
                shape = (*x.shape[:2], span[0], x.shape[3])
                out.append(x.new_full(shape, fill).contiguous(memory_format=layout))
            else:
                out.append((x if kind == "local" else gathered)[:, :, span[0]:span[1]])
        ctx.split, ctx.e, ctx.pieces = split, e, pieces
        ctx.shapes = (x.shape, gathered.shape)
        return torch.cat(out, dim=2)

    @staticmethod
    def backward(ctx, grad):
        split, e, (x_shape, gathered_shape) = ctx.split, ctx.e, ctx.shapes
        layout = _layout(grad)
        dx = grad.new_zeros(x_shape).contiguous(memory_format=layout)
        dgathered = grad.new_zeros(gathered_shape).contiguous(memory_format=layout)
        offset = 0
        for kind, *span in ctx.pieces:
            n = span[0] if kind == "fill" else span[1] - span[0]
            if kind != "fill":
                target = dx if kind == "local" else dgathered
                target[:, :, span[0]:span[1]] += grad[:, :, offset:offset + n]
            offset += n
        dist.all_reduce(dgathered, group=split.group)
        _count("halo_reduce", dgathered)
        h, slot = x_shape[2], gathered_shape[2] // split.size
        own = dgathered[:, :, split.index * slot:(split.index + 1) * slot]
        if e == h:
            dx += own
        else:
            dx[:, :, :e] += own[:, :, :e]
            dx[:, :, h - e:] += own[:, :, e:]
        return dx, None, None, None, None


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group in force (differentiable)."""
    return distributed.group_sum(x, _split.group, functools.partial(_count, "group_sum"))


_constants = {}  # (values, dtype, device) -> tensor


def _constant(values: tuple, device, dtype=torch.long) -> torch.Tensor:
    """A small index or weight tensor on ``device``, made once."""
    key = (values, dtype, str(device))
    if key not in _constants:
        _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return _constants[key]


def fetch_rows(x: torch.Tensor, rows: Callable[[int], Tuple[int, int]],
               fill: float = 0.0) -> torch.Tensor:
    """The global rows ``[start, stop)`` = ``rows(m)`` of the image whose
    rows this rank holds in ``x`` [B, C, h, W] (rows ``[m * h, (m + 1) *
    h)``), rows outside ``[0, M * h)`` set to ``fill``, in ``x``'s memory
    format.  ``rows(r)`` must give every rank's range: each rank builds the
    same exchange.  Differentiable: a borrowed row's gradient is added to its
    owner's."""
    split = _split
    size, m, h = split.size, split.index, x.shape[2]
    total = size * h
    ranges = [rows(r) for r in range(size)]
    depth = max(max(r * h - a, b - (r + 1) * h, 0) for r, (a, b) in enumerate(ranges))
    start, stop = ranges[m]
    if depth == 0:
        return x[:, :, start - m * h:stop - m * h]
    e = min(depth, h)
    slot = e if e == h else 2 * e

    def source(g: int) -> tuple:
        """Where global row g comes from: ("local", j), ("gathered", p) or
        ("fill",); rank q's row j is in its first e rows or its last e."""
        if g < 0 or g >= total:
            return ("fill",)
        q, j = divmod(g, h)
        if q == m:
            return ("local", j)
        return ("gathered", q * slot + (j if j < e else e + j - (h - e)))

    pieces = []  # runs of consecutive rows of one source
    for g in range(start, stop):
        kind, *at = source(g)
        last = pieces[-1] if pieces else None
        if last and last[0] == kind and (kind == "fill" or last[2] == at[0]):
            pieces[-1] = (kind, last[1] + 1) if kind == "fill" else (kind, last[1], at[0] + 1)
        else:
            pieces.append((kind, 1) if kind == "fill" else (kind, at[0], at[0] + 1))
    return _FetchRows.apply(x, split, e, tuple(pieces), fill)


def window_rows(x: torch.Tensor, kernel: int, stride: int, padding: int, dilation: int,
                fill: float = 0.0) -> torch.Tensor:
    """The input rows that this rank's output rows of a sliding window
    (a conv's or a pool's, along H) read, its padding rows included as
    ``fill``: run the window on the result with H padding 0.  Global output
    rows ``[o0, o1)`` read input rows ``o0 * s - p`` to ``(o1 - 1) * s - p +
    (k - 1) * d``.  The global output height must split evenly over the
    group (``ValueError`` otherwise)."""
    split = _split
    h = x.shape[2]
    total = split.size * h
    out = (total + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    if out % split.size:
        raise ValueError(
            f"a {kernel}x{kernel} window of stride {stride} maps {total} rows to {out}, "
            f"which do not split evenly over a model axis of {split.size}: the crop size "
            f"must be a multiple of output_stride * model_axis")
    rows = out // split.size

    def needed(r: int) -> Tuple[int, int]:
        o0, o1 = r * rows, (r + 1) * rows
        return o0 * stride - padding, (o1 - 1) * stride - padding + (kernel - 1) * dilation + 1

    reach = (kernel - 1) * dilation + 1
    if all(needed(r) == (r * h, needed(r)[1]) and needed(r)[1] <= (r + 1) * h
           for r in range(split.size)) and (h - reach) // stride + 1 == rows:
        return x  # rows of its own only, and the rows past the last read give no output
    return fetch_rows(x, needed, fill)


def resize_rows(x: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Bilinear resize along H (``align_corners=False``) of this rank's rows
    ``x`` [B, C, h, W] of an image of ``M * h`` rows to its share
    ``out_rows`` of ``M * out_rows``: global source coordinates, clamped only
    at the global image's edges; the float32 blend is cast back to x's dtype."""
    split = _split
    size, h = split.size, x.shape[2]
    src_total, out_total = size * h, size * out_rows
    scale = src_total / out_total

    def taps(y: int) -> Tuple[int, int, float]:
        src = max(scale * (y + 0.5) - 0.5, 0.0)
        y0 = int(src)
        return y0, y0 + (1 if y0 < src_total - 1 else 0), src - y0

    def needed(r: int) -> Tuple[int, int]:
        ys = [taps(y) for y in range(r * out_rows, (r + 1) * out_rows)]
        return min(t[0] for t in ys), max(t[1] for t in ys) + 1

    ext = fetch_rows(x, needed)
    start = needed(split.index)[0]
    ys = [taps(y) for y in range(split.index * out_rows, (split.index + 1) * out_rows)]
    first = ext.index_select(2, _constant(tuple(t[0] - start for t in ys), x.device)).float()
    second = ext.index_select(2, _constant(tuple(t[1] - start for t in ys), x.device)).float()
    weight = _constant(tuple(t[2] for t in ys), x.device, torch.float32).reshape(1, 1, -1, 1)
    return (first * (1.0 - weight) + second * weight).to(x.dtype, memory_format=_layout(x))
