"""Image rows split over the ranks of a model group: what GSPMD does for the
JAX package's ``P(data, model)`` images (``__graft_entry__.py``
``dryrun_multichip``, ``parallel/mesh.py`` ``spatial_sharding``).

Every activation of the train forward is split over the M ranks of a model
group in GSPMD's layout (:func:`shard`): of H global rows, rank m holds
``[m * c, min((m + 1) * c, H))`` with ``c = ceil(H / M)``, so that the
maps of odd height that Xception's VALID stems make (512 rows to 255, 253,
127) split unevenly, the last rank holding fewer rows.  The input images
split evenly (``parallel/mesh.py`` ``spatial_rows``).  An operator that
reads across a row boundary fetches a halo first: the rows of its
neighbours (or farther ranks, where the halo is taller than a shard) that
its own output rows need, with a fill value for rows outside the global
image (0 for a conv's padding, -inf for the max-pool's).  The operators
that do so check :func:`current` (``models/layers.py`` ``Conv2d``,
``QatConv2d``, ``MaxPool2d``, ``GlobalAvgPool2d``; ``ops/resize.py``);
outside :func:`spatially_split` they run as on one device, so validation,
evaluation and serving make no collective.

A rank cannot tell the global height of a map from its own rows (8 rows of
rank 0 are a share of 15 or of 16), so an operator learns it once: the
first call of each operator (its ``owner``, a module) for a global input
height of the step all-gathers the ranks' row counts (:func:`extents`) and
caches the sums on the owner; every rank makes that exchange at the same
call, and a later step makes none (``row_exchanges`` counts them).

Every other part of the step needs nothing new: a rank's pixels are its own,
so the cross-replica BatchNorm (which sums its counts), the sharded CE
(which sums its weights) and the summing gradient reduction over the
default group give the global batch's numbers.  The ASPP pooling branch is
the one tensor replicated over a model group; its group sum's backward is a
group sum, so that each rank's partial gradient reaches every rank's rows.

The exchange is one simple scheme: every rank all-gathers its first and last
``E`` rows (E the deepest halo any rank needs, below every rank's height),
or its whole shard padded to the tallest (where a halo reaches past a
shard), and builds its halo from them; the backward all-reduces the
gathered rows' gradients and takes back its own.  Every rank makes both
collectives of a window, whether or not it borrows a row, and keeps its
activations' memory format (channels last on the card), so that no conv
converts its input.  ``all_gather`` and ``all_reduce`` are in both ``gloo``
and ``nccl``.  ``collectives`` and ``collective_bytes`` count the calls and
the bytes of the tensors they produce, forward and backward; ``recomputed``
the calls of them that a rematerialized segment's recomputation made
(``models/remat.py``, which runs it under the split of its first forward).

The fused stem and blocks have no path for a rank's rows: as GSPMD gathers
the activations of an opaque kernel, every rank of a model group runs them
on the group's whole map (:func:`on_whole_map`: one exchange of whole
shards, :func:`whole_map`) and keeps its own rows of the output
(:func:`keep_rows`).  Every rank of a
model group then holds the whole map's BatchNorm sums, so those sums go over
the split's data group (:func:`statistics_group`, the ranks of this rank's
model index), which counts every pixel of the global batch once; the
backward sums the statistics' cotangents over that group too, and the
ranks' partial gradients add up, in the exchange's backward and in the
gradient reduction, to the global batch's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from . import distributed

# calls and bytes (of each collective's output tensor) since the last reset;
# of the calls, those a rematerialized segment's recomputation made
collectives = {"halo_gather": 0, "halo_reduce": 0, "group_sum": 0}
collective_bytes = {"halo_gather": 0, "halo_reduce": 0, "group_sum": 0}
recomputed = {"halo_gather": 0, "halo_reduce": 0, "group_sum": 0}
row_exchanges = 0  # all-gathers of row counts (:func:`extents`)


def reset_counts() -> None:
    global row_exchanges
    for d in (collectives, collective_bytes, recomputed):
        for k in d:
            d[k] = 0
    row_exchanges = 0


@dataclass(frozen=True)
class Split:
    """The model group a rank's rows are split over: its process group,
    size M and this rank's index m in it; ``rows`` the global height of the
    step's input images (a key of the operators' cached extents);
    ``recompute`` whether a rematerialized segment's recomputation runs
    under it; ``data_group`` the ranks of this rank's model index
    (:func:`statistics_group`)."""

    group: object
    size: int
    index: int
    rows: Optional[int] = None
    recompute: bool = False
    data_group: object = None


# module-wide, not thread-local: the autograd engine runs a CUDA backward on
# its own thread
_split: Optional[Split] = None


@contextlib.contextmanager
def spatially_split(mesh=None, rows: Optional[int] = None):
    """Within: the spatial operators treat every activation as this rank's
    rows of the model group of ``mesh`` (a ``parallel.Mesh``) of an input
    image of ``rows`` global rows; ``mesh`` None or with a model axis of 1
    is a no-op."""
    split = (Split(mesh.group, mesh.model, mesh.model_index, rows,
                   data_group=mesh.data_group)
             if mesh is not None and mesh.model > 1 else None)
    with restored(split) if split is not None else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def restored(split: Optional[Split], recompute: bool = False):
    """Within: ``split`` in force (a :func:`current` of an earlier forward;
    with ``recompute``, counted in ``recomputed`` as well)."""
    global _split
    previous = _split
    if split is not None and recompute:
        split = dataclasses.replace(split, recompute=True)
    _split = split
    try:
        yield
    finally:
        _split = previous


def current() -> Optional[Split]:
    """The split in force, or None."""
    return _split


def statistics_group():
    """The process group that a fused kernel's BatchNorm sums go over: the
    split's data group (the ranks of this rank's model index, whose whole
    maps are the global batch, each pixel once); None (the default group)
    outside a split, where each rank holds its own rows."""
    split = _split
    if split is None:
        return None
    if split.data_group is None:
        raise ValueError("the split's mesh has no data group: build it with make_mesh")
    return split.data_group


def _count(kind: str, t: torch.Tensor, split: Optional[Split] = None) -> None:
    collectives[kind] += 1
    collective_bytes[kind] += t.numel() * t.element_size()
    split = _split if split is None else split
    if split is not None and split.recompute:
        recomputed[kind] += 1


def shard(total: int, size: int, index: int) -> Tuple[int, int]:
    """The global rows ``[start, stop)`` that rank ``index`` of ``size``
    holds of ``total``: GSPMD's layout, chunks of ``ceil(total / size)``, the
    last ones shorter or empty."""
    chunk = -(-total // size)
    return min(index * chunk, total), min((index + 1) * chunk, total)


def _layout(x: torch.Tensor):
    """The memory format whose strides ``x``'s are (a slice of): channels
    last where the channels are innermost, as the model's activations on the
    card.  Every tensor made here keeps it, so that no conv converts."""
    return (torch.channels_last if x.dim() == 4 and x.stride(1) == 1 and x.shape[1] > 1
            else torch.contiguous_format)


# owner -> {(group size, input rows): global totals}, filled by extents()
_extents = weakref.WeakKeyDictionary()


def extents(owner, device, *rows: int) -> Tuple[int, ...]:
    """The global heights of the maps of which this rank holds ``rows``
    rows each (an operator's input, and for a resize its output).  The
    first call for ``owner`` (a module, the same on every rank) at the
    split's group size and input height all-gathers every rank's counts
    over the model group (on ``device``, a host sync), checks that they are
    :func:`shard`'s layout and caches their sums on ``owner``; ``owner``
    None exchanges at every call.  Every rank must make the same calls."""
    global row_exchanges
    split = _split
    cache = None if owner is None else _extents.setdefault(owner, {})
    key = (split.size, split.rows)
    if cache is None or key not in cache:
        local = torch.tensor(rows, dtype=torch.int64, device=device)
        parts = [torch.empty_like(local) for _ in range(split.size)]
        dist.all_gather(parts, local, group=split.group)
        row_exchanges += 1
        counts = torch.stack(parts).tolist()
        totals = tuple(sum(c[i] for c in counts) for i in range(len(rows)))
        for i, total in enumerate(totals):
            layout = [shard(total, split.size, r) for r in range(split.size)]
            if [c[i] for c in counts] != [b - a for a, b in layout]:
                raise ValueError(f"the ranks hold {[c[i] for c in counts]} rows of a map of "
                                 f"{total}, not the layout {layout}")
        if cache is not None:
            cache[key] = totals
        return totals
    totals = cache[key]
    for total, h in zip(totals, rows):
        start, stop = shard(total, split.size, split.index)
        if stop - start != h:
            raise ValueError(f"rank {split.index} holds {h} rows where {owner!r} saw a map of "
                             f"{total} rows ({stop - start} a rank {split.index}) before")
    return totals


class _FetchRows(torch.autograd.Function):
    """The halo exchange of :func:`fetch_rows`: all-gather every rank's
    ``slot`` rows (its first and last ``e`` rows, or its whole shard padded
    to ``e`` rows where ``whole``), then concatenate ``pieces``, each
    ``("local", a, b)`` (rows of ``x``), ``("gathered", a, b)`` (rows of the
    gathered slots, rank q's at ``[q * slot, (q + 1) * slot)``) or
    ``("fill", n)``.  The backward scatters the output's gradient back,
    all-reduces the gathered rows' part over the group and adds this rank's
    slot of it to its rows."""

    @staticmethod
    def forward(ctx, x, split, e, whole, pieces, fill):
        layout = _layout(x)
        h = x.shape[2]
        if whole:
            edges = x if e == h else torch.cat(
                [x, x.new_zeros((*x.shape[:2], e - h, x.shape[3]))], dim=2)
        else:
            edges = torch.cat([x[:, :, :e], x[:, :, h - e:]], dim=2)
        edges = edges.contiguous(memory_format=layout)
        parts = [torch.empty_like(edges) for _ in range(split.size)]
        dist.all_gather(parts, edges, group=split.group)
        gathered = torch.cat(parts, dim=2)
        _count("halo_gather", gathered, split)
        out = []
        for kind, *span in pieces:
            if kind == "fill":
                shape = (*x.shape[:2], span[0], x.shape[3])
                out.append(x.new_full(shape, fill).contiguous(memory_format=layout))
            else:
                out.append((x if kind == "local" else gathered)[:, :, span[0]:span[1]])
        ctx.split, ctx.e, ctx.whole, ctx.pieces = split, e, whole, pieces
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
        _count("halo_reduce", dgathered, split)
        h, slot = x_shape[2], gathered_shape[2] // split.size
        own = dgathered[:, :, split.index * slot:(split.index + 1) * slot]
        if ctx.whole:
            dx += own[:, :, :h]
        else:
            dx[:, :, :e] += own[:, :, :e]
            dx[:, :, h - e:] += own[:, :, e:]
        return dx, None, None, None, None, None


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group in force (differentiable)."""
    return distributed.group_sum(x, _split.group,
                                 functools.partial(_count, "group_sum", split=_split))


_constants = {}  # (values, dtype, device) -> tensor


def _constant(values: tuple, device, dtype=torch.long) -> torch.Tensor:
    """A small index or weight tensor on ``device``, made once."""
    key = (values, dtype, str(device))
    if key not in _constants:
        _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return _constants[key]


def fetch_rows(x: torch.Tensor, rows: Callable[[int], Tuple[int, int]], total: int,
               fill: float = 0.0) -> torch.Tensor:
    """The global rows ``[start, stop)`` = ``rows(m)`` of the image of
    ``total`` rows whose :func:`shard` this rank holds in ``x`` [B, C, h,
    W], rows outside ``[0, total)`` set to ``fill``, in ``x``'s memory
    format.  ``rows(r)`` must give every rank's range: each rank builds the
    same exchange.  Differentiable: a borrowed row's gradient is added to its
    owner's."""
    split = _split
    size, m = split.size, split.index
    own = [shard(total, size, r) for r in range(size)]
    chunk, heights = -(-total // size), [b - a for a, b in own]
    ranges = [rows(r) for r in range(size)]
    depth = max(max(o0 - a, b - o1, 0) for (a, b), (o0, o1) in zip(ranges, own))
    (start, stop), first = ranges[m], own[m][0]
    if depth == 0:
        return x[:, :, start - first:stop - first]
    whole = depth >= min(heights)
    e = max(heights) if whole else depth
    slot = e if whole else 2 * e

    def source(g: int) -> tuple:
        """Where global row g comes from: ("local", j), ("gathered", p) or
        ("fill",); rank q's row j is in its first e rows or its last e."""
        if g < 0 or g >= total:
            return ("fill",)
        q = g // chunk
        j = g - own[q][0]
        if q == m:
            return ("local", j)
        return ("gathered", q * slot + (j if whole or j < e else e + j - (heights[q] - e)))

    pieces = []  # runs of consecutive rows of one source
    for g in range(start, stop):
        kind, *at = source(g)
        last = pieces[-1] if pieces else None
        if last and last[0] == kind and (kind == "fill" or last[2] == at[0]):
            pieces[-1] = (kind, last[1] + 1) if kind == "fill" else (kind, last[1], at[0] + 1)
        else:
            pieces.append((kind, 1) if kind == "fill" else (kind, at[0], at[0] + 1))
    return _FetchRows.apply(x, split, e, whole, tuple(pieces), fill)


def global_shape(x: torch.Tensor, owner=None) -> tuple:
    """``x``'s [B, C, H, W] with H the global height of the map whose rows
    it holds under the split (:func:`extents`, keyed by ``owner``), as it is
    outside the split: what a choice between an operator's paths must be
    made on, the same on every rank."""
    if _split is None:
        return tuple(x.shape)
    (total,) = extents(owner, x.device, x.shape[2])
    return (*x.shape[:2], total, x.shape[3])


def whole_map(x: torch.Tensor, owner=None) -> torch.Tensor:
    """The model group's whole map of which this rank holds the rows ``x``
    [B, C, h, W], in ``x``'s memory format (every rank's shard gathered);
    ``owner`` keys its global height (:func:`extents`).  Differentiable:
    each rank's gradient of a row is added to its owner's."""
    (total,) = extents(owner, x.device, x.shape[2])
    return fetch_rows(x, lambda r: (0, total), total)


class _KeepRows(torch.autograd.Function):
    """The rows ``[start, stop)`` of ``out`` in its memory format; the
    backward puts their gradient in zeros of ``out``'s shape and format."""

    @staticmethod
    def forward(ctx, out, start, stop):
        ctx.shape, ctx.layout, ctx.span = out.shape, _layout(out), (start, stop)
        return out[:, :, start:stop].contiguous(memory_format=ctx.layout)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.span
        dout = grad.new_zeros(ctx.shape).contiguous(memory_format=ctx.layout)
        dout[:, :, start:stop] = grad
        return dout, None, None


def keep_rows(out: torch.Tensor) -> torch.Tensor:
    """This rank's rows (:func:`shard`) of the whole map ``out`` [B, C, H,
    W] that an operator computed from :func:`whole_map`'s input, in
    ``out``'s memory format."""
    split = _split
    start, stop = shard(out.shape[2], split.size, split.index)
    return _KeepRows.apply(out, start, stop)


def on_whole_map(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 owner=None) -> torch.Tensor:
    """``fn(x)`` for an operator with no path for a rank's rows: outside a
    split as it is; under one, ``fn`` of the model group's whole map
    (:func:`whole_map`, keyed by ``owner``) and this rank's rows of its
    output (:func:`keep_rows`)."""
    if _split is None:
        return fn(x)
    return keep_rows(fn(whole_map(x, owner)))


def _output_shards(total: int, size: int, what: str) -> list:
    layout = [shard(total, size, r) for r in range(size)]
    if any(a == b for a, b in layout):
        raise ValueError(f"{what} has {total} rows, which leave a rank of a model axis of "
                         f"{size} none: the crop is too small for the model axis")
    return layout


def window_rows(x: torch.Tensor, kernel: int, stride: int, padding: int, dilation: int,
                fill: float = 0.0, owner=None) -> torch.Tensor:
    """The input rows that this rank's output rows of a sliding window
    (a conv's or a pool's, along H) read, its padding rows included as
    ``fill``: run the window on the result with H padding 0.  Global output
    rows ``[o0, o1)`` read input rows ``o0 * s - p`` to ``(o1 - 1) * s - p +
    (k - 1) * d``.  ``owner`` keys the input's global height
    (:func:`extents`); a window of one row and stride 1 needs none."""
    split = _split
    if kernel == 1 and stride == 1 and padding == 0:
        return x  # each output row reads its own input row
    (total,) = extents(owner, x.device, x.shape[2])
    out = (total + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    outputs = _output_shards(out, split.size, f"a {kernel}x{kernel} window of stride {stride} "
                                              f"on {total} rows")
    inputs = [shard(total, split.size, r) for r in range(split.size)]
    reach = (kernel - 1) * dilation + 1

    def needed(r: int) -> Tuple[int, int]:
        o0, o1 = outputs[r]
        return o0 * stride - padding, (o1 - 1) * stride - padding + reach

    if all(needed(r)[0] == a and needed(r)[1] <= b
           and (b - a - reach) // stride + 1 == o1 - o0
           for r, ((a, b), (o0, o1)) in enumerate(zip(inputs, outputs))):
        return x  # rows of its own only, and the rows past the last read give no output
    return fetch_rows(x, needed, total, fill)


def resize_rows(x: torch.Tensor, out_rows: int, owner=None) -> torch.Tensor:
    """Bilinear resize along H (``align_corners=False``) of this rank's rows
    ``x`` [B, C, h, W] of an image to its share ``out_rows`` of the
    output: global source coordinates, clamped only at the global image's
    edges; the float32 blend is cast back to x's dtype.  ``owner`` keys the
    two global heights (:func:`extents`)."""
    split = _split
    src_total, out_total = extents(owner, x.device, x.shape[2], out_rows)
    outputs = _output_shards(out_total, split.size, "a resize's output")
    scale = src_total / out_total

    def taps(y: int) -> Tuple[int, int, float]:
        src = max(scale * (y + 0.5) - 0.5, 0.0)
        y0 = int(src)
        return y0, y0 + (1 if y0 < src_total - 1 else 0), src - y0

    def needed(r: int) -> Tuple[int, int]:
        ys = [taps(y) for y in range(*outputs[r])]
        return min(t[0] for t in ys), max(t[1] for t in ys) + 1

    ext = fetch_rows(x, needed, src_total)
    start = needed(split.index)[0]
    ys = [taps(y) for y in range(*outputs[split.index])]
    first = ext.index_select(2, _constant(tuple(t[0] - start for t in ys), x.device)).float()
    second = ext.index_select(2, _constant(tuple(t[1] - start for t in ys), x.device)).float()
    weight = _constant(tuple(t[2] for t in ys), x.device, torch.float32).reshape(1, 1, -1, 1)
    return (first * (1.0 - weight) + second * weight).to(x.dtype, memory_format=_layout(x))
