"""Time two builds of a kernel source in turns on one CUDA card: the bf16
backward of the fused blocks, the 1x1 (#7b, ``--kind mm``, the default) or
the 3x3 (#8b, ``--kind c3``), or their bf16 forward (#7a ``--kind mm_fwd``,
#8a ``--kind c3_fwd``) of ``iswm_tpu_torch/csrc/fused_block.cu``, the
int8 1x1 kernel (#1 and #2, ``--kind int8``) of
``iswm_tpu_torch/csrc/int8_matmul.cu``, the fused stem's bf16 backward
(#11a and #11b, ``--kind stem``) of ``iswm_tpu_torch/csrc/fused_stem.cu``, or
the int8 convs of ``int8_exec_xla`` (``--kind igemm``: ``conv_s8_igemm``;
``--kind direct``: ``conv_s8_direct``) of ``iswm_tpu_torch/csrc/int8_conv.cu``.

For ``mm`` and ``c3``, at every shape of ``chip_smoke.BLOCK_MM_SHAPES`` (or
``BLOCK_C3_SHAPES``) it times, with the inputs out of L2
(``chip_smoke.ColdTimer``), the two C entries of one backward, each with its
finishing sum: the data gradient and the weight gradient.  For ``mm_fwd``
and ``c3_fwd`` it times there ``iswm_fb_fwd`` with its finishing sum, and
says at which shapes the builds give the same y bits (the 1x1's products
run in the same order in both bodies).  For ``int8``, at
every shape of ``chip_smoke.SLICE_SHAPES`` and at M = 1000, it times the two
C entries, ``iswm_int8_matmul`` on bf16 x and ``iswm_int8_matmul_prequant``
on the same x quantized, and checks that head and base give the same bits.
For ``ce``, at the training slice's logits [8, 2, 512, 512] bf16
channels-last with int32 labels (``chip_smoke.CE_SLICE``), it times the two
C entries of ``iswm_tpu_torch/csrc/fused_ce.cu``, the forward and the
backward (#4), with the inputs out of L2 and also from L2, checks that each
build's forward is bit-stable and within 1e-5 relative of the plain version
in float64, and that every build's backward gives the base's bits.
For ``stem``, at the slice's z [8, 64, 256, 256] bf16 NHWC
(``chip_smoke.STEM_SLICE``), it times the two C entries of ``stem_tail_bwd``,
``iswm_stem_bwd_sums`` (#11a) and ``iswm_stem_bwd_wgrad`` (#11b), each with
its finishing sum, and checks that every build is within phase 10's limits
(1e-5 * max|tensor| of the plain version summed in float64) and gives the
same bits in two launches.
For ``igemm``, at every dense shape of a ResNet-50 ``int8_exec_xla`` chunk
(``chip_smoke.XLA_IGEMM_SHAPES``, and, outside the chunk's sums, the stem and
``XLA_ODD_SHAPES``), and for ``direct`` at MobileNetV2's depthwise shapes
(``XLA_DEPTHWISE_SHAPES``), it times the C entry of each build with the
inputs out of L2: the base in float32 (the PR-15 entries have no other
output), every other build in float32 and in each site's dtype (bf16, but
float32 for the concat conv's parts, ``chip_smoke.XLA_F32_SITES``); it checks
that every build's float32 output has the base's bits, its bf16 output the
base's rounded, and the head's the plain version's.  A base source without
the ``out_bf16`` argument (PR 15's) is bound with its own signatures.
The builds are the checkout's source ("head"), a base source given by path,
and any number of edited copies of the head; each shape is timed base,
head, edits..., then in the reverse order, and the summed totals weight each
shape by its launches a train step (a serving chunk for ``int8``).  Run from
the root of the checkout:

    git show <commit>:iswm_tpu_torch/csrc/fused_block.cu > build/fused_block_base.cu
    python3 block_bwd_ab.py --base build/fused_block_base.cu [--kind c3] \\
        [--edit NAME 'OLD=>NEW' ...] [--out build/block_bwd_ab.json]

    git show <commit>:iswm_tpu_torch/csrc/int8_matmul.cu > build/int8_matmul_base.cu
    python3 block_bwd_ab.py --kind int8 --base build/int8_matmul_base.cu [--edit ...]

    git show <commit>:iswm_tpu_torch/csrc/fused_stem.cu > build/fused_stem_base.cu
    python3 block_bwd_ab.py --kind stem --base build/fused_stem_base.cu [--edit ...]

    git show <commit>:iswm_tpu_torch/csrc/fused_ce.cu > build/fused_ce_base.cu
    python3 block_bwd_ab.py --kind ce --base build/fused_ce_base.cu [--edit ...]

    git show 8bdb19b:iswm_tpu_torch/csrc/int8_conv.cu > build/int8_conv_base.cu
    python3 block_bwd_ab.py --kind igemm --base build/int8_conv_base.cu [--edit ...]
    python3 block_bwd_ab.py --kind direct --base build/int8_conv_base.cu

``--kind wgrad`` compares QAT's int8 weight gradient (``conv_s8_wgrad`` of
``int8_conv.cu``) at the real codes and cotangents of one int8-backward QAT
step of ResNet-50 (batch 8 at 512^2, gate 256), each distinct shape once,
weighted by its sites, each build's whole entry timed (every launch it
makes: the checkout's planar copies too) and held to the plain version's
bits.  The base is PR 18's source, driven through its own entry
(``iswm_int8_conv_wgrad`` on the NHWC codes, its pixel splits, its
finishing pass); the checkout and its edits through ``kc.conv_s8_wgrad``:

    git show 96ec4bf:iswm_tpu_torch/csrc/int8_conv.cu > build/int8_conv_base.cu
    python3 block_bwd_ab.py --kind wgrad --base build/int8_conv_base.cu [--edit ...]

``--kind dgrad`` does the same for the data gradient (``conv_s8_dgrad``) at
the step's 49 calls: commit e3404bf's source through its own entry
(``dilate_kernel`` zero-inserting g at a stride of 2, then the dense body at
``dgrad_geometry`` over the codes made by ATen, ``quantize_weight_rotated``)
against the
checkout's parity split over the rows its ``rotated_weight_codes`` makes,
each build's data gradient and weight preparation timed apart, every dx
held to the plain version's bits.  ``--kind quantize`` times the step's 98
quantizes (the forward's activations and the backward's cotangents): that
source's ATen amax (``vector_norm``, a cast) and device-amax quantize, against the
checkout's one reducing launch (and, beside it, the ATen amax with the
checkout's one-pass quantize); and serving's host-scale quantize at a
chunk's 33 dense-site inputs, each build's codes held to the plain version's:

    git show e3404bf:iswm_tpu_torch/csrc/int8_conv.cu > build/int8_conv_base.cu
    python3 block_bwd_ab.py --kind dgrad --base build/int8_conv_base.cu
    python3 block_bwd_ab.py --kind quantize --base build/int8_conv_base.cu

With ``--sweep`` (``--kind int8``, ``mm_fwd``, ``c3_fwd``, ``stem``, ``ce``,
``igemm``, ``wgrad`` or ``dgrad``, no base) it times instead the checkout's
build under every plan
that fits (int8: rows of a strip, ring stages, N groups, K splits, for both
entries; the forward: its tiles and, for the 1x1, the column tiles a block
walks; the stem: the conv-pixel tiles of ``STEM_TILES`` for both kernels;
ce: vectors a thread and blocks of ``CE_PLANS``; igemm and dgrad: the
block's tile width, BN and ring slots of ``DENSE_PLANS`` and the K splits, in
the site's output dtype), at the same shapes, beside
the plan the kernel's planner (the stem: its built-in tiles) picks, and
checks that every plan gives the planner's y (the stem: that every tile is
within the float64 limits and bit-stable, at the slice and at a side ragged
against every tile; ce: forward sums within those limits and bit-stable,
d_logits equal to the built-in plan's); ``--kind ce --sweep`` also counts
the SASS instructions of the slice's instantiations (``cuobjdump``):

    python3 block_bwd_ab.py --kind int8 --sweep --out build/int8_sweep.json
    python3 block_bwd_ab.py --kind c3_fwd --sweep --out build/c3_fwd_sweep.json
    python3 block_bwd_ab.py --kind stem --sweep --out build/stem_sweep.json
    python3 block_bwd_ab.py --kind ce --sweep --out build/ce_sweep.json
    python3 block_bwd_ab.py --kind igemm --sweep --out build/igemm_sweep.json
    python3 block_bwd_ab.py --kind dgrad --sweep --out build/dgrad_sweep.json

An edit replaces the text OLD of the head's source, which must occur once, by
NEW (``--edit NAME 'OLD=>NEW' ['OLD2=>NEW2' ...]`` makes each replacement in
one build): for example a stage of a kernel taken out, to see what it costs.
Such a build computes wrong values and is only timed; ``chip_smoke.py``
phases 3, 7, 10 and 12 check the head's values.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from iswm_tpu_torch.ops.kernels import build
from iswm_tpu_torch.ops.kernels import fused_block as fb
from iswm_tpu_torch.ops.kernels import fused_ce as ce
from iswm_tpu_torch.ops.kernels import fused_stem as fs
from iswm_tpu_torch.ops.kernels import int8_conv as kc
from iswm_tpu_torch.ops.kernels import int8_matmul as k8


def build_source(text: str, name: str, bind=fb.bind) -> ctypes.CDLL:
    """Compile ``text`` as build/kernels/<name>.cu with the port's flags."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = build.BUILD_DIR / f"{name}.cu", build.BUILD_DIR / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return bind(ctypes.CDLL(str(lib)))


def edited(head: str, edits: list) -> str:
    for edit in edits:
        old, new = edit.split("=>")
        if head.count(old) != 1:
            raise ValueError(f"the edit's text occurs {head.count(old)} times, not once: {old!r}")
        head = head.replace(old, new)
    return head


def half_bounds(m: int, k: int, n: int, prologue: bool, taps: int = 1) -> tuple[float, float]:
    """Least times (ms) of the bf16 data gradient and weight gradient alone,
    each reading its own inputs once: together more than the whole call's
    bound, since both read dy and y."""
    e, vec, ops = 2, 2 * k * 4 * bool(prologue), 2 * m * taps * k * n
    dgrad = (2 * m * n * e + taps * k * n * e + 2 * n * 4 + m * k * e * (1 + bool(prologue))
             + 2 * vec)  # dy, y, w, ds, dq, x, a, b in; dx, da, db out
    wgrad = m * k * e + 2 * m * n * e + 2 * n * 4 + vec + taps * k * n * 4  # ... dw out, f32
    return tuple(cs.least_time(b, ops, cs.BF16_OPS_PER_S)["bound_ms"] for b in (dgrad, wgrad))


def time_blocks(args, libs: dict, cold) -> None:
    """The fused-block backward (#7b or #8b) of every build at every shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    totals = {name: [0.0, 0.0] for name in libs}
    rows = []
    if args.kind == "mm":
        cases = {(shape[:3], shape[3]): count for shape, count in cs.BLOCK_MM_SHAPES.items()}
    else:
        cases = {(shape, True): count for shape, count in cs.BLOCK_C3_SHAPES.items()}

    def gemm(shape):  # (M, K, N, taps) of a case
        if args.kind == "mm":
            return (*shape, 1)
        bsz, h, wd, k, n = shape
        return bsz * h * wd, k, n, 9

    for (shape, prologue), count in cases.items():
        x, w, a, b, dy, ds, dq = cs._fb_inputs(args.kind, shape, torch.bfloat16, gen)
        fwd = cs._fb_calls(fb, args.kind, prologue, x, w, a, b)[0]
        y = fwd()[0]
        halves = {name: cs._bwd_halves(lib, args.kind, x, w, a, b, y, dy, ds, dq, prologue)
                  for name, lib in libs.items()}
        times = {name: ([], []) for name in libs}
        for name in order:
            for half, fn in zip(times[name], halves[name]):
                half.append(cold(fn))
        m, k, n, taps = gemm(shape)
        row = {"shape": [*shape, prologue], "count": count,
               "bound_ms": cs._fb_bound(args.kind, shape, prologue, 2)[1]["bound_ms"],
               "half_bounds_ms": half_bounds(m, k, n, prologue, taps)}
        for name, (dgrad, wgrad) in times.items():
            row[name] = {"dgrad_ms": dgrad, "wgrad_ms": wgrad}
            totals[name][0] += count * sum(dgrad) / len(dgrad)
            totals[name][1] += count * sum(wgrad) / len(wgrad)
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
        del x, w, dy, y, halves
    launches = sum(cases.values())
    bounds = [sum(count * half_bounds(*gemm(shape)[:3], prologue, gemm(shape)[3])[i]
                  for (shape, prologue), count in cases.items()) for i in range(2)]
    print(f"[ab] one train step's {launches} launches, the halves' own bounds: data gradient "
          f"{bounds[0]:.4f} ms, weight gradient {bounds[1]:.4f} ms")
    for name, (dgrad, wgrad) in totals.items():
        print(f"[ab] one train step's {launches} launches, {name}: data gradient {dgrad:.4f} ms, "
              f"weight gradient {wgrad:.4f} ms, both {dgrad + wgrad:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals}))


FWD_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))  # the 3x3 takes the 128-row ones
FWD_NT = (1, 2, 4, 8)  # column tiles a 1x1 block walks


def fwd_cases(kind: str) -> dict:
    """{(shape, prologue): launches a train step} of the forward ``kind``."""
    if kind == "mm_fwd":
        return {(shape[:3], shape[3]): count for shape, count in cs.BLOCK_MM_SHAPES.items()}
    return {(shape, True): count for shape, count in cs.BLOCK_C3_SHAPES.items()}


def fwd_entry(lib: ctypes.CDLL, kind: str, x, w, a, b, prologue: bool, plan=None):
    """``iswm_fb_fwd`` of a build on one case with its finishing sum (or, with
    ``plan`` = (BM, BN, nt), ``iswm_fb_fwd_planned``), on outputs and scratch made
    here once, as ``fused_block._launch_fwd`` makes them: a callable that
    returns (y, sq)."""
    if kind == "mm_fwd":
        (m, k), n = x.shape, w.shape[1]
        taps, h, wd, w_nk = 1, 1, m, w.t().contiguous()
    else:
        bsz, h, wd, k = x.shape
        n, m, taps = w.shape[3], bsz * h * wd, 9
        w_nk = w.to(x.dtype).permute(3, 0, 1, 2).reshape(n, taps * k).contiguous()
    f32 = {"dtype": torch.float32, "device": x.device}
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    scratch, sq = torch.empty(lib.iswm_fb_sums_scratch(m, n), **f32), torch.empty(2 * n, **f32)
    ab = (a.data_ptr(), b.data_ptr()) if prologue else (None, None)
    head = (x.data_ptr(), w_nk.data_ptr(), *ab, y.data_ptr(), scratch.data_ptr(), sq.data_ptr())
    plan = None if plan is None else (ctypes.c_int * 3)(*plan)

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if plan is None:
            rc = lib.iswm_fb_fwd(*head, int(x.dtype == torch.bfloat16), taps, int(prologue), m,
                                 h, wd, k, n, stream)
        else:
            rc = lib.iswm_fb_fwd_planned(*head, taps, int(prologue), m, h, wd, k, n, plan, stream)
        if rc:
            raise RuntimeError(f"iswm_fb_fwd: {lib.iswm_cuda_error_string(rc).decode()}")
        return y, sq

    return run


def fwd_gemm(kind: str, shape) -> tuple:
    """(M, C, N, taps, GFLOP) of a forward case."""
    if kind == "mm_fwd":
        m, k, n = shape
        return m, k, n, 1, 2 * m * k * n / 1e9
    bsz, h, wd, k, n = shape
    return bsz * h * wd, k, n, 9, 2 * bsz * h * wd * 9 * k * n / 1e9


def time_forward(args, libs: dict, cold) -> None:
    """The fused-block forward (#7a or #8a) of every build at every shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    totals = dict.fromkeys(libs, 0.0)
    rows, bounds = [], []
    kind = args.kind[:2]
    cases = fwd_cases(args.kind)
    for (shape, prologue), count in cases.items():
        x, w, a, b, *_ = cs._fb_inputs(kind, shape, torch.bfloat16, gen)
        calls = {name: fwd_entry(lib, args.kind, x, w, a, b, prologue)
                 for name, lib in libs.items()}
        ys = {name: fn()[0].clone() for name, fn in calls.items()}
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cold(calls[name]))
        m, c, n, taps, gflop = fwd_gemm(args.kind, shape)
        bound = cs._fb_bound(kind, shape, prologue, 2)[0]
        bounds += [bound] * count
        row = {"shape": [*shape, prologue], "count": count, "bound_ms": bound["bound_ms"],
               "bound_by": bound["bound_by"], "gflop": gflop,
               "y_equal_to_base": bool(torch.equal(ys["base"], ys["head"]))}
        if hasattr(libs["head"], "iswm_fb_fwd_plan"):
            row["plan"] = fb.plan_fwd(m, c, n, taps, prologue)
        for name, ts in times.items():
            row[name] = ts
            totals[name] += count * sum(ts) / len(ts)
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
        del x, w, calls, ys
    least = cs.sum_bounds(bounds)
    launches = sum(cases.values())
    for name, total in totals.items():
        print(f"[ab] one train step's {launches} launches of {args.kind}, {name}: {total:.4f} ms "
              f"(bound {least['bound_ms']:.4f} ms by {least['bound_by']})")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "bound": least}))


def sweep_forward(args, lib, cold) -> None:
    """Every plan of the bf16 forward at each slice shape (its tiles and, for
    the 1x1, the column tiles a block walks), through the head build's
    planned entry: cold times beside the planner's own plan, every plan's y
    equal to the planner's (the products run in the same order)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    kind = args.kind[:2]
    for (shape, prologue), count in fwd_cases(args.kind).items():
        x, w, a, b, *_ = cs._fb_inputs(kind, shape, torch.bfloat16, gen)
        m, c, n, taps, _ = fwd_gemm(args.kind, shape)
        chosen = fb.plan_fwd(m, c, n, taps, prologue)
        want = fwd_entry(lib, args.kind, x, w, a, b, prologue)()[0].clone()
        first = (chosen["bm"], chosen["bn"], chosen["nt"])
        plans = [first] + [(bm, bn, nt) for bm, bn in FWD_TILES if kind == "mm" or bm == 128
                           for nt in (FWD_NT if kind == "mm" else (1,)) if nt <= -(-n // bn)]
        times = {}
        for plan in plans:
            if plan in times:
                continue
            call = fwd_entry(lib, args.kind, x, w, a, b, prologue, plan)
            got = call()[0]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"plan {plan} at {shape} gives another y than the planner's")
            times[plan] = cold(call)
        best = min(times, key=times.get)
        rows.append({"shape": [*shape, prologue], "count": count, "chosen": first,
                     "chosen_ms": times[first], "best": best, "best_ms": times[best],
                     "plans": {" ".join(map(str, p)): v for p, v in times.items()}})
        print(f"[sweep] {args.kind} {shape}: planned {first} {times[first]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms; " + ", ".join(f"{p} {v:.4f}" for p, v in times.items()),
              flush=True)
        del x, w, want
    picked = sum(r["count"] * r["chosen_ms"] for r in rows)
    best = sum(r["count"] * r["best_ms"] for r in rows)
    print(f"[sweep] one train step's {args.kind}: the planner's plans {picked:.4f} ms, the best "
          f"plan at each shape {best:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": f"{args.kind} sweep", "shapes": rows}))


def int8_calls(lib: ctypes.CDLL, x, x_q, w_t, w_scale, x_scale: float, out):
    """The two C entries of an int8_matmul.cu build on one shape's tensors."""
    m, k = x.shape
    n = w_t.shape[0]

    def call(rc):
        if rc:
            raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
        return out

    def stream():
        return torch.cuda.current_stream().cuda_stream

    return (
        lambda: call(lib.iswm_int8_matmul(x.data_ptr(), 1, w_t.data_ptr(), w_scale.data_ptr(),
                                          x_scale, out.data_ptr(), m, k, n, stream())),
        lambda: call(lib.iswm_int8_matmul_prequant(x_q.data_ptr(), w_t.data_ptr(),
                                                   w_scale.data_ptr(), x_scale, out.data_ptr(),
                                                   m, k, n, stream())),
    )


def time_int8(args, libs: dict, cold) -> None:
    """#1 (bf16 x) and #2 (int8 x) of every build at the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    entries = ("int8_matmul_ms", "prequant_ms")
    totals = {name: [0.0, 0.0] for name in libs}
    rows = []
    cases = {**cs.SLICE_SHAPES, (1000, 256, 128): 0}
    differ = []
    for (m, k, n), count in cases.items():
        x, w_q, w_scale, x_scale = cs._case(m, k, n, "bf16", gen)
        xs = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
        x_q = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
        w_t = w_q.t().contiguous()
        outs = {name: torch.empty((m, n), dtype=torch.float32, device="cuda") for name in libs}
        calls = {name: int8_calls(lib, x, x_q, w_t, w_scale, x_scale, outs[name])
                 for name, lib in libs.items()}
        for entry, base_fn, head_fn in zip(entries, calls["base"], calls["head"]):
            want = base_fn().clone()  # the same bits from both builds
            got = head_fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                differ.append(f"{entry} at {(m, k, n)}: {int((got != want).sum())} values")
        times = {name: ([], []) for name in libs}
        for name in order:
            for entry, fn in zip(times[name], calls[name]):
                entry.append(cold(fn))
        row = {"shape": [m, k, n], "count": count,
               "bound_ms": [cs.matmul_bound(m, k, n, b)["bound_ms"] for b in (2, 1)],
               "plan": [k8.plan(m, k, n, b) for b in (2, 1)]}
        for name, (quant, pre) in times.items():
            row[name] = dict(zip(entries, (quant, pre)))
            totals[name][0] += count * sum(quant) / len(quant)
            totals[name][1] += count * sum(pre) / len(pre)
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
        del x, x_q, w_t, outs, calls
    bounds = [cs.sum_bounds([cs.matmul_bound(*shape, b) for shape, count in cases.items()
                             for _ in range(count)])["bound_ms"] for b in (2, 1)]
    sites = sum(cases.values())
    for name, (quant, pre) in totals.items():
        print(f"[ab] one chunk's {sites} sites, {name}: int8_matmul {quant:.4f} ms (bound "
              f"{bounds[0]:.4f}), int8_matmul_prequant {pre:.4f} ms (bound {bounds[1]:.4f})")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "head_differs_from_base": differ}))
    if differ:
        raise SystemExit("head and base differ: " + "; ".join(differ))


def sweep_int8(args, lib, cold) -> None:
    """Every plan that fits, at each serving shape and M = 1000, for bf16 x
    and int8 x, through the head build's planned entry: cold times beside
    the planner's own choice, each plan's output equal to the planner's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    plans = [(bm, st, g, sp) for bm in (128, 64, 32) for st in (4, 3) for g in (1, 2)
             for sp in (1, 2, 4)]
    for (m, k, n), count in {**cs.SLICE_SHAPES, (1000, 256, 128): 0}.items():
        x, w_q, w_scale, x_scale = cs._case(m, k, n, "bf16", gen)
        xs = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
        x_q = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
        w_t = w_q.t().contiguous()
        out = torch.empty((m, n), dtype=torch.float32, device="cuda")
        for xv in (x, x_q):
            nbytes = xv.element_size()
            chosen = k8.plan(m, k, n, nbytes)
            times = {}
            want = None
            for p in [tuple(chosen[key] for key in k8.PLAN_KEYS[:4])] + plans:
                if p in times:
                    continue
                arr = (ctypes.c_int * 4)(*p)

                def call():
                    return lib.iswm_int8_matmul_planned(
                        xv.data_ptr(), nbytes, w_t.data_ptr(), w_scale.data_ptr(), x_scale,
                        out.data_ptr(), m, k, n, arr, torch.cuda.current_stream().cuda_stream)

                if call():
                    continue  # the plan does not fit the shape
                torch.cuda.synchronize()
                if want is None:
                    want = out.clone()
                elif not torch.equal(out, want):
                    raise SystemExit(f"plan {p} at {(m, k, n)} x {xv.dtype} differs")
                times[p] = cold(call)
            best = min(times, key=times.get)
            first = next(iter(times))
            row = {"shape": [m, k, n], "count": count, "x_bytes": nbytes, "chosen": first,
                   "chosen_ms": times[first], "best": best, "best_ms": times[best],
                   "plans": {" ".join(map(str, p)): t for p, t in times.items()}}
            rows.append(row)
            print(f"[sweep] {(m, k, n)} x {nbytes} B: planned {first} {times[first]:.4f} ms, "
                  f"best {best} {times[best]:.4f} ms of {len(times)} plans", flush=True)
    for nbytes in (2, 1):
        picked = sum(r["count"] * r["chosen_ms"] for r in rows if r["x_bytes"] == nbytes)
        best = sum(r["count"] * r["best_ms"] for r in rows if r["x_bytes"] == nbytes)
        print(f"[sweep] one chunk's sites, x of {nbytes} B: the planner's plans {picked:.4f} ms, "
              f"the best plan at each shape {best:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "int8 sweep", "shapes": rows}))


STEM_TILES = ((8, 16), (8, 32), (16, 16), (4, 32))  # the tiles fused_stem.cu builds
STEM_RAGGED = (2, 36)  # batch and side of a case ragged against every tile


def stem_case(b: int, s: int, gen) -> tuple:
    """(z, x, dp, the sums' vectors, the weight gradient's vectors) of the bf16
    backward at batch b and side s, made as phase 10 makes them; s1 and s2 for
    the weight gradient come from the checkout's build."""
    z, x, dp, gamma, beta = cs._stem_case(b, s, torch.bfloat16, gen)
    n = b * s * s
    total, total_sq = fs.stem_stats(z)
    mean = total / n
    sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + 1e-5)
    vecs = (*fs.fold_affine(gamma, beta, mean, sigma_inv), mean, sigma_inv)
    s1, s2 = fs.stem_bwd_sums(z, dp, *vecs)
    return z, x, dp, vecs, (*vecs, s1 / n, s2 / n)


def stem_calls(lib: ctypes.CDLL, z, x, dp, vecs, wvecs, tiles=None) -> tuple:
    """(sums(), wgrad()): the two bf16 C entries of a fused_stem.cu build with
    their finishing sums (with ``tiles`` = (rows, columns), the tiled entries),
    on outputs and scratch made here once."""
    f32 = {"dtype": torch.float32, "device": z.device}
    reduce_scratch = torch.empty(lib.iswm_stem_reduce_scratch(), **f32)
    wgrad_scratch = torch.empty(lib.iswm_stem_wgrad_scratch(), **f32)
    sums, dw = torch.empty(128, **f32), torch.empty((64, 3, 7, 7), **f32)
    b, s = z.shape[0], z.shape[2]
    v, w = [t.data_ptr() for t in vecs], [t.data_ptr() for t in wvecs]

    def done(rc, out):
        if rc:
            raise RuntimeError(f"stem backward: {lib.iswm_cuda_error_string(rc).decode()}")
        return out

    def run_sums():
        stream = torch.cuda.current_stream().cuda_stream
        if tiles is None:
            rc = lib.iswm_stem_bwd_sums(z.data_ptr(), dp.data_ptr(), 1, b, s, *v,
                                        reduce_scratch.data_ptr(), sums.data_ptr(), stream)
        else:
            rc = lib.iswm_stem_bwd_sums_tiled(z.data_ptr(), dp.data_ptr(), b, s, *v,
                                              reduce_scratch.data_ptr(), sums.data_ptr(),
                                              *tiles, stream)
        return done(rc, sums)

    def run_wgrad():
        stream = torch.cuda.current_stream().cuda_stream
        if tiles is None:
            rc = lib.iswm_stem_bwd_wgrad(z.data_ptr(), dp.data_ptr(), x.data_ptr(), 1, b, s, *w,
                                         wgrad_scratch.data_ptr(), dw.data_ptr(), stream)
        else:
            rc = lib.iswm_stem_bwd_wgrad_tiled(z.data_ptr(), dp.data_ptr(), x.data_ptr(), b, s,
                                               *w, wgrad_scratch.data_ptr(), dw.data_ptr(),
                                               *tiles, stream)
        return done(rc, dw)

    return run_sums, run_wgrad


def stem_check(calls, want) -> dict:
    """Errors of (s1, s2, dW) against ``want`` in float64, within phase 10's
    1e-5 * max|tensor|, and whether two launches give the same bits."""
    sums, dw = (fn().clone() for fn in calls)
    again = [fn().clone() for fn in calls]
    torch.cuda.synchronize()
    out = {"bit_stable": bool(torch.equal(sums, again[0]) and torch.equal(dw, again[1]))}
    ok = out["bit_stable"]
    for key, got, ref in (("s1", sums[:64], want[0]), ("s2", sums[64:], want[1]),
                          ("dw", dw, want[2])):
        err, within = cs._close(got, ref)
        out[f"{key}_err"] = err
        ok = ok and within
    out["ok"] = ok
    return out


def stem_reference(z, x, dp, vecs, wvecs) -> tuple:
    """(s1, s2, dW) of the plain versions summed in float64."""
    return (*fs.stem_bwd_sums_plain(z, dp, *vecs, dtype=torch.float64),
            fs.stem_bwd_wgrad_plain(z, dp, x, *wvecs, dtype=torch.float64))


def time_stem(args, libs: dict, cold) -> None:
    """#11a and #11b of every build at the slice's shape, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s = cs.STEM_SLICE
    z, x, dp, vecs, wvecs = stem_case(b, s, gen)
    want = stem_reference(z, x, dp, vecs, wvecs)
    calls = {name: stem_calls(lib, z, x, dp, vecs, wvecs) for name, lib in libs.items()}
    checks = {name: stem_check(fns, want) for name, fns in calls.items()}
    times = {name: ([], []) for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        for half, fn in zip(times[name], calls[name]):
            half.append(cold(fn))
    least = cs.stem_bounds(z, x, dp)[0]
    bound = {k: least[k]["bound_ms"] for k in ("sums", "wgrad")}
    row = {"shape": [b, 64, s, s], "bound_ms": bound,
           "bound_by": {k: least[k]["bound_by"] for k in bound}, "checks": checks,
           "tiles": fs.bwd_tiles()}
    for name, (sums, wgrad) in times.items():
        row[name] = {"sums_ms": sums, "wgrad_ms": wgrad}
        ms = {"sums": sum(sums) / len(sums), "wgrad": sum(wgrad) / len(wgrad)}
        print(f"[ab] stem backward, {name}: #11a sums {ms['sums']:.4f} ms "
              f"({100 * bound['sums'] / ms['sums']:.1f}% of its bound), #11b wgrad "
              f"{ms['wgrad']:.4f} ms ({100 * bound['wgrad'] / ms['wgrad']:.1f}%); "
              f"checks {checks[name]}", flush=True)
    print("[ab] " + json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "stem", "shapes": [row]}))
    failed = [name for name, c in checks.items() if not c["ok"]]
    if failed:
        raise SystemExit(f"builds outside phase 10's limits or not bit-stable: {failed}")


def sweep_stem(args, lib, cold) -> None:
    """Every tile of ``STEM_TILES`` for both kernels: checked at the slice and
    at ``STEM_RAGGED``, timed at the slice, beside the built-in tiles."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    for b, s in (cs.STEM_SLICE, STEM_RAGGED):
        z, x, dp, vecs, wvecs = stem_case(b, s, gen)
        want = stem_reference(z, x, dp, vecs, wvecs)
        for tile in STEM_TILES:
            calls = stem_calls(lib, z, x, dp, vecs, wvecs, tile)
            check = stem_check(calls, want)
            row = {"shape": [b, 64, s, s], "tile": tile, "check": check}
            if not check["ok"]:
                bad.append(row)
            if (b, s) == cs.STEM_SLICE:
                row["sums_ms"], row["wgrad_ms"] = (cold(fn) for fn in calls)
            rows.append(row)
            print("[sweep] " + json.dumps(row), flush=True)
        del z, x, dp, want
    timed = [r for r in rows if "sums_ms" in r]
    best = {k: min(timed, key=lambda r: r[f"{k}_ms"])["tile"] for k in ("sums", "wgrad")}
    print(f"[sweep] stem backward: built-in tiles {fs.bwd_tiles()}, fastest {best}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "stem sweep", "rows": rows, "fastest": best}))
    if bad:
        raise SystemExit(f"tiles outside phase 10's limits or not bit-stable: {bad}")


CE_PLANS = {"fwd": [(v, nb) for v in (1, 2, 4) for nb in (256, 512, 1024)],
            "bwd": [(v, nb) for v in (1, 2, 4) for nb in (1024, 2048, 4096, 8192)]}


def ce_case():
    """The slice's logits (bf16 channels-last), int32 labels and class weights."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    logits, labels = cs._ce_case(cs.CE_SLICE, torch.bfloat16, gen, channels_last=True)
    return logits, labels, torch.tensor(cs.CE_WEIGHTS, device="cuda")


def ce_calls(lib: ctypes.CDLL, logits, labels, cw, plans=((0, 0), (0, 0))) -> tuple:
    """(fwd(), bwd()): the two C entries of a fused_ce.cu build on the slice,
    with its own outputs and workspace; ``plans`` gives (vectors, blocks) of
    each, (0, 0) for the built-in.  A source from before the layouts (no
    workspace entry) takes its own arguments."""
    f32 = {"dtype": torch.float32, "device": logits.device}
    out, d_logits = torch.empty(2, **f32), torch.empty_like(logits)
    grad, w_sum = torch.tensor(1.0, **f32), torch.tensor(float((labels != 255).sum()), **f32)
    b, _, h, w = logits.shape
    geom = (b, h, w, *logits.stride())
    ptrs = (logits.data_ptr(), 1, labels.data_ptr(), 1, cw.data_ptr())
    new = hasattr(lib, "iswm_fused_ce_workspace_bytes")
    if new:
        ws = torch.zeros(lib.iswm_fused_ce_workspace_bytes() // 4, dtype=torch.int32,
                         device=logits.device)
        layout = ce.choose_layout(logits.shape, logits.stride(),
                                  (logits.data_ptr(), labels.data_ptr(), d_logits.data_ptr()),
                                  d_logits.stride())
    else:
        ws = torch.empty(2 * lib.iswm_fused_ce_max_partials(), **f32)

    def done(rc, result):
        if rc:
            raise RuntimeError(f"fused CE: {lib.iswm_cuda_error_string(rc).decode()}")
        return result

    def fwd():
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            return done(ce.launch_fwd(lib, logits, labels, cw, 255, layout, ws, out, stream,
                                      *plans[0]), out)
        return done(lib.iswm_fused_ce_fwd(*ptrs, 255, *geom, ws.data_ptr(), out.data_ptr(),
                                          stream), out)

    def bwd():
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            return done(ce.launch_bwd(lib, logits, labels, cw, grad, w_sum, 255, layout,
                                      d_logits, stream, *plans[1]), d_logits)
        return done(lib.iswm_fused_ce_bwd(*ptrs, grad.data_ptr(), w_sum.data_ptr(), 255, *geom,
                                          d_logits.data_ptr(), *d_logits.stride(), stream),
                    d_logits)

    return fwd, bwd


def ce_check(calls, want, d_want=None) -> dict:
    """The forward sums' relative error from ``want`` (float64, limit 1e-5)
    and their bits in two launches; whether d_logits equals ``d_want``."""
    sums, again = calls[0]().clone(), calls[0]().clone()
    d = calls[1]().clone()
    torch.cuda.synchronize()
    rel = float(((sums.double() - want).abs() / want.abs()).max())
    out = {"sums": sums.tolist(), "fwd_rel_err": rel, "bit_stable": bool(torch.equal(sums, again))}
    out["ok"] = rel <= 1e-5 and out["bit_stable"]
    if d_want is not None:
        out["bwd_bits_equal"] = bool(torch.equal(d, d_want))
        out["ok"] = out["ok"] and out["bwd_bits_equal"]
    return out, d


def ce_bounds(logits, labels) -> dict:
    """Phase 5's least times of the forward and the backward."""
    moved = logits.numel() * logits.element_size() + labels.numel() * labels.element_size()
    least = {"fwd": moved, "bwd": moved + logits.numel() * logits.element_size()}
    return {k: cs.least_time(b, 12 * labels.numel(), cs.F32_OPS_PER_S) for k, b in least.items()}


def graph_ms(fn, flush=None, calls: int = 20, reps: int = 5) -> float:
    """Per-call time of fn() replayed in a CUDA graph of ``calls`` calls, by
    CUDA events: the gaps between dependent kernels count, the host's launch
    overhead does not.  With ``flush`` (a call that evicts L2), each call
    follows one, and the graph time of the flushes alone is taken off."""
    def per_call(body):
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                body()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * calls)

    if flush is None:
        return per_call(fn)
    return per_call(lambda: (flush(), fn())) - per_call(flush)


def read_flush(cold):
    """An L2 eviction that leaves clean lines: a sum over ``cold``'s 256 MB
    buffer (its rewrite leaves 50 MB of dirty lines, whose write-back the
    next kernel's reads pay for)."""
    words, out = cold.flush.view(torch.float32), torch.zeros((), device="cuda")
    return lambda: torch.sum(words, 0, out=out)


def time_ce(args, libs: dict, cold) -> None:
    """#4's forward and backward of every build at the slice, in turns, with
    the inputs out of L2 (cold) and from L2 (warm)."""
    logits, labels, cw = ce_case()
    want = ce.fused_binary_ce_fwd_plain(logits, labels, cw, dtype=torch.float64)
    calls = {name: ce_calls(lib, logits, labels, cw) for name, lib in libs.items()}
    checks, d_base = {}, None
    for name, fns in calls.items():  # "base" first where there is one
        checks[name], d = ce_check(fns, want, d_base)
        d_base = d if d_base is None else d_base
    kinds = ("", "_warm", "_graph", "_graph_clean", "_graph_warm")
    times = {name: {d + kind: [] for kind in kinds for d in ("fwd", "bwd")} for name in libs}
    clean = read_flush(cold)
    for name in list(libs) + list(libs)[::-1]:
        for key, fn in zip(("fwd", "bwd"), calls[name]):
            times[name][key].append(cold(fn))
            times[name][key + "_warm"].append(cs.device_ms(fn, reps=args.reps * 4))
            times[name][key + "_graph"].append(graph_ms(fn, cold.flush.zero_))
            times[name][key + "_graph_clean"].append(graph_ms(fn, clean))
            times[name][key + "_graph_warm"].append(graph_ms(fn))
    least = ce_bounds(logits, labels)
    row = {"shape": [*logits.shape], "layout": "channels_last bf16, int32 labels",
           "bound_ms": {k: v["bound_ms"] for k, v in least.items()}, "checks": checks}
    for name, t in times.items():
        row[name] = t
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"[ab] fused CE, {name}: forward {ms['fwd']:.4f} ms cold, {ms['fwd_warm']:.4f} "
              f"from L2 ({100 * least['fwd']['bound_ms'] / ms['fwd']:.1f}% of its bound); "
              f"backward {ms['bwd']:.4f} cold, {ms['bwd_warm']:.4f} from L2 "
              f"({100 * least['bwd']['bound_ms'] / ms['bwd']:.1f}%); in a CUDA graph (kernel "
              f"gaps included) forward {ms['fwd_graph']:.4f} cold, {ms['fwd_graph_clean']:.4f} "
              f"after a clean eviction, {ms['fwd_graph_warm']:.4f} from L2, backward "
              f"{ms['bwd_graph']:.4f}, {ms['bwd_graph_clean']:.4f}, {ms['bwd_graph_warm']:.4f}; "
              f"checks {checks[name]}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "ce", "shapes": [row]}))
    failed = [name for name, c in checks.items() if not c["ok"]]
    if failed:
        raise SystemExit(f"builds outside the limits, not bit-stable or with other "
                         f"backward bits than the base's: {failed}")


def sass_counts(lib: ctypes.CDLL, keep: str = "") -> tuple[list, str]:
    """Per ``ce_`` kernel of the build: its registers, its SASS instructions,
    those of its longest loop (from a backward branch's target to the
    branch) and its MUFU (transcendental unit) instructions, by cuobjdump;
    and the SASS of the kernels whose name holds ``keep``."""
    tools = Path(build.find_nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    usage = subprocess.run([str(tools / "cuobjdump"), "-res-usage", lib._name],
                           capture_output=True, text=True, check=True).stdout
    registers = dict(re.findall(r"Function (\S+):\s*REG:(\d+)", usage))
    rows, kept = [], []
    for part in sass.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        demangled = subprocess.run([str(tools / "cu++filt"), name], capture_output=True,
                                   text=True).stdout.strip() or name
        if "ce_" not in demangled:
            continue
        if keep and keep in demangled:
            kept.append(f"Function : {demangled}\n{part}")
        instrs, labels, pending = {}, {}, []
        for line in part.splitlines():
            line = line.strip()
            label = re.fullmatch(r"(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
            found = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if found:
                addr = int(found.group(1), 16)
                instrs[addr] = found.group(2)
                labels.update((name_, addr) for name_ in pending)
                pending = []
        loop = 0
        for addr, text in instrs.items():
            if "BRA" not in text.split():
                continue
            target = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if target is None:
                continue
            to = labels.get(target.group(1)) if target.group(1) else int(target.group(2), 16)
            if to is not None and to < addr:
                loop = max(loop, sum(1 for a in instrs if to <= a <= addr))
        rows.append({"kernel": demangled, "registers": int(registers.get(name, -1)),
                     "instructions": len(instrs), "loop": loop,
                     "mufu": sum(1 for t in instrs.values() if "MUFU" in t)})
    return rows, "".join(kept)


def sweep_ce(args, lib, cold) -> None:
    """#4 under every (vectors, blocks) of ``CE_PLANS`` beside the built-in
    plan, at the slice: cold and warm times, the forward's limits and the
    backward's bits against the built-in plan's; then the SASS counts."""
    logits, labels, cw = ce_case()
    want = ce.fused_binary_ce_fwd_plain(logits, labels, cw, dtype=torch.float64)
    builtin = ce_calls(lib, logits, labels, cw)
    _, d_want = ce_check(builtin, want)
    plans = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    for backward, out in enumerate(plans):
        lib.iswm_fused_ce_plan(backward, 2, 1, labels.numel(), out)
    least = ce_bounds(logits, labels)
    rows, bad = [], []
    for key, index in (("fwd", 0), ("bwd", 1)):
        for plan in [(0, 0)] + CE_PLANS[key]:
            both = [(0, 0), (0, 0)]
            both[index] = plan
            calls = ce_calls(lib, logits, labels, cw, tuple(both))
            check, _ = ce_check(calls, want, d_want)
            row = {"kernel": key, "plan": list(plan) if plan != (0, 0) else
                   ["built-in", *plans[index]], "check": check,
                   "ms": cold(calls[index]), "warm_ms": cs.device_ms(calls[index], reps=40),
                   "graph_ms": graph_ms(calls[index], cold.flush.zero_),
                   "graph_warm_ms": graph_ms(calls[index]), "bound_ms": least[key]["bound_ms"]}
            rows.append(row)
            if not check["ok"]:
                bad.append(row)
            print("[sweep] " + json.dumps(row), flush=True)
    # the slice's instantiations: bf16 logits, int32 labels, channels-last, 32-bit
    counts, text = sass_counts(lib, keep="<__nv_bfloat16, int, (int)2, unsigned int,")
    for c in counts:
        print("[sass] " + json.dumps(c), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.with_suffix(".sass.txt").write_text(text)
    args.out.write_text(json.dumps({"kind": "ce sweep", "rows": rows, "sass": counts}))
    if bad:
        raise SystemExit(f"plans outside the limits or with other backward bits: {bad}")


def bind_conv(lib: ctypes.CDLL, pr15: bool = False) -> ctypes.CDLL:
    """An int8_conv.cu build: the checkout's signatures, or PR 15's (float32
    out, no plan) for a source whose entries take no ``out_bf16``."""
    if not pr15:
        lib = kc.bind(lib)
        lib.pr15 = False
        return lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(i32)
    lib.iswm_int8_conv_igemm.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, ints, ptr]
    lib.iswm_int8_conv_direct.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, ints, i32, ptr]
    for fn in (lib.iswm_int8_conv_igemm, lib.iswm_int8_conv_direct):
        fn.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    lib.pr15 = True
    return lib


def bind_zero_insert(lib: ctypes.CDLL) -> ctypes.CDLL:
    """An int8_conv.cu build from before the reducing quantize and the
    parity split (commits 57618a6 to e3404bf): its quantize, dense and
    data-gradient entries."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    ints = ctypes.POINTER(i32)
    lib.iswm_int8_quantize.argtypes = [ptr, i32, f32, ptr, i32, i32, i64, ptr]
    lib.iswm_int8_quantize_amax.argtypes = [ptr, i32, ptr, ptr, i32, i32, i64, ptr]
    lib.iswm_int8_conv_igemm.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, i32, ints, ints, ptr, ptr]
    lib.iswm_int8_conv_igemm_amax.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ints, ints, ptr,
                                              ptr]
    lib.iswm_int8_conv_direct.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, i32, ints, i32, i32, ptr]
    lib.iswm_int8_conv_dgrad.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ints, i32, i32,
                                         i32, i32, ints, ptr, ptr]
    for fn in (lib.iswm_int8_quantize, lib.iswm_int8_quantize_amax, lib.iswm_int8_conv_igemm,
               lib.iswm_int8_conv_igemm_amax, lib.iswm_int8_conv_direct,
               lib.iswm_int8_conv_dgrad):
        fn.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    lib.pr15 = False
    return lib


def conv_shapes(kind: str) -> dict:
    """{(B, H, W, C, N, k, stride, pad, dil, groups): launches a chunk}."""
    if kind == "igemm":
        extra = {s: 0 for s in (cs.XLA_STEM_SHAPE, *cs.XLA_ODD_SHAPES)}
        return {(*s, 1): n for s, n in {**cs.XLA_IGEMM_SHAPES, **extra}.items()}
    return {(b, h, w, c, c, 3, s, p, d, c): n
            for (b, h, w, c, s, p, d), n in cs.XLA_DEPTHWISE_SHAPES.items()}


def conv_call(lib, shape, case, dtype=torch.float32, plan=None):
    """A call of ``lib``'s conv entry on one shape's tensors -> its output;
    ``plan`` (``plan_igemm``'s keys) overrides the planner's for the wgmma
    body."""
    b, h, w, c, n, k, stride, pad, dil, groups = shape
    x_q, w_q, w_scale, bias = case
    g = kc.conv_geometry(x_q.shape, w_q.shape, stride, pad, dil, groups)
    kk = w_q[0].numel()
    wt = kc._weight_rows(w_q) if groups == 1 else w_q.contiguous()
    out = torch.empty((b, g["Ho"], g["Wo"], n), dtype=dtype, device="cuda")
    bf16 = int(dtype == torch.bfloat16)
    head = (x_q.data_ptr(), wt.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), 0.0123, out.data_ptr())
    partial = None
    if groups == 1 and not lib.pr15:
        g, arr = kc.dense_launch(g, dtype, plan)
        if arr[4] > 1:
            partial = torch.empty(arr[4] * out.numel(), dtype=torch.int32, device="cuda")
        arr = (ctypes.c_int * 6)(*arr)
    geom = (ctypes.c_int * 17)(*(g[key] for key in kc.GEOM_KEYS), kk, wt.shape[1])

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if lib.pr15:
            rc = (lib.iswm_int8_conv_igemm(*head, geom, stream) if groups == 1 else
                  lib.iswm_int8_conv_direct(*head, geom, groups, stream))
        elif groups == 1:
            rc = lib.iswm_int8_conv_igemm(*head, bf16, geom, arr,
                                          None if partial is None else partial.data_ptr(), stream)
        else:
            body = 0 if kc.direct_body(g, groups) == "tiled" else 1
            rc = lib.iswm_int8_conv_direct(*head, bf16, geom, groups, body, stream)
        if rc:
            raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
        return out

    call.keep = (wt, partial)  # the padded weight rows and the partials live with the call
    return call


def site_dtype(shape, count: int) -> dict:
    """{output dtype: launches a chunk} of a dense shape's sites."""
    f32 = cs.XLA_F32_SITES.get(shape[:9], 0) if shape[9] == 1 else 0
    return {torch.bfloat16: count - f32, torch.float32: f32}


def gmma_counts(lib: ctypes.CDLL) -> dict:
    """{kernel of the build whose name holds "igemm": its warpgroup MMA
    instructions (SASS ``IGMMA`` / ``HGMMA``) and its ``HMMA`` / ``IMMA``
    ones}, by cuobjdump."""
    tools = Path(build.find_nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        if "igemm" not in name:
            continue
        demangled = subprocess.run([str(tools / "cu++filt"), name], capture_output=True,
                                   text=True).stdout.strip() or name
        ops = re.findall(r"\b([A-Z]+MMA)\b", part)
        counts[demangled] = {op: ops.count(op) for op in sorted(set(ops))}
    return counts


def time_conv(args, libs: dict, cold) -> None:
    """conv_s8_igemm (or conv_s8_direct) of every build at the chunk's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    totals = {name: {"f32": 0.0, "site": 0.0} for name in libs}
    rows, differ = [], []
    for shape, count in conv_shapes(args.kind).items():
        groups = shape[9]
        case = cs._conv_case(shape[:9], gen, groups)
        plain = kc.conv_s8_plain(case[0], case[1], case[2], 0.0123, case[3], shape[6],
                                 shape[7], shape[8], groups)
        dtypes = site_dtype(shape, count)
        calls = {}
        for name, lib in libs.items():
            calls[name] = {"f32": conv_call(lib, shape, case)}
            if not lib.pr15:
                calls[name]["bf16"] = conv_call(lib, shape, case, torch.bfloat16)
        base = calls["base"]["f32"]().clone()
        torch.cuda.synchronize()
        if not torch.equal(base, plain):
            differ.append(f"base at {shape} differs from the plain version")
        for name, entries in calls.items():
            for key, fn in entries.items():
                got = fn()
                torch.cuda.synchronize()
                want = base if key == "f32" else base.to(torch.bfloat16)
                if not torch.equal(got, want):
                    differ.append(f"{name} {key} at {shape}: {int((got != want).sum())} values")
        times = {name: {key: [] for key in entries} for name, entries in calls.items()}
        for name in order:
            for key, fn in calls[name].items():
                times[name][key].append(cold(fn))
        b, h, w, c, n, k, stride, pad, dil, _ = shape
        row = {"shape": list(shape), "count": count,
               "bound_ms": {key: cs.conv_bound(b, h, w, c, n, k, stride, pad, dil, groups,
                                               case[3] is not None, nb)["bound_ms"]
                            for key, nb in (("f32", 4), ("bf16", 2))}}
        if groups == 1 and kc.igemm_body(kc.conv_geometry(case[0].shape, case[1].shape, stride,
                                                          pad, dil)) == "wgmma":
            row["plan"] = kc.plan_igemm(kc.as_rows(kc.conv_geometry(
                case[0].shape, case[1].shape, stride, pad, dil)), 2)
        for name, entries in times.items():
            row[name] = {key: sum(v) / len(v) for key, v in entries.items()}
            totals[name]["f32"] += count * row[name]["f32"]
            site = sum(n_sites * row[name]["bf16" if d == torch.bfloat16 and "bf16" in row[name]
                                           else "f32"] for d, n_sites in dtypes.items())
            totals[name]["site"] += site
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
        del case, plain, base, calls
    sass = {}
    if args.kind == "igemm":
        for name, lib in libs.items():
            sass[name] = gmma_counts(lib)
            for kernel, ops in sass[name].items():
                print(f"[sass] {name} {kernel[:90]}: {ops}", flush=True)
    sites = sum(conv_shapes(args.kind).values())
    for name, total in totals.items():
        print(f"[ab] one chunk's {sites} {args.kind} launches, {name}: {total['f32']:.4f} ms in "
              f"float32, {total['site']:.4f} ms in each site's output dtype")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "sass": sass, "differs": differ}))
    if differ:
        raise SystemExit("builds differ: " + "; ".join(differ))


def sweep_igemm(args, lib, cold) -> None:
    """Every plan of the wgmma body (``kc.DENSE_PLANS`` x ``kc.TILE_WIDTHS``
    x ``kc.SPLITS``) at each dense shape, in the site's output dtype, beside
    the planner's: cold times, each plan's output equal to the planner's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, count in conv_shapes("igemm").items():
        b, h, w, c, n, k, stride, pad, dil, _ = shape
        case = cs._conv_case(shape[:9], gen)
        g = kc.conv_geometry(case[0].shape, case[1].shape, stride, pad, dil)
        if kc.igemm_body(g) != "wgmma":
            continue
        dtype = torch.float32 if site_dtype(shape, count)[torch.float32] else torch.bfloat16
        chosen = kc.plan_igemm(kc.as_rows(g), 2 if dtype == torch.bfloat16 else 4)
        keys = ("tw", "bn", "slots", "splits", "tma")
        first = tuple(chosen[key] for key in keys)
        want = conv_call(lib, shape, case, dtype)().clone()
        times = {}
        for plan in [first] + [(tw, bn, slots, sp, tma) for bn, slots in kc.DENSE_PLANS
                               for tw in kc.TILE_WIDTHS for sp in kc.SPLITS
                               for tma in ((False, True) if c % 64 == 0 else (False,))]:
            bn = plan[1]
            if plan in times or (bn == 8 and n > 8) or bn > 2 * max(n, 64):
                continue
            fn = conv_call(lib, shape, case, dtype, dict(zip(keys, plan)))
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"plan {plan} at {shape} differs from the planner's")
            times[plan] = cold(fn)
        best = min(times, key=times.get)
        row = {"shape": list(shape), "count": count, "dtype": str(dtype), "chosen": first,
               "chosen_ms": times[first], "best": best, "best_ms": times[best],
               "plans": {" ".join(map(str, p)): t for p, t in times.items()}}
        rows.append(row)
        print(f"[sweep] {shape} {dtype}: planned {first} {times[first]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms of {len(times)} plans", flush=True)
        del case, want
    picked = sum(r["count"] * r["chosen_ms"] for r in rows)
    best = sum(r["count"] * r["best_ms"] for r in rows)
    print(f"[sweep] one chunk's dense launches: the planner's plans {picked:.4f} ms, the best "
          f"plan at each shape {best:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "igemm sweep", "shapes": rows}))


def bind_pr18_wgrad(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A PR-18 int8_conv.cu build: its weight-gradient entry alone."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.iswm_int8_conv_wgrad.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ctypes.POINTER(i32), i32,
                                         ptr, ptr]
    lib.iswm_int8_conv_wgrad.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pr18_wgrad(lib: ctypes.CDLL, a, k):
    """A call of PR 18's entry as its wrapper made it: the NHWC codes, its
    splits' int32 partials (``kc.wgrad_splits``, the mma body's, PR 18's)
    and its finishing pass, out in OIHW."""
    x_q, g_q, x_amax, g_amax, kernel = a[:5]
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    c, n = x_q.shape[3], g_q.shape[3]
    if c % 4 or n % 4:
        raise ValueError(f"PR 18's entry takes channel counts of multiples of 4, got {c}, {n}")
    g = kc.conv_geometry(x_q.shape, (n, kh, kw, c), *a[5:8])
    splits = kc.wgrad_splits(g)
    geom = (ctypes.c_int * 17)(*(g[key] for key in kc.GEOM_KEYS), 0, 0)
    bf16 = k["out_dtype"] == torch.bfloat16

    def call():
        out = torch.empty((n, c, kh, kw), dtype=k["out_dtype"], device="cuda")
        partial = torch.empty((splits, kh * kw, n, c), dtype=torch.int32, device="cuda")
        rc = lib.iswm_int8_conv_wgrad(x_q.data_ptr(), g_q.data_ptr(), x_amax.data_ptr(),
                                      g_amax.data_ptr(), out.data_ptr(), int(bf16), geom, splits,
                                      partial.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
        return out
    return call


def step_shapes(kinds) -> dict:
    """The calls of ``kinds`` (``chip_smoke._qat_bwd_calls``'s) of one
    int8-backward QAT step of ResNet-50 (batch 8 at 512^2, gate 256), each
    distinct shape once: {key: [kind, args, kwargs, calls]}."""
    from iswm_tpu_torch.models import build_model_by_name

    model = build_model_by_name("deeplabv3plus_resnet50", int8_training=cs.QAT_GATE,
                                int8_training_bwd=True)
    model.to("cuda", memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 3, 512, 512), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    yu8 = torch.randint(0, 2, (8, 512, 512), generator=gen, device="cuda")
    shapes = {}
    for kind, a, k in cs._qat_bwd_calls(model, x, yu8):
        if kind in kinds:
            key = (kind, *(tuple(t.shape) if isinstance(t, torch.Tensor) else str(t) for t in a),
                   str(k))
            shapes.setdefault(key, [kind, a, k, 0])[3] += 1
    return shapes


def time_wgrad(args, libs: dict, cold) -> None:
    """conv_s8_wgrad of every build at one int8-backward QAT step's shapes:
    the base through its own entry (:func:`pr18_wgrad`), the checkout and
    its edits through ``kc.conv_s8_wgrad`` with their library; each build's
    device time a call is the sum of every kernel it launches, the planar
    copies' kernel also apart."""
    shapes = {key: (a, k, count) for key, (_, a, k, count) in step_shapes({"wgrad"}).items()}
    calls = sum(count for _, _, count in shapes.values())
    order = list(libs) + list(libs)[::-1]
    head_lib, rows, differ = kc._lib, [], []
    totals = {name: {"ms": 0.0, "planar_ms": 0.0} for name in libs}

    def run(name, a, k):
        if name == "base":
            return pr18_wgrad(libs["base"], a, k)

        def call():
            kc._lib = libs[name]
            return kc.conv_s8_wgrad(*a, **k)
        return call

    for key, (a, k, count) in shapes.items():
        want = kc.conv_s8_wgrad_plain(*a, **k)
        for name in libs:
            got = run(name, a, k)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                differ.append(f"{name} at {key}")
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cold.kernels(run(name, a, k)))
        geo = kc.conv_geometry(a[0].shape, (a[1].shape[3], *a[4], a[0].shape[3]), *a[5:8])
        row = {"shape": [list(a[0].shape), list(a[1].shape), str(a[4:])], "count": count,
               "body": kc.wgrad_body(geo), "bound_ms": cs._bwd_bound("wgrad", a, k)["bound_ms"]}
        for name, runs in times.items():
            row[name] = sum(sum(r.values()) for r in runs) / len(runs)
            row[f"{name}_planar_ms"] = sum(v for r in runs for n, v in r.items()
                                           if "planar_kernel" in n) / len(runs)
            totals[name]["ms"] += count * row[name]
            totals[name]["planar_ms"] += count * row[f"{name}_planar_ms"]
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    kc._lib = head_lib
    bound = sum(r["count"] * r["bound_ms"] for r in rows)
    for name, total in totals.items():
        print(f"[ab] conv_s8_wgrad over one step's {calls} sites, {name}: "
              f"{total['ms']:.4f} ms ({bound / total['ms']:.1%} of the bound {bound:.4f} ms), "
              f"its planar copies {total['planar_ms']:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "bound_ms": bound, "differs": differ}))
    if differ:
        raise SystemExit("builds differ from the plain version: " + "; ".join(differ))


def sweep_wgrad(args, lib, cold) -> None:
    """The wgmma body of conv_s8_wgrad at one int8-backward QAT step's
    shapes under 1 ... 64 splits a tap (work items) beside the planner's
    choice: device time a call with the inputs out of L2, each plan's output
    equal to the plain version's."""
    rows, bad = [], []
    for key, (_, a, k, count) in step_shapes({"wgrad"}).items():
        x_q, g_q, x_amax, g_amax = a[:4]
        geo = kc.conv_geometry(x_q.shape, (g_q.shape[3], *a[4], x_q.shape[3]), *a[5:8])
        if kc.wgrad_body(geo) != "wgmma":
            continue
        chosen = kc.wgrad_plan(geo)
        most = max(chosen["stages"])
        pers = sorted({d for d in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 48, 64) if d <= most}
                      | {chosen["splits"]})
        want = kc.conv_s8_wgrad_plain(*a, **k)
        times = {}
        for per in pers:
            p = kc.wgrad_plan(geo, per)
            if not p["items"]:  # past the partials' workspace
                continue
            n, c = g_q.shape[3], x_q.shape[3]
            kh, kw = geo["KH"], geo["KW"]
            out = torch.empty((n, c, kh, kw), dtype=k["out_dtype"], device="cuda")
            x_t = torch.empty(c * p["x_len"], dtype=torch.int8, device="cuda")
            g_t = torch.empty(n * p["g_len"], dtype=torch.int8, device="cuda")
            sums = torch.empty(p["items"] * n * c, dtype=torch.int32, device="cuda")

            def call(p=p, out=out, x_t=x_t, g_t=g_t, sums=sums):
                rc = lib.iswm_int8_conv_wgrad_tma(
                    x_q.data_ptr(), g_q.data_ptr(), x_t.data_ptr(), g_t.data_ptr(),
                    x_amax.data_ptr(), g_amax.data_ptr(), out.data_ptr(),
                    int(k["out_dtype"] == torch.bfloat16), p["c_geom"], p["c_ints"],
                    sums.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
                return out

            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad.append(f"{per} splits at {key}")
            by_kernel = cold.kernels(call)
            times[per] = {"ms": sum(by_kernel.values()), "blocks": p["blocks"],
                          "main_ms": sum(v for n_, v in by_kernel.items()
                                         if "wgrad_tma_kernel" in n_)}
        first = chosen["splits"]
        best = min(times, key=lambda q: times[q]["ms"])
        row = {"shape": [list(a[0].shape), list(a[1].shape), str(a[4:])], "count": count,
               "stages": list(chosen["stages"]), "tiles": chosen["m_tiles"] * chosen["j_tiles"],
               "bm": chosen["bm"], "chosen": first, "chosen_ms": times[first]["ms"],
               "best": best, "best_ms": times[best]["ms"], "plans": times}
        rows.append(row)
        print(f"[sweep] {key}: planned {first} splits ({chosen['blocks']} blocks) "
              f"{times[first]['ms']:.4f} ms, best {best} splits ({times[best]['blocks']} blocks) "
              f"{times[best]['ms']:.4f} ms", flush=True)
    picked = sum(r["count"] * r["chosen_ms"] for r in rows)
    best = sum(r["count"] * r["best_ms"] for r in rows)
    print(f"[sweep] one step's wgmma-body sites: the planner's plans {picked:.4f} ms, the best "
          f"plan at each shape {best:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "wgrad sweep", "shapes": rows, "bad": bad}))
    if bad:
        raise SystemExit("plans differ from the plain version: " + "; ".join(bad))


def zero_insert_dgrad(lib: ctypes.CDLL, a, k):
    """A call of the zero-inserting data gradient as its wrapper made it
    (:func:`bind_zero_insert`'s build), on the codes of a recorded call:
    ``dilate_kernel`` and the dense body at ``kc.dgrad_geometry`` (zeros
    inserted at a stride of 2), the planner's plan, the weight rows of the
    rotated codes, C float32 ones."""
    g_q, w_rows, g_amax, w_amax, x_hw, stride, pad, dil = a[:8]
    kernel = cs._dgrad_kernel(a, k)
    w4 = kc._rotated_codes(w_rows, kernel, g_q.shape[3], stride).contiguous()
    geo = kc.dgrad_geometry(g_q.shape, w4.shape, x_hw, stride, pad, dil)
    sh, sw = kc._pair(stride)
    dilated = (sh, sw) != (1, 1)
    out_dtype = k["out_dtype"]
    if kc.igemm_body(geo) == "bytes":
        run, plan = geo, (1, 0, 0, 0, 1, 0)
    else:
        run = geo if dilated else kc.as_rows(geo)
        p = kc.plan_igemm(run, 2 if out_dtype == torch.bfloat16 else 4)
        plan = (0, p["tw"].bit_length() - 1, p["bn"], p["slots"], p["splits"], int(p["tma"]))
    w = kc._weight_rows(w4)
    c = w4.shape[0]
    m = geo["B"] * geo["Ho"] * geo["Wo"]
    ones = torch.ones(c, dtype=torch.float32, device="cuda")
    out = torch.empty((geo["B"], geo["Ho"], geo["Wo"], c), dtype=out_dtype, device="cuda")
    g_dil = (torch.empty((geo["B"], geo["H"], geo["W"], geo["C"]), dtype=torch.int8,
                         device="cuda") if dilated else None)
    partial = (torch.empty((plan[4], m * c), dtype=torch.int32, device="cuda")
               if plan[4] > 1 else None)
    geom = (ctypes.c_int * 17)(*(run[key] for key in kc.GEOM_KEYS), w4[0].numel(), w.shape[1])
    c_plan = (ctypes.c_int * 6)(*plan)

    def call():
        rc = lib.iswm_int8_conv_dgrad(
            g_q.data_ptr(), None if g_dil is None else g_dil.data_ptr(), w.data_ptr(),
            ones.data_ptr(), g_amax.data_ptr(), w_amax.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), geom, g_q.shape[1], g_q.shape[2], sh, sw, c_plan,
            None if partial is None else partial.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
        return out
    return call


def time_dgrad(args, libs: dict, cold) -> None:
    """conv_s8_dgrad of every build at one int8-backward QAT step's 49 calls
    (each distinct shape once, weighted by its calls): the base through its
    own entry (:func:`zero_insert_dgrad`), the checkout and its edits through
    ``kc.conv_s8_dgrad`` with their library, every kernel a call launches
    (the base's zero insertion too); beside it each build's weight
    preparation at the same sites (the base: ATen's
    ``quantize_weight_rotated`` and the weight rows, the checkout's:
    ``kc.rotated_weight_codes``).  Every dx equal to the plain version's."""
    from iswm_tpu_torch.ops.int8_train import quantize_weight_rotated

    shapes = step_shapes({"dgrad", "rotated"})
    order = list(libs) + list(libs)[::-1]
    head_lib, rows, differ = kc._lib, [], []
    totals = {name: {"ms": 0.0, "weights_ms": 0.0} for name in libs}

    def run(name, kind, a, k):
        if kind == "rotated":
            if name == "base":
                return lambda: kc._weight_rows(quantize_weight_rotated(a[0])[0])
            return lambda: kc.rotated_weight_codes(*a)
        if name == "base":
            return zero_insert_dgrad(libs["base"], a, k)

        def call():
            kc._lib = libs[name]
            return kc.conv_s8_dgrad(*a, **k)
        return call

    for key, (kind, a, k, count) in shapes.items():
        if kind == "dgrad":
            want = kc.conv_s8_dgrad_plain(*a, **k)
            for name in libs:
                got = run(name, kind, a, k)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    differ.append(f"{name} at {key}")
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(sum(cold.kernels(run(name, kind, a, k)).values()))
        row = {"kind": kind, "shape": [list(a[0].shape), *map(str, a[1:])], "count": count}
        if kind == "dgrad":
            lay = kc.dgrad_launch(a[0].shape, a[1].shape[0], cs._dgrad_kernel(a, k), *a[4:8],
                                  out_dtype=k["out_dtype"])
            row.update(parity=lay["parity"], bound_ms=cs._bwd_bound("dgrad", a, k)["bound_ms"],
                       plan=[lay["plan"][q] for q in ("tw", "bn", "slots", "splits")])
        for name, runs in times.items():
            row[name] = sum(runs) / len(runs)
            totals[name]["ms" if kind == "dgrad" else "weights_ms"] += count * row[name]
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    kc._lib = head_lib
    bound = sum(r["count"] * r["bound_ms"] for r in rows if r["kind"] == "dgrad")
    for name, total in totals.items():
        print(f"[ab] conv_s8_dgrad over one step's 49 sites, {name}: {total['ms']:.4f} ms "
              f"({bound / total['ms']:.1%} of the bound {bound:.4f} ms); its weight "
              f"preparation {total['weights_ms']:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "bound_ms": bound, "differs": differ}))
    if differ:
        raise SystemExit("builds differ from the plain version: " + "; ".join(differ))


def sweep_dgrad(args, lib, cold) -> None:
    """Every plan of the data gradient's launch (``kc.DENSE_PLANS`` x
    ``kc.TILE_WIDTHS`` x ``kc.SPLITS``) at one int8-backward QAT step's
    distinct shapes beside the planner's: cold times, each plan's dx equal
    to the plain version's; the best plan of each shape printed as the key
    and value of ``kc.DGRAD_PLANS``."""
    rows, bad = [], []
    for key, (_, a, k, count) in step_shapes({"dgrad"}).items():
        g_q, w_rows, g_amax, w_amax, x_hw, stride, pad, dil = a[:8]
        kernel = cs._dgrad_kernel(a, k)
        c = w_rows.shape[0]
        chosen = kc.dgrad_launch(g_q.shape, c, kernel, x_hw, stride, pad, dil, k["out_dtype"])
        if chosen["body"] != "wgmma":
            continue
        first = tuple(chosen["plan"][q] for q in ("tw", "bn", "slots", "splits"))
        want = kc.conv_s8_dgrad_plain(*a, **k)
        times = {}
        for plan in [first] + [(tw, bn, slots, sp) for bn, slots in kc.DENSE_PLANS
                               for tw in kc.TILE_WIDTHS for sp in kc.SPLITS]:
            if plan in times or (plan[1] == 8 and c > 8) or plan[1] > 2 * max(c, 64):
                continue
            try:
                lay = kc.dgrad_launch(g_q.shape, c, kernel, x_hw, stride, pad, dil,
                                      k["out_dtype"], plan=plan)
            except ValueError:  # past the grid or the shared memory
                continue
            out = torch.empty_like(want)
            splits = plan[3]
            partial = (torch.empty((splits, out.numel()), dtype=torch.int32, device="cuda")
                       if splits > 1 else None)
            g_in = kc.F.pad(g_q, (0, lay["np"] - g_q.shape[3])).contiguous()

            def call(lay=lay, out=out, partial=partial, g_in=g_in):
                rc = lib.iswm_int8_conv_dgrad(
                    g_in.data_ptr(), w_rows.data_ptr(), kc._ones_f32(c, g_q.device).data_ptr(),
                    g_amax.data_ptr(), w_amax.data_ptr(), out.data_ptr(),
                    int(k["out_dtype"] == torch.bfloat16), lay["c_geom"], lay["c_plan"],
                    lay["c_parity"], None if partial is None else partial.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
                return out

            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad.append(f"{plan} at {key}")
            times[plan] = cold(call)
        best = min(times, key=times.get)
        key = kc.dgrad_key(g_q.shape, c, kernel, x_hw, stride, pad, dil, k["out_dtype"])
        row = {"key": repr(key), "count": count, "parity": chosen["parity"],
               "chosen": first, "chosen_ms": times[first], "best": best, "best_ms": times[best],
               "plans": {" ".join(map(str, q)): t for q, t in times.items()}}
        rows.append(row)
        print(f"[sweep] {row['key']}: planned {first} {times[first]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms of {len(times)} plans", flush=True)
    picked = sum(r["count"] * r["chosen_ms"] for r in rows)
    best = sum(r["count"] * r["best_ms"] for r in rows)
    print(f"[sweep] one step's data gradients: the planner's plans {picked:.4f} ms, the best "
          f"plan at each shape {best:.4f} ms")
    for r in rows:  # the measured best plans, as kc.DGRAD_PLANS holds them
        print(f"[sweep] DGRAD_PLANS {r['key']}: {tuple(r['best'])},")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": "dgrad sweep", "shapes": rows, "bad": bad}))
    if bad:
        raise SystemExit("plans differ from the plain version: " + "; ".join(bad))


def time_quantize(args, libs: dict, cold) -> None:
    """The quantize of every build: at one int8-backward QAT step's 98
    activations and cotangents (each distinct shape once, weighted by its
    calls) the base's ATen amax (``vector_norm``, a cast) and its
    device-amax quantize, the checkout's (and its edits') one reducing
    launch, and the ATen amax with the checkout's one-pass quantize; at a
    serving chunk's 33 dense-site inputs the host-scale quantize of every
    build.  Every build's codes equal to the plain version's."""
    from iswm_tpu_torch.ops.int8_train import _rows_view, activation_amax

    order = list(libs) + list(libs)[::-1]
    head_lib, rows, differ = kc._lib, [], []

    def entry(lib, rows_, amax=None, scale=None):
        out = torch.empty(rows_.shape, dtype=torch.int8, device="cuda")
        p, c, ld = kc._rows(rows_)
        bf16 = int(rows_.dtype == torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.iswm_int8_quantize(rows_.data_ptr(), bf16, scale, out.data_ptr(), p, c, ld,
                                     stream) if amax is None else
              lib.iswm_int8_quantize_amax(rows_.data_ptr(), bf16, amax.data_ptr(),
                                          out.data_ptr(), p, c, ld, stream))
        if rc:
            raise RuntimeError(lib.iswm_cuda_error_string(rc).decode())
        return out

    def two_pass(name, rows_, x):
        def call():
            return entry(libs[name], rows_, activation_amax(x))
        return call

    def fused(name, rows_):
        def call():
            kc._lib = libs[name]
            return kc.quantize_s8_reduce(rows_, "dynamic")[0]
        return call

    totals = {}
    for key, (kind, a, k, count) in step_shapes({"quantize_x", "quantize_g"}).items():
        x = a[0]
        rows_ = _rows_view(x.detach())
        want = kc.quantize_s8_plain(rows_, activation_amax(x))
        calls = {"base": two_pass("base", rows_, x)}
        for name in libs:
            if name != "base":
                calls[name] = fused(name, rows_)
                calls[f"{name} two-pass"] = two_pass(name, rows_, x)
        for name, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                differ.append(f"{name} at {key}")
        times = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            times[name].append(sum(cold.kernels(calls[name]).values()))
        row = {"kind": kind, "shape": list(x.shape), "slice": rows_.stride(2) != x.shape[1],
               "count": count, "bound_ms": cs._quantize_bound(rows_)["bound_ms"]}
        for name, runs in times.items():
            row[name] = sum(runs) / len(runs)
            totals.setdefault(kind, {}).setdefault(name, 0.0)
            totals[kind][name] += count * row[name]
        totals.setdefault(kind, {}).setdefault("bound_ms", 0.0)
        totals[kind]["bound_ms"] += count * row["bound_ms"]
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, count in cs.XLA_IGEMM_SHAPES.items():  # serving: a host scale
        b, h, w, c = shape[:4]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
        want = kc.quantize_s8_plain(x, 0.05)
        calls = {name: functools.partial(entry, lib, x, None, 0.05) for name, lib in libs.items()}
        for name, fn in calls.items():
            if not torch.equal(fn(), want):
                differ.append(f"{name} serving at {shape}")
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cold(calls[name]))
        row = {"kind": "serving", "shape": list(shape[:4]), "count": count,
               "bound_ms": cs._quantize_bound(x)["bound_ms"] - 4 / cs.HBM_BYTES_PER_S * 1e3}
        for name, runs in times.items():
            row[name] = sum(runs) / len(runs)
            totals.setdefault("serving", {}).setdefault(name, 0.0)
            totals["serving"][name] += count * row[name]
        totals["serving"].setdefault("bound_ms", 0.0)
        totals["serving"]["bound_ms"] += count * row["bound_ms"]
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    kc._lib = head_lib
    for kind, total in totals.items():
        bound = total.pop("bound_ms")
        print(f"[ab] the quantize at {kind} (bound {bound:.4f} ms): " + ", ".join(
            f"{name} {ms:.4f} ms ({bound / ms:.1%})" for name, ms in total.items()))
        total["bound_ms"] = bound
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"kind": args.kind, "shapes": rows, "totals": totals,
                                    "differs": differ}))
    if differ:
        raise SystemExit("builds differ from the plain version: " + "; ".join(differ))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path,
                        help="a fused_block.cu (int8_matmul.cu, fused_stem.cu) to compare; "
                             "not with --sweep")
    parser.add_argument("--kind", choices=("mm", "c3", "mm_fwd", "c3_fwd", "int8", "stem", "ce",
                                           "igemm", "direct", "wgrad", "dgrad", "quantize"),
                        default="mm",
                        help="the 1x1 backward (#7b), the 3x3 (#8b), their forwards (#7a, "
                             "#8a), the int8 1x1 (#1, #2), the stem's backward (#11a, #11b), "
                             "the fused CE (#4), int8_exec_xla's dense or grouped int8 conv, "
                             "QAT's int8 weight or data gradient, or the quantize")
    parser.add_argument("--edit", nargs="+", action="append", default=[],
                        metavar=("NAME", "EDIT"), help="a name, then one or more OLD=>NEW")
    parser.add_argument("--sweep", action="store_true",
                        help="with --kind int8, mm_fwd, c3_fwd, stem, ce, igemm, wgrad or dgrad: "
                             "time "
                             "every plan of the checkout's build instead")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", type=Path, default=Path("build/block_bwd_ab.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase_device()
    module, stem = {"int8": (k8, "int8_matmul"), "stem": (fs, "fused_stem"),
                    "ce": (ce, "fused_ce"), "igemm": (kc, "int8_conv"),
                    "direct": (kc, "int8_conv"), "wgrad": (kc, "int8_conv"),
                    "dgrad": (kc, "int8_conv"), "quantize": (kc, "int8_conv")}.get(
        args.kind, (fb, "fused_block"))
    bind = bind_conv if module is kc else module.bind
    base_bind = bind
    if module is kc and args.base is not None and "out_bf16" not in args.base.read_text():
        base_bind = functools.partial(bind_conv, pr15=True)
    elif module is kc and args.base is not None and (
            "iswm_int8_quantize_reduce" not in args.base.read_text()):
        base_bind = bind_zero_insert
    if args.kind == "wgrad":
        base_bind = bind_pr18_wgrad
    head = (Path(module.__file__).resolve().parents[2] / "csrc" / f"{stem}.cu").read_text()
    if args.sweep != (args.base is None) or (args.sweep and args.kind in ("mm", "c3", "direct",
                                                                          "quantize")):
        parser.error("give --base, or --sweep with --kind int8, mm_fwd, c3_fwd, stem, ce, igemm, "
                     "wgrad or dgrad")
    jobs = {} if args.sweep else {"base": (args.base.read_text(), f"ab_{stem}_base", base_bind)}
    jobs.update((name, (edited(head, edits), f"ab_{stem}_{name}", bind))
                for name, *edits in args.edit)
    with ThreadPoolExecutor(len(jobs) + 1) as pool:  # one nvcc a build, all at once
        head_lib = pool.submit(module.load_library)
        futures = {name: pool.submit(build_source, *job) for name, job in jobs.items()}
        libs = {"base": futures.pop("base").result()} if "base" in futures else {}
        libs["head"] = head_lib.result()[0]
        if module is kc:
            libs["head"].pr15 = False
        libs.update((name, future.result()) for name, future in futures.items())
    cold = cs.ColdTimer(reps=args.reps)
    forward = args.kind.endswith("_fwd")
    if args.sweep:
        sweep = {"stem": sweep_stem, "ce": sweep_ce, "igemm": sweep_igemm,
                 "wgrad": sweep_wgrad, "dgrad": sweep_dgrad}.get(
            args.kind, sweep_forward if forward else sweep_int8)
        sweep(args, libs["head"], cold)
    elif forward:
        time_forward(args, libs, cold)
    else:
        {"int8": time_int8, "stem": time_stem, "ce": time_ce, "igemm": time_conv,
         "direct": time_conv, "wgrad": time_wgrad, "dgrad": time_dgrad,
         "quantize": time_quantize}.get(args.kind, time_blocks)(args, libs, cold)


if __name__ == "__main__":
    main()
