"""Time the bf16 1x1 backward of the fused blocks (#7b) of two builds of
``iswm_tpu_torch/csrc/fused_block.cu`` in turns on one CUDA card.

At every shape of ``chip_smoke.BLOCK_MM_SHAPES`` it times, with the inputs
out of L2 (``chip_smoke.ColdTimer``), the two C entries of one backward, each
with its finishing sum: the data gradient and the weight gradient.  The
builds are the checkout's source ("head"), a base source given by path, and
any number of edited copies of the head; each shape is timed base, head,
edits..., then in the reverse order, and the summed train-step totals weight
each shape by its launches a step.  Run from the root of the checkout:

    git show <commit>:iswm_tpu_torch/csrc/fused_block.cu > build/fused_block_base.cu
    python3 block_bwd_ab.py --base build/fused_block_base.cu \\
        [--edit NAME 'OLD=>NEW' ...] [--out build/block_bwd_ab.json]

An edit replaces the text OLD of the head's source, which must occur once, by
NEW: for example a stage of a kernel taken out, to see what it costs.  Such a
build computes wrong values and is only timed; ``chip_smoke.py`` phase 12
checks the head's values.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from iswm_tpu_torch.ops.kernels import build
from iswm_tpu_torch.ops.kernels import fused_block as fb


def build_source(text: str, name: str) -> ctypes.CDLL:
    """Compile ``text`` as build/kernels/<name>.cu with the port's flags."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = build.BUILD_DIR / f"{name}.cu", build.BUILD_DIR / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return fb.bind(ctypes.CDLL(str(lib)))


def edited(head: str, edit: str) -> str:
    old, new = edit.split("=>")
    if head.count(old) != 1:
        raise ValueError(f"the edit's text occurs {head.count(old)} times, not once: {old!r}")
    return head.replace(old, new)


def half_bounds(m: int, k: int, n: int, prologue: bool) -> tuple[float, float]:
    """Least times (ms) of the bf16 data gradient and weight gradient alone,
    each reading its own inputs once: together more than the whole call's
    bound, since both read dy and y."""
    e, vec, ops = 2, 2 * k * 4 * bool(prologue), 2 * m * k * n
    dgrad = (2 * m * n * e + k * n * e + 2 * n * 4 + m * k * e * (1 + bool(prologue))
             + 2 * vec)  # dy, y, w, ds, dq, x, a, b in; dx, da, db out
    wgrad = m * k * e + 2 * m * n * e + 2 * n * 4 + vec + k * n * 4  # ... dw out, in f32
    return tuple(cs.least_time(b, ops, cs.BF16_OPS_PER_S)["bound_ms"] for b in (dgrad, wgrad))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True, type=Path, help="a fused_block.cu to compare")
    parser.add_argument("--edit", nargs=2, action="append", default=[], metavar=("NAME", "EDIT"))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", type=Path, default=Path("build/block_bwd_ab.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase_device()
    head = (Path(fb.__file__).resolve().parents[2] / "csrc" / "fused_block.cu").read_text()
    jobs = {"base": (args.base.read_text(), "ab_base")}
    jobs.update((name, (edited(head, edit), f"ab_{name}")) for name, edit in args.edit)
    with ThreadPoolExecutor(len(jobs) + 1) as pool:  # one nvcc a build, all at once
        head_lib = pool.submit(fb.load_library)
        futures = {name: pool.submit(build_source, *job) for name, job in jobs.items()}
        libs = {"base": futures.pop("base").result(), "head": head_lib.result()[0]}
        libs.update((name, future.result()) for name, future in futures.items())

    gen = torch.Generator(device="cuda").manual_seed(0)
    cold = cs.ColdTimer(reps=args.reps)
    order = list(libs) + list(libs)[::-1]
    totals = {name: [0.0, 0.0] for name in libs}
    rows = []
    for (m, k, n, prologue), count in cs.BLOCK_MM_SHAPES.items():
        x, w, a, b, dy, ds, dq = cs._fb_inputs("mm", (m, k, n), torch.bfloat16, gen)
        y = fb.matmul_bn_stats_fwd(x, w, a, b, prologue)[0]
        halves = {name: cs._mm_bwd_halves(lib, x, w, a, b, y, dy, ds, dq, prologue)
                  for name, lib in libs.items()}
        times = {name: ([], []) for name in libs}
        for name in order:
            for half, fn in zip(times[name], halves[name]):
                half.append(cold(fn))
        row = {"shape": [m, k, n, prologue], "count": count,
               "bound_ms": cs._fb_bound("mm", (m, k, n), prologue, 2)[1]["bound_ms"],
               "half_bounds_ms": half_bounds(m, k, n, prologue)}
        for name, (dgrad, wgrad) in times.items():
            row[name] = {"dgrad_ms": dgrad, "wgrad_ms": wgrad}
            totals[name][0] += count * sum(dgrad) / len(dgrad)
            totals[name][1] += count * sum(wgrad) / len(wgrad)
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
        del x, w, dy, y, halves
    launches = sum(cs.BLOCK_MM_SHAPES.values())
    bounds = [sum(count * half_bounds(*shape)[i] for shape, count in cs.BLOCK_MM_SHAPES.items())
              for i in range(2)]
    print(f"[ab] one train step's {launches} launches, the halves' own bounds: data gradient "
          f"{bounds[0]:.4f} ms, weight gradient {bounds[1]:.4f} ms")
    for name, (dgrad, wgrad) in totals.items():
        print(f"[ab] one train step's {launches} launches, {name}: data gradient {dgrad:.4f} ms, "
              f"weight gradient {wgrad:.4f} ms, both {dgrad + wgrad:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"shapes": rows, "totals": totals}))


if __name__ == "__main__":
    main()
