"""Smoke run of the PyTorch port on one NVIDIA H100: build the hand-written
kernels, hold each against its plain version, drive the tiled serving path,
the training path (with quick-evals), the quantization comparison, and
training and serving with the fused stem.

    python3 chip_smoke.py

Phases (each prints its result; any failure raises and the exit code is
not 0):
  1. the card's name and power limit (nvidia-smi);
  2. the builds of ``iswm_tpu_torch/csrc/*.cu`` with nvcc, all started
     together, timed;
  3. ``int8_matmul`` against its plain version, bit for bit
     (``torch.equal``), at every routed shape of the serving slice
     (DeepLabV3+/ResNet-50, OS 16, tile 512, batch 8, bf16) plus a ragged
     M, a saturating x, exact .5 ties and a float32 x; CUDA-event times of
     the kernel, the plain version and a bf16 1x1 ``F.conv2d`` at each
     shape;
  4. the serving slice: ``Predictor`` with ``serving_variant="int8_exec"``
     and seeded weights on two seeded uint8 scenes (1024x1536, 1100x1300)
     through ``predict_image``; the launch count must be 30 per chunk, the
     logits finite and equal to those of the same Predictor with its int8
     sites on the plain version (deterministic cuDNN); then tiles/s and
     scene latency of ``bf16`` and ``int8_exec``;
  5. the fused binary CE kernels (forward sums, backward d_logits) against
     their plain versions: the training slice's logits [8, 2, 512, 512] in
     bf16 (NCHW and channels last) and f32, a ragged [3, 2, 97, 131] and an
     all-ignored batch; forward sums within 1e-5 relative of the plain
     version in float64 and bit-stable across launches, d_logits within
     1e-6 * max|d_logits| in f32 and 1 bf16 ulp in bf16; device times
     (profiler) and CUDA-event times of kernel and plain version at the
     slice's shape;
  6. the training slice at full width: ``Trainer`` on ResNet-50, OS 16,
     bf16, crop 512, batch 8, ``ce_loss`` with ``fused_kernel="auto"``, from
     32 seeded synthetic 640x640 scenes (8 for validation), for
     ``TRAIN_STEPS`` steps, one validation and a best checkpoint; the fused
     CE launch counts must equal the step count in each direction, every
     logged loss be finite, and the checkpoint load ``strict=True`` into a
     fresh model; one step through the kernel and one through
     ``fused="never"`` from the same state, with deterministic algorithms,
     agree: loss within 1e-5 relative, each parameter's gradient (a fresh
     SGD's update is a fixed function of it) within 1e-2 * max|grad| in
     f32; in bf16 the median tensor within 5e-2 and the worst within 2.5e-1
     (bf16 rounding of the backward: the same bf16 step run twice with the
     default, atomics-based algorithms differs by 3.7e-2 * max|update|, and
     the worst of 188 tensors is heavy-tailed); then the median train step
     and train tiles/s;
  7. the evaluation kernels: ``binary_confusion_matrix`` equal (tolerance 0)
     to its plain version and to ``confusion_matrix(n_classes=2)`` at the
     quick-eval shape [8, 512, 512], a ragged [3, 77, 91], one pixel, more
     than 2^24 pixels, all pixels ignored, and uint8 / int32 / int64 inputs;
     ``int8_matmul_prequant`` equal (tolerance 0) to its plain version and
     to ``int8_matmul`` on the same x at the 13 routed shapes and a ragged
     M; device times (profiler) of the confusion kernel, its plain version
     and ``torch.bincount``; CUDA-event times of the two int8 kernels side
     by side;
  8. training with quick-eval (the same ``fit`` as phase 6, which runs with
     ``quick_eval_interval`` set): the ``quick_*`` series of
     ``metrics.jsonl`` stand at the steps asked for, the confusion kernel
     was launched once per validation batch of each quick-eval, and
     ``Trainer.quick_eval`` equals the metrics of the plain confusion matrix
     over the same predictions (1e-6, deterministic cuDNN);
  9. ``compare_variants`` at full width: ResNet-50, OS 16, bf16, seeded
     weights, eight seeded synthetic 512x512 scenes with masks from memory,
     variants f32 / bf16 / int8 / int8_act / int8_exec in 7-frame windows;
     every variant has a finite latency and the five metrics, f32 is the
     reference, bf16 and int8 agree with it in the top two verdict tiers,
     int8_act has one scale per activation site and differs from int8,
     int8_exec launches 30 kernels per image; the report table is printed;
 10. the four fused stem kernels (``stem_stats``, ``stem_norm_relu_pool``, the
     two of ``stem_tail_bwd``) against their plain versions: the slice's
     z [8, 64, 256, 256] in bf16 and f32, NHWC memory and NCHW, conv sides 32,
     20 and 44 (whole and ragged 4 x 16 tiles), batch 1, an all-tie z (dbeta
     equals sum dp) and an all-negative pre-activation (every gradient 0).
     The pooled output equals the plain version bit for bit; the statistics,
     s1 (dbeta), s2 (dgamma) and dW are within 1e-5 * max|tensor| of the plain
     version summed in float64 (the kernels sum in float32, in another order)
     and equal bit for bit across two launches; dW is held against the plain
     contraction of the same rounded dz (the kernel's own s1 / N and s2 / N go
     into both).  Device times with z out of the L2 cache: each kernel, its
     plain version, and the unfused chain on the same tensors
     (``F.batch_norm`` + ReLU + ``F.max_pool2d``; their autograd backward plus
     the conv's cuDNN weight gradient);
 11. the fused stem at full width: phase 6's ``Trainer`` with
     ``fused_stem="always"`` for ``STEM_STEPS`` steps, a quick-eval and a
     validation; ``stem_stats`` and the two backward kernels are launched
     once per step, ``stem_norm_relu_pool`` once per step and per eval
     forward; every loss finite; the best ``.pth`` loads ``strict=True`` into
     an unfused model; one step fused and one unfused from the same state with
     deterministic algorithms: ``bn1``'s running statistics within 1e-5 (of
     max|var|, and of max sqrt(var) for the mean), the loss within 1e-3
     relative in f32 and 2e-2 in bf16 (the unfused BatchNorm rounds before
     the ReLU and the pool, the fused one after, and takes another variance
     formula); the stem's three gradients against the unfused chain's
     autograd on the fused step's own image, parameters and pooled cotangent:
     in f32 conv1 within 5e-3 * max|grad| (the library's weight gradient
     reads TF32) and bn1 within 1e-5, in bf16 conv1 within 1e-1 (many pool
     windows tie, and equal-split and first-index routing are two
     subgradients) and bn1 within 2e-2: limits of three to seven times
     the largest reading of seven runs, whose readings spread by a factor of
     two to fifteen.  The
     whole step's gradients are not held to phase 6's bands: a step of this
     model is chaotic in its forward, so the median tensor's difference is
     printed beside that of an unfused step whose pooled values were moved by
     an ulp or two at one value in a million; the median train step of both,
     and the stem kernels' share of a step's device time from a profiler
     trace; then a
     bf16 ``Predictor`` with the fused stem on the 1024x1536 scene:
     ``stem_norm_relu_pool`` once per chunk, finite logits, mask agreement
     with the unfused Predictor >= 0.999, scene latency of both.
Each kernel's record carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over the card's peak rate for their type
(1,979 TOP/s int8 and 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them), NVIDIA's data-sheet rates for an H100 SXM.  The stem's
weight gradient contracts bf16 operands, so its bound takes the bf16
tensor-core rate although the kernel uses float32 FMAs; its record says so
and gives the time of its operations at the FMA rate beside the bound.  The
line before the last is the kernel record; the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
SCENES = ((1024, 1536), (1100, 1300))
TRAIN_STEPS = 12
QUICK_EVAL_INTERVAL = 4  # quick-evals at steps 4 and 8, the validation at 12
VAL_SCENES = 8
EVAL_SCENES = 8
EVAL_VARIANTS = ("f32", "bf16", "int8", "int8_act", "int8_exec")
STEM_STEPS = 4  # with a quick-eval at step 2 and the validation at 4
STEM_SLICE = (8, 256)  # batch and conv-output side of the stem at crop 512
# NVIDIA's data sheet for the H100 SXM, dense rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12  # tensor cores
TF32_OPS_PER_S = 495e12  # tensor cores, from float32 operands
F32_OPS_PER_S = 67e12  # outside the tensor cores
TRAIN_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
# (M, K, N) of every int8 site of one chunk (8 tiles of 512^2, OS 16), and
# how many of the 30 routed sites run at it
SLICE_SHAPES = {
    (131072, 256, 128): 1,   # layer2.0.conv1
    (32768, 128, 512): 4,    # layer2.*.conv3
    (32768, 512, 128): 3,    # layer2.{1,2,3}.conv1
    (32768, 512, 256): 1,    # layer3.0.conv1
    (8192, 256, 1024): 6,    # layer3.*.conv3
    (8192, 1024, 256): 5,    # layer3.{1..5}.conv1
    (8192, 1024, 512): 1,    # layer4.0.conv1
    (8192, 512, 2048): 3,    # layer4.*.conv3
    (8192, 1024, 2048): 1,   # layer4.0.downsample.0
    (8192, 2048, 512): 2,    # layer4.{1,2}.conv1
    (8192, 2048, 256): 1,    # aspp.convs.0
    (8, 2048, 256): 1,       # aspp.convs.4 (pool)
    (8192, 1280, 256): 1,    # aspp.project
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class NoDeviceRecords(RuntimeError):
    pass


def traced_kernels(fn, reps: int, warmup: int) -> dict:
    """{kernel name: its device time in one fn(), ms} from a ``torch.profiler``
    trace of ``reps`` calls.  A trace can come back short of its last records,
    or now and then with none: so each kernel counts with the mean of the
    records it has, times its launches in a call (records / reps, to the
    nearest whole number), and an empty trace is taken again, five times at
    most."""
    for _ in range(warmup):
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == cuda and e.count and e.self_device_time_total > 0]
        if on_device:
            return {e.key: e.self_device_time_total / e.count
                    * (round(e.count / reps) or e.count / reps) / 1e3 for e in on_device}
    raise NoDeviceRecords(f"five traces of {reps} calls hold no device record")


def traced_ms(fn, reps: int, warmup: int) -> float:
    """Device time of one fn(): the sum of :func:`traced_kernels`."""
    return sum(traced_kernels(fn, reps, warmup).values())


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of fn() on the card: the kernels' own durations in a
    profiler trace, without the host's launch overhead (which bounds the
    CUDA-event time of a kernel this short).  Where the profiler records
    nothing, the CUDA-event time stands in and a line on stderr says so."""
    try:
        return traced_ms(fn, reps, warmup)
    except NoDeviceRecords as e:
        print(f"[profiler] {e}: CUDA-event time, launch overhead included, stands in",
              file=sys.stderr)
        return cuda_ms(fn, reps, warmup=0)


def least_time(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at their
    peak rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def matmul_bound(m: int, k: int, n: int, x_bytes: int) -> dict:
    """x [M, K] + w [K, N] int8 + w_scale [N] f32 in, out [M, N] f32;
    2 M K N int8 operations."""
    return least_time(m * k * x_bytes + k * n + 4 * n + 4 * m * n, 2 * m * k * n,
                 INT8_OPS_PER_S)


def sum_bounds(parts) -> dict:
    """Bounds of calls made one after another: the times add; the sum is
    bound by whatever bounds most of it."""
    total = sum(p["bound_ms"] for p in parts)
    by_bytes = sum(p["bound_ms"] for p in parts if p["bound_by"] == "bytes")
    return {"bound_ms": total,
            "bound_by": "bytes" if by_bytes >= total - by_bytes else "operations"}


def cold_device_ms(fn, reps: int = 20) -> float:
    """:func:`device_ms` of fn() with its inputs out of the 50 MB L2 cache:
    a 256 MB buffer is rewritten before every call, and the time of that
    rewrite alone is taken off."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        return fn()

    # both times by the same clock, or their difference means nothing
    try:
        return traced_ms(flushed, reps, 3) - traced_ms(flush.zero_, reps, 3)
    except NoDeviceRecords as e:
        print(f"[profiler] {e}: CUDA-event times, launch overhead included, stand in",
              file=sys.stderr)
        return cuda_ms(flushed, reps) - cuda_ms(flush.zero_, reps)


def phase_device() -> None:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(line)
    print(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {line}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def phase_build(modules) -> None:
    """Build every kernel library at once, one nvcc per source."""
    def build(module):
        t0 = time.perf_counter()
        _, log = module.load_library()
        return time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        results = list(pool.map(build, modules.values()))
    for name, (secs, log) in zip(modules, results):
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[2] build {name}.cu: {secs:.2f} s; ptxas: {' | '.join(ptxas)}")
    print(f"[2] all builds: {time.perf_counter() - t0:.2f} s")


def _case(m, k, n, kind, gen):
    dev = "cuda"
    if kind == "ties":  # x / x_scale = integer + 0.5 exactly, representable in bf16
        ints = torch.randint(-64, 64, (m, k), generator=gen, device=dev)
        x, x_scale = ((ints.float() + 0.5) * 0.25).to(torch.bfloat16), 0.25
    else:
        x = torch.randn((m, k), generator=gen, device=dev)
        x = x.to(torch.float32 if kind == "f32" else torch.bfloat16)
        x_scale = float(x.float().abs().max()) / 127.0
        if kind == "saturate":
            x_scale /= 4.0  # |x / x_scale| up to ~4 x 127: clipped codes
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev).to(torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4
    return x, w_q, w_scale, x_scale


def phase_kernel(k8) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(s, "bf16") for s in SLICE_SHAPES] + [
        ((1000, 256, 128), "ragged"), ((8192, 1024, 256), "saturate"),
        ((8192, 512, 256), "ties"), ((4000, 512, 256), "f32"),
    ]
    max_err, ms, plain_ms, conv_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    for (m, k, n), kind in cases:
        x, w_q, w_scale, x_scale = _case(m, k, n, kind, gen)
        got = k8.int8_matmul(x, w_q, w_scale, x_scale)
        want = k8.int8_matmul_plain(x, w_q, w_scale, x_scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"kernel != plain at {(m, k, n)} {kind}: max abs err {err}")
        max_err = max(max_err, err)
        t_k = cuda_ms(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale))
        t_p = cuda_ms(lambda: k8.int8_matmul_plain(x, w_q, w_scale, x_scale), reps=5)
        # the same 1x1 conv in bf16 through cuDNN, channels last [1, K, M, 1]
        xc = x.to(torch.bfloat16).reshape(1, m, 1, k).permute(0, 3, 1, 2)
        wc = w_q.t().to(torch.bfloat16).reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last)
        t_c = cuda_ms(lambda: torch.nn.functional.conv2d(xc, wc))
        count = SLICE_SHAPES.get((m, k, n), 0) if kind == "bf16" else 0
        ms, plain_ms, conv_ms = ms + count * t_k, plain_ms + count * t_p, conv_ms + count * t_c
        least = matmul_bound(m, k, n, x.element_size())
        bounds += [least] * count
        print(f"[3] int8_matmul M={m} K={k} N={n} x={kind}: bit-exact (tolerance 0, torch.equal); "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bf16 conv2d {t_c:.4f} ms; "
              f"kernel {2 * m * k * n / t_k / 1e9:.1f} TOP/s; bound {least['bound_ms']:.4f} ms "
              f"by {least['bound_by']}")
    least = sum_bounds(bounds)
    print(f"[3] one chunk's 30 int8 sites: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bf16 conv2d (cuDNN, another function: no quantization) {conv_ms:.4f} ms, "
          f"bound {least['bound_ms']:.4f} ms by {least['bound_by']}")
    # no single PyTorch call quantizes, multiplies in int8 and rescales
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **least,
            "library_ms": None}


def phase_slice(k8) -> int:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import Int8Conv1x1, logit_diff_verdict
    from iswm_tpu_torch.ops.kernels.int8_matmul import quantized_conv1x1_plain

    rng = np.random.default_rng(SEED)
    scenes = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SCENES]

    def config(variant):
        cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16, tile 512/64/8
        cfg.predict.serving_variant = variant
        return cfg

    cfg = config("int8_exec")
    p = cfg.predict
    tiles = [len(tile_origins(h, p.tile_size, p.tile_size - p.tile_overlap))
             * len(tile_origins(w, p.tile_size, p.tile_size - p.tile_overlap))
             for h, w in SCENES]
    chunks = sum(-(-n // p.tile_batch) for n in tiles)

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    pred = Predictor(cfg, device="cuda")
    k8.launches = 0
    products = [pred.predict_image(s) for s in scenes]
    torch.cuda.synchronize()
    launches = k8.launches
    sites = sum(SLICE_SHAPES.values())
    check(len(pred.engine.model_fn.routed_sites) == sites,
          f"{len(pred.engine.model_fn.routed_sites)} routed sites, expected {sites}")
    check(launches == sites * chunks,
          f"int8_matmul launched {launches} times, expected {sites} x {chunks} chunks")
    print(f"[4] int8_exec main path: {len(scenes)} scenes, {tiles} tiles, {chunks} chunks, "
          f"{len(pred.engine.model_fn.routed_sites)} routed sites, "
          f"int8_matmul launches {launches}")

    int8_sites = [m for m in pred.engine.model_fn.model.modules()
                  if isinstance(m, Int8Conv1x1)]
    seen = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.add((args[0].shape[0] * args[0].shape[2] * args[0].shape[3],
                                    mod.w_q.shape[1], mod.w_q.shape[0])))
        for m in int8_sites]
    xs = [val_transform_batch(torch.from_numpy(s).cuda()) for s in scenes]
    logits = [pred.engine.infer_scene(x) for x in xs]
    for h in hooks:
        h.remove()
    check(seen == set(SLICE_SHAPES), f"routed shapes {sorted(seen)} != phase 3's")
    for (h, w), lg, prod in zip(SCENES, logits, products):
        check(tuple(lg.shape) == (h, w, 2) and bool(torch.isfinite(lg).all()),
              f"logits of the {h}x{w} scene: shape {tuple(lg.shape)} or not finite")
        check(np.array_equal(torch.softmax(lg, -1)[..., 1].cpu().numpy(), prod["prob_fg"]),
              "the rerun's logits differ from the counted run's")
        for key, shape, dtype in (("mask", (h, w), np.uint8), ("prob_fg", (h, w), np.float32),
                                  ("confidence", (h, w), np.uint8), ("rgb", (h, w, 3), np.uint8)):
            check(prod[key].shape == shape and prod[key].dtype == dtype,
                  f"product {key}: {prod[key].shape} {prod[key].dtype}")
    for m in int8_sites:
        m.conv_fn = quantized_conv1x1_plain
    plain = [pred.engine.infer_scene(x) for x in xs]
    for m in int8_sites:
        del m.conv_fn
    diff = max(float((a - b).abs().max()) for a, b in zip(logits, plain))
    check(all(torch.equal(a, b) for a, b in zip(logits, plain)),
          f"scene logits differ from the plain int8 path: max abs diff {diff}")
    print(f"[4] scene logits finite, products typed; equal to the plain int8 path "
          f"(max abs diff {diff})")
    torch.backends.cudnn.deterministic = False

    bf16 = Predictor(config("bf16"), device="cuda")
    bf16.predict_image(scenes[0])
    agree, verdict = logit_diff_verdict(
        bf16.engine.infer_scene(xs[0]).cpu().numpy(), logits[0].cpu().numpy())
    print(f"[4] int8_exec vs bf16 mask agreement {agree:.6f} ({verdict})")
    for name, predictor in (("bf16", bf16), ("int8_exec", pred)):
        for (h, w), scene, n in zip(SCENES, scenes, tiles):
            predictor.predict_image(scene)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predictor.predict_image(scene)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            lat = float(np.median(times))
            print(f"[4] {name} {h}x{w} ({n} tiles): scene latency {lat * 1e3:.2f} ms "
                  f"(median of 5), {n / lat:.2f} tiles/s")
    return launches


def _ce_case(shape, dtype, gen, channels_last=False, all_ignored=False,
             label_dtype=torch.int32):
    """Logits [B, 2, H, W] ~ N(0, 3^2), labels ~10% foreground, ~5% 255."""
    b, h, w = shape
    logits = (torch.randn((b, 2, h, w), generator=gen, device="cuda") * 3).to(dtype)
    if channels_last:
        logits = logits.contiguous(memory_format=torch.channels_last)
    u = torch.rand((2, b, h, w), generator=gen, device="cuda")
    labels = (u[0] < 0.10).to(label_dtype)
    labels[(u[1] < 0.05) | all_ignored] = 255
    return logits, labels


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_fused_ce(ce) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cw = torch.tensor([1.0, 3.2], device="cuda")
    slice_shape = (8, 512, 512)
    cases = [
        ("slice bf16 NCHW", slice_shape, torch.bfloat16, {}),
        ("slice bf16 channels-last", slice_shape, torch.bfloat16, {"channels_last": True}),
        ("slice f32 NCHW", slice_shape, torch.float32, {}),
        ("ragged 3x97x131 bf16 uint8-labels", (3, 97, 131), torch.bfloat16,
         {"label_dtype": torch.uint8}),
        ("ragged 3x97x131 f32 channels-last int64-labels", (3, 97, 131), torch.float32,
         {"channels_last": True, "label_dtype": torch.int64}),
        ("all ignored bf16", slice_shape, torch.bfloat16, {"all_ignored": True}),
    ]
    fwd_err, bwd_err = 0.0, 0.0
    grad = torch.tensor(1.0, device="cuda")
    for name, shape, dtype, kw in cases:
        logits, labels = _ce_case(shape, dtype, gen, **kw)
        sums = ce.fused_binary_ce_fwd(logits, labels, cw)
        again = ce.fused_binary_ce_fwd(logits, labels, cw)
        want = ce.fused_binary_ce_fwd_plain(logits, labels, cw, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(sums, again), f"fused CE forward not bit-stable ({name}): "
              f"{sums.tolist()} vs {again.tolist()}")
        err = float((sums.double() - want).abs().max())
        rel = float(((sums.double() - want).abs() / want.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5 or err == 0.0,
              f"fused CE forward ({name}): {sums.tolist()} vs float64 {want.tolist()}")
        fwd_err = max(fwd_err, err)
        w_sum = torch.clamp_min(sums[1], 1e-12)
        d = ce.fused_binary_ce_bwd(logits, labels, cw, w_sum, grad)
        d_plain = ce.fused_binary_ce_bwd_plain(logits, labels, cw, w_sum, grad)
        torch.cuda.synchronize()
        check(d.dtype == logits.dtype and d.stride() == logits.stride(),
              f"d_logits {d.dtype} {d.stride()} vs logits {logits.dtype} {logits.stride()}")
        diff = (d.float() - d_plain.float()).abs()
        if dtype == torch.bfloat16:
            ok, tol = bool((diff <= _bf16_ulp(d_plain)).all()), "1 bf16 ulp"
        else:
            bound = 1e-6 * float(d_plain.abs().max())
            ok, tol = float(diff.max()) <= bound, "1e-6 * max|d_logits|"
        if kw.get("all_ignored"):
            ok = ok and float(sums[0]) == float(sums[1]) == 0.0 and not d.float().any()
        check(ok, f"fused CE backward ({name}): max abs diff {float(diff.max())} ({tol})")
        bwd_err = max(bwd_err, float(diff.max()))
        print(f"[5] fused_binary_ce {name}: sums {[round(v, 3) for v in sums.tolist()]}, "
              f"forward max abs err {err:.3e} vs float64 (rel 1e-5), bit-stable; "
              f"backward max abs err {float(diff.max()):.3e} ({tol})")

    # times at the training slice's shape and layout (channels-last bf16)
    logits, labels = _ce_case(slice_shape, torch.bfloat16, gen, channels_last=True)
    sums = ce.fused_binary_ce_fwd(logits, labels, cw)
    w_sum = torch.clamp_min(sums[1], 1e-12)
    calls = {
        "fwd": lambda: ce.fused_binary_ce_fwd(logits, labels, cw),
        "fwd_plain": lambda: ce.fused_binary_ce_fwd_plain(logits, labels, cw),
        "bwd": lambda: ce.fused_binary_ce_bwd(logits, labels, cw, w_sum, grad),
        "bwd_plain": lambda: ce.fused_binary_ce_bwd_plain(logits, labels, cw, w_sum, grad),
    }
    # the one PyTorch call for the same function: the weighted sum of CE
    # (and the sum of the weights) forward, its autograd backward
    target = labels.long()
    cw_lib = cw.to(logits.dtype)
    leaf = logits.detach().requires_grad_()
    lib_loss = torch.nn.functional.cross_entropy(leaf, target, weight=cw_lib, ignore_index=255)

    def library_fwd():
        ce_sum = torch.nn.functional.cross_entropy(
            logits, target, weight=cw_lib, ignore_index=255, reduction="sum")
        return ce_sum, cw[1] * (target == 1).sum() + cw[0] * (target == 0).sum()

    calls["fwd_library"] = library_fwd
    calls["bwd_library"] = lambda: torch.autograd.grad(lib_loss, leaf, retain_graph=True)
    lib_sums = torch.stack([v.double() for v in library_fwd()])
    rel = float(((lib_sums - sums.double()).abs() / sums.double().abs()).max())
    check(bool(torch.isfinite(lib_sums).all()), f"F.cross_entropy's sums {lib_sums.tolist()}")
    print(f"[5] F.cross_entropy(weight, ignore_index, 'sum') + weight sum, the library's call "
          f"for the forward: within {rel:.2e} relative of the kernel's sums (bf16 math)")
    dev = {k: device_ms(f) for k, f in calls.items()}
    host = {k: cuda_ms(f) for k, f in calls.items() if not k.endswith("library")}
    pixels = labels.numel()
    moved = {"fwd": logits.numel() * logits.element_size() + labels.numel() * labels.element_size()}
    moved["bwd"] = moved["fwd"] + logits.numel() * logits.element_size()
    # about a dozen float32 operations a pixel each way (max, exp, log1p,
    # sigmoid, selects, products): far under the bytes
    least = {d: least_time(moved[d], 12 * pixels, F32_OPS_PER_S) for d in moved}
    cold = {d: cold_device_ms(calls[d]) for d in ("fwd", "bwd")}
    print(f"[5] with the logits and labels out of the L2 cache (the step's logits were just "
          f"written, so the times below are the path's): kernel forward {cold['fwd']:.4f} ms, "
          f"backward {cold['bwd']:.4f} ms")
    for d in ("fwd", "bwd"):
        print(f"[5] fused_binary_ce {d} at [8, 2, 512, 512] bf16 channels-last: device time "
              f"kernel {dev[d]:.4f} ms ({moved[d] / dev[d] / 1e6:.0f} GB/s), plain "
              f"{dev[d + '_plain']:.4f} ms, F.cross_entropy {dev[d + '_library']:.4f} ms, "
              f"bound {least[d]['bound_ms']:.4f} ms by {least[d]['bound_by']} "
              f"({moved[d]} bytes); CUDA events per call with the host's launch "
              f"overhead: kernel {host[d]:.4f} ms, plain {host[d + '_plain']:.4f} ms")
    return {d: {"max_abs_err": err, "ms": dev[d], "plain_ms": dev[d + "_plain"], **least[d],
                "library_ms": dev[d + "_library"]}
            for d, err in (("fwd", fwd_err), ("bwd", bwd_err))}


def phase_train(ce, cm) -> tuple:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, augment_batch, batch_iterator, generate_scene
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import Trainer, TrainState, make_optimizer, make_train_step

    rng = np.random.default_rng(SEED)

    def scenes(n):
        images, masks = zip(*(generate_scene(rng, size=(640, 640)) for _ in range(n)))
        return ArrayDataset(np.stack(images), np.stack(masks))

    train_ds, val_ds = scenes(32), scenes(VAL_SCENES)
    cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16, ce_loss, fused auto, SGD cosine
    cfg.data.crop_size, cfg.data.batch_size = 512, 8
    cfg.train.total_itrs = cfg.train.val_interval = TRAIN_STEPS
    cfg.train.quick_eval_interval = QUICK_EVAL_INTERVAL
    cfg.train.print_interval = 4
    cfg.train.save_val_results = False  # the PNG dump needs PIL
    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(TRAIN_OUT / name))
    trainer = Trainer(cfg, device="cuda", train_ds=train_ds, val_ds=val_ds)

    ce.launches_fwd = ce.launches_bwd = cm.launches = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (ce.launches_fwd, ce.launches_bwd, cm.launches)
    check(launches[:2] == (TRAIN_STEPS, TRAIN_STEPS),
          f"fused CE launches (fwd, bwd) {launches[:2]}, expected {TRAIN_STEPS} each")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == TRAIN_STEPS // cfg.train.print_interval
          and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.state.step == TRAIN_STEPS, f"step {trainer.state.step}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    fresh = build_model(cfg.model)
    fresh.load_state_dict(payload["model_state"], strict=True)
    trained = trainer.state.model.state_dict()
    check(payload["cur_itrs"] == TRAIN_STEPS
          and all(torch.equal(v, trained[k].cpu()) for k, v in fresh.state_dict().items()),
          "the checkpoint does not hold the trained model")
    print(f"[6] training main path: {TRAIN_STEPS} steps + "
          f"{TRAIN_STEPS // QUICK_EVAL_INTERVAL - 1} quick-evals + 1 validation + best "
          f"checkpoint in {fit_s:.2f} s; fused CE launches fwd {launches[0]}, bwd {launches[1]}; "
          f"losses {[round(v, 4) for v in losses]}; weighted score "
          f"{trainer.best_weighted:.4f}; {Path(trainer.best_path).name} loads strict=True")

    # one step through the kernel and one through the autograd loss, from one
    # state, on one augmented batch, with one dropout mask and deterministic
    # algorithms (cuDNN and the atomics-based backward ops), in bf16 as
    # trained and in f32.  A fresh SGD's update is -lr (1 + m) (g + wd p), so
    # the gradients are compared: (new - old) in f32 is quantized at ulp(p),
    # 2% of a step-12 update of BatchNorm scales near 1.
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                         trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
    model = trainer.state.model
    start, trained_dtype = copy.deepcopy(model.state_dict()), model.compute_dtype
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
    # f32 holds every tensor to 1e-2.  In bf16 the two paths' d_logits differ
    # by one ulp at a few pixels, which draws another realisation of the
    # backward's rounding noise: the worst of 188 tensors is heavy-tailed
    # (2.8e-2 to 1.05e-1 over eight runs), so bf16 holds the median tensor to
    # 5e-2 and the worst to 2.5e-1.
    for dtype, grad_tol, worst_tol in ((torch.bfloat16, 5e-2, 2.5e-1),
                                       (torch.float32, 1e-2, 1e-2)):
        model.compute_dtype = dtype
        steps = {}
        for fused in ("auto", "never"):
            model.load_state_dict(start)
            state = TrainState(model, *factory(model.parameters()), 0)
            step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused=fused, device="cuda"))
            torch.cuda.manual_seed(SEED)
            with warnings.catch_warnings():  # ops without a deterministic version
                warnings.simplefilter("ignore")
                loss = float(step(state, x, y))
            steps[fused] = (loss, {k: p.grad.float().clone() for k, p in model.named_parameters()})
        (loss_k, g_k), (loss_p, g_p) = steps["auto"], steps["never"]
        rel = abs(loss_k - loss_p) / abs(loss_p)
        ratios = sorted(
            (float((g_k[k] - g_p[k]).abs().max() / g_p[k].abs().max().clamp_min(1e-30)), k)
            for k in g_p)
        (worst, name), median = ratios[-1], ratios[len(ratios) // 2][0]
        check(rel <= 1e-5, f"{dtype}: kernel step loss {loss_k} vs plain step {loss_p}")
        check(worst <= worst_tol and median <= grad_tol,
              f"{dtype}: gradients of {name} differ by {worst:.2e} * max|grad| (limit "
              f"{worst_tol}), the median tensor's by {median:.2e} (limit {grad_tol})")
        print(f"[6] one step through the kernel vs fused='never', {dtype}: loss {loss_k:.6f} "
              f"vs {loss_p:.6f} (rel {rel:.2e}, limit 1e-5); worst parameter gradient "
              f"{worst:.2e} * max|grad| at {name} (limit {worst_tol}), median {median:.2e} "
              f"(limit {grad_tol}) over {len(g_p)} tensors")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    model.compute_dtype = trained_dtype
    model.load_state_dict(start)

    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    times = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, xu8, yu8)
        torch.cuda.synchronize()
        if i >= 3:  # after warm-up
            times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    print(f"[6] train step (augment + forward + fused CE + backward + SGD), batch 8 at "
          f"512^2: median {step_s * 1e3:.2f} ms of {len(times)} "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
          f"{cfg.data.batch_size / step_s:.2f} train tiles/s")
    return launches, trainer


def _cm_case(shape, gen, gt_dtype=torch.int64, pred_dtype=torch.int64, all_ignored=False):
    """Labels ~10% foreground and ~5% 255, predictions ~12% foreground."""
    u = torch.rand((3, *shape), generator=gen, device="cuda")
    gts = (u[0] < 0.10).to(gt_dtype)
    gts[(u[1] < 0.05) | all_ignored] = 255
    return gts, (u[2] < 0.12).to(pred_dtype)


def phase_eval_kernels(k8, cm) -> tuple:
    from iswm_tpu_torch.metrics.device import confusion_matrix

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    quick_shape = (8, 512, 512)
    cases = [
        ("quick-eval int64/int64", quick_shape, {}),
        ("quick-eval int32 labels / int32 preds", quick_shape,
         {"gt_dtype": torch.int32, "pred_dtype": torch.int32}),
        ("quick-eval uint8 labels / int64 preds", quick_shape, {"gt_dtype": torch.uint8}),
        ("ragged 3x77x91 int64 / uint8", (3, 77, 91), {"pred_dtype": torch.uint8}),
        ("one pixel", (1,), {}),
        ("all ignored", quick_shape, {"all_ignored": True}),
    ]
    inputs = [(name, *_cm_case(shape, gen, **kw)) for name, shape, kw in cases]
    # more than 2^24 pixels, nearly all true negatives: a count that float32
    # running sums could not hold, and exact here
    big = torch.zeros((17, 1024, 1024), dtype=torch.int64, device="cuda")
    big_pred = torch.zeros_like(big)
    big.view(-1)[:3] = 255
    big.view(-1)[5:10] = 1
    big_pred.view(-1)[7:13] = 1
    inputs.append((f"{big.numel()} pixels (> 2^24)", big, big_pred))
    cm_err = 0.0
    for name, gts, preds in inputs:
        got = cm.binary_confusion_matrix(gts, preds)
        plain = cm.binary_confusion_matrix_plain(gts, preds)
        onehot = confusion_matrix(gts, preds, n_classes=2)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain) and torch.equal(got, onehot),
              f"binary_confusion_matrix ({name}): {got.tolist()} vs plain {plain.tolist()} "
              f"vs confusion_matrix {onehot.tolist()}")
        if name == "all ignored":
            check(not got.any(), f"all pixels ignored, but counted {got.tolist()}")
        cm_err = max(cm_err, err)
        print(f"[7] binary_confusion_matrix {name}: {[int(v) for v in got.flatten().tolist()]} "
              f"(tn, fp, fn, tp), equal to plain and to confusion_matrix (tolerance 0)")
    # 3 ignored, 5 ones (2 missed, 3 hit), 3 false alarms; the float32 nearest
    # to the exact count of true negatives
    exact = [big.numel() - 3 - 5 - 3, 3, 2, 3]
    check(got.flatten().tolist() == [float(np.float32(v)) for v in exact] and exact[0] > 2**24,
          f"counts above 2^24: {got.flatten().tolist()} vs exactly {exact}")
    del big, big_pred, inputs[-1:]

    _, gts, preds = inputs[0]

    def bincount():
        valid = (gts >= 0) & (gts < 2)
        return torch.bincount(2 * gts[valid] + preds[valid], minlength=4)

    check(torch.equal(bincount().float().reshape(2, 2), cm.binary_confusion_matrix(gts, preds)),
          "torch.bincount disagrees with the kernel")
    moved = gts.numel() * (gts.element_size() + preds.element_size()) + 16
    # four compares and four adds a pixel, against the float32 rate
    # the 33.6 MB of inputs fit the 50 MB L2 cache, and repeated launches would
    # be served from it: the record's times are taken with the cache flushed,
    # as the bound counts bytes from device memory
    warm = device_ms(lambda: cm.binary_confusion_matrix(gts, preds))
    cm_record = {
        "max_abs_err": cm_err,
        "ms": cold_device_ms(lambda: cm.binary_confusion_matrix(gts, preds)),
        "plain_ms": cold_device_ms(lambda: cm.binary_confusion_matrix_plain(gts, preds)),
        **least_time(moved, 8 * gts.numel(), F32_OPS_PER_S),
        "library_ms": cold_device_ms(bincount),
    }
    print(f"[7] binary_confusion_matrix at [8, 512, 512] int64/int64, inputs out of L2: device "
          f"time kernel {cm_record['ms']:.4f} ms ({moved / cm_record['ms'] / 1e6:.0f} GB/s), "
          f"plain {cm_record['plain_ms']:.4f} ms, torch.bincount {cm_record['library_ms']:.4f} "
          f"ms, bound {cm_record['bound_ms']:.4f} ms by {cm_record['bound_by']} ({moved} "
          f"bytes); with the inputs in L2 the kernel takes {warm:.4f} ms")

    pq_err, ms, plain_ms, with_quant_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    for (m, k, n) in list(SLICE_SHAPES) + [(1000, 256, 128)]:
        x, w_q, w_scale, x_scale = _case(m, k, n, "bf16", gen)
        xs = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
        x_q = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
        got = k8.int8_matmul_prequant(x_q, w_q, w_scale, x_scale)
        plain = k8.int8_matmul_prequant_plain(x_q, w_q, w_scale, x_scale)
        fused = k8.int8_matmul(x, w_q, w_scale, x_scale)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"prequant kernel != plain at {(m, k, n)}: {err}")
        check(torch.equal(got, fused), f"prequant kernel != int8_matmul at {(m, k, n)}: "
              f"{float((got - fused).abs().max())}")
        pq_err = max(pq_err, err)
        t_k = cuda_ms(lambda: k8.int8_matmul_prequant(x_q, w_q, w_scale, x_scale))
        t_q = cuda_ms(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale))
        t_p = cuda_ms(lambda: k8.int8_matmul_prequant_plain(x_q, w_q, w_scale, x_scale), reps=5)
        count = SLICE_SHAPES.get((m, k, n), 0)
        ms, plain_ms, with_quant_ms = ms + count * t_k, plain_ms + count * t_p, with_quant_ms + count * t_q
        least = matmul_bound(m, k, n, 1)
        bounds += [least] * count
        print(f"[7] int8_matmul_prequant M={m} K={k} N={n}: bit-exact against plain and against "
              f"int8_matmul (tolerance 0); kernel {t_k:.4f} ms, int8_matmul (quantize inside) "
              f"{t_q:.4f} ms, plain {t_p:.4f} ms; {2 * m * k * n / t_k / 1e9:.1f} TOP/s; bound "
              f"{least['bound_ms']:.4f} ms by {least['bound_by']}")
    least = sum_bounds(bounds)
    print(f"[7] the 30 sites of a chunk, x already int8: kernel {ms:.4f} ms, int8_matmul "
          f"{with_quant_ms:.4f} ms (the quantize prologue costs {with_quant_ms - ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']}")
    # torch._int_mm gives the int32 product alone, not this function
    pq_record = {"max_abs_err": pq_err, "ms": ms, "plain_ms": plain_ms, **least,
                 "library_ms": None}
    return cm_record, pq_record


def phase_quick_eval(cm, trainer, launches: int) -> None:
    """Phase 6's fit ran with quick-evals: check what it logged and counted,
    then one more quick-eval against the plain confusion matrix."""
    from iswm_tpu_torch.data import batch_iterator
    from iswm_tpu_torch.metrics.device import foreground_metrics_from_cm

    cfg = trainer.cfg
    want_steps = [s for s in range(QUICK_EVAL_INTERVAL, TRAIN_STEPS + 1, QUICK_EVAL_INTERVAL)
                  if s % cfg.train.val_interval]
    names = ("miou", "fiou", "precision", "recall", "f1")
    quick = {}
    with open(Path(cfg.train.log_dir) / "metrics.jsonl") as f:
        for rec in map(json.loads, f):
            if "quick_miou" in rec:
                quick[rec["step"]] = [rec[f"quick_{k}"] for k in names]
    check(sorted(quick) == want_steps and len(want_steps) >= 2,
          f"quick-eval points at steps {sorted(quick)}, expected {want_steps}")
    check(all(np.isfinite(v).all() and min(v) >= 0.0 and max(v) <= 1.0 for v in quick.values()),
          f"quick-eval metrics {quick}")
    batches = -(-len(trainer.val_ds) // cfg.data.val_batch_size)
    check(launches == len(want_steps) * batches,
          f"confusion kernel launched {launches} times in fit, expected {len(want_steps)} "
          f"quick-evals x {batches} validation batches")
    print(f"[8] quick-eval in fit: points at steps {want_steps}, confusion kernel launches "
          f"{launches} = {len(want_steps)} quick-evals x {batches} batches; "
          + "; ".join(f"step {s}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, quick[s]))
                      for s in want_steps))

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True  # two passes, the same predictions
    t0 = time.perf_counter()
    got = trainer.quick_eval()
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    total = torch.zeros((2, 2), device="cuda")
    for images, labels in batch_iterator(trainer.val_ds, cfg.data.val_batch_size, epochs=1):
        preds = trainer.eval_step(torch.from_numpy(images).cuda())["preds"]
        total += cm.binary_confusion_matrix_plain(torch.from_numpy(labels).cuda(), preds)
    want = {k: float(v) for k, v in foreground_metrics_from_cm(total).items()}
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    worst = max(abs(got[k] - want[k]) for k in names)
    check(sorted(got) == sorted(names) and worst <= 1e-6,
          f"quick_eval {got} vs the plain confusion matrix's {want}")
    print(f"[8] Trainer.quick_eval over {len(trainer.val_ds)} scenes of 640x640: "
          f"{quick_s * 1e3:.2f} ms on the host's clock; equal to the metrics of the plain "
          f"confusion matrix on the same predictions (max abs diff {worst:.1e}, limit 1e-6)")


def phase_compare_variants(k8) -> None:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, generate_scene, val_transform_batch
    from iswm_tpu_torch.infer import quantization as q
    from iswm_tpu_torch.models import build_model

    rng = np.random.default_rng(SEED)
    images, masks = zip(*(generate_scene(rng, size=(512, 512)) for _ in range(EVAL_SCENES)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16
    model = build_model(cfg.model, seed=SEED).to("cuda", memory_format=torch.channels_last)

    k8.launches = 0
    t0 = time.perf_counter()
    report = q.compare_variants(model, dataset, EVAL_VARIANTS, sequence_length=7)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    launches = k8.launches
    print(q.format_report(report))
    check(list(report) == list(EVAL_VARIANTS), f"variants reported: {list(report)}")
    for name, r in report.items():
        numbers = [r[k] for k in ("avg_latency_ms", "miou", "fiou", "ff1", "weighted",
                                  "size_mb", "mask_agreement")]
        check(bool(np.isfinite(numbers).all()) and r["avg_latency_ms"] > 0,
              f"{name}: latency or metrics not finite: {r}")
    check(report["f32"]["verdict"] == "reference variant", "f32 is not the reference variant")
    top = [verdict for _, verdict in q.AGREEMENT_TIERS[:2]]
    for name in ("bf16", "int8"):
        check(report[name]["verdict"] in top,
              f"{name} vs f32: agreement {report[name]['mask_agreement']} "
              f"({report[name]['verdict']})")
    sites = sum(SLICE_SHAPES.values())
    check(launches == sites * (EVAL_SCENES + 1),
          f"int8_exec launched {launches} kernels, expected {sites} for each of "
          f"{EVAL_SCENES} images and the probe")

    x = val_transform_batch(torch.from_numpy(dataset[0][0])[None].cuda())
    scales = q.calibrate_activations(model, [x.permute(0, 3, 1, 2)])
    check(set(scales) == set(q.activation_sites(model)) and len(scales) == 61
          and all(np.isfinite(v) and v > 0 for v in scales.values()),
          f"{len(scales)} activation scales for {len(q.activation_sites(model))} sites")
    act = q.make_variant_fn(model, "int8_act", act_scales=scales)(x)
    weight_only = q.make_variant_fn(model, "int8")(x)
    diff = float((act - weight_only).abs().max())
    check(bool(torch.isfinite(act).all()) and diff > 0,
          f"int8_act logits equal int8's (max abs diff {diff})")
    print(f"[9] compare_variants, ResNet-50 / OS 16 / bf16, {EVAL_SCENES} scenes of 512x512, "
          f"{len(EVAL_VARIANTS)} variants in {compare_s:.2f} s; int8_exec launches {launches} = "
          f"{sites} x ({EVAL_SCENES} images + 1 probe); {len(scales)} activation scales; "
          f"int8_act differs from int8 by up to {diff:.4f} in the logits")


STEM_KERNELS = ("stats_partial", "pool_fwd", "bwd_sums_partial", "bwd_wgrad_partial",
                "sum_partials")


def _stem_case(b, s, dtype, gen, channels_last=True, kind="random"):
    """(z, x, dp, gamma, beta) of one stem case: the conv output z
    [b, 64, s, s] with per-channel offsets, the image x [b, 3, 2s, 2s] and the
    pooled cotangent dp, in ``dtype``."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    z = (rand(b, 64, s, s) * 1.5 + rand(1, 64, 1, 1) * 0.5).to(dtype)
    gamma, beta = 1.0 + 0.5 * rand(64), 0.1 * rand(64)
    if kind == "ties":  # constant z: every window is a 9-way (4- or 6-way at the rim) tie
        z, gamma, beta = torch.ones_like(z), torch.ones(64, device="cuda"), beta + 5.0
    elif kind == "negative":  # relu(bn(z)) = 0 everywhere
        gamma, beta = gamma.abs(), beta - 100.0
    x, dp = rand(b, 3, 2 * s, 2 * s).to(dtype), rand(b, 64, s // 2, s // 2).to(dtype)
    if channels_last:
        z, x, dp = (t.contiguous(memory_format=torch.channels_last) for t in (z, x, dp))
    return z, x, dp, gamma, beta


def _close(got, want, tol=1e-5):
    """max |got - want| in float64, and whether it is within tol * max|want|."""
    err = float((got.double() - want.double()).abs().max())
    return err, err <= tol * float(want.double().abs().max())


def _unfused_stem_chain(z, x, dp, gamma, beta):
    """The unfused chain on the same tensors: (forward, backward) callables.
    Another function than the kernels': first-index pool routing, BatchNorm's
    output rounded to z's dtype, and the weight gradient through cuDNN."""
    F = torch.nn.functional
    weight, bias = gamma.to(z.dtype), beta.to(z.dtype)

    def forward(leaf=z):
        y = torch.relu(F.batch_norm(leaf, None, None, weight, bias, True, 0.0, 1e-5))
        return F.max_pool2d(y, 3, 2, 1)

    leaf = z.detach().requires_grad_()
    pooled = forward(leaf)

    def backward():
        (dz,) = torch.autograd.grad(pooled, leaf, dp, retain_graph=True)
        return torch.nn.grad.conv2d_weight(x, (64, 3, 7, 7), dz, stride=2, padding=3)

    return forward, backward


def phase_stem_kernels(fs) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s = STEM_SLICE
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("slice bf16 NHWC", b, s, bf16, True, "random"),
        ("slice bf16 NCHW", b, s, bf16, False, "random"),
        ("slice f32 NHWC", b, s, f32, True, "random"),
        ("slice f32 NCHW", b, s, f32, False, "random"),
        ("S=32 bf16 (whole tiles)", 2, 32, bf16, True, "random"),
        ("S=20 f32 (ragged tiles)", 2, 20, f32, True, "random"),
        ("S=44 bf16 (ragged tiles)", 2, 44, bf16, False, "random"),
        ("batch 1 S=32 f32", 1, 32, f32, True, "random"),
        ("all-tie z, S=32 bf16", 2, 32, bf16, True, "ties"),
        ("all-negative pre-activation, S=32 f32", 2, 32, f32, True, "negative"),
    ]
    errs = {"stats": 0.0, "pool": 0.0, "sums": 0.0, "wgrad": 0.0}
    for name, bb, ss, dtype, channels_last, kind in cases:
        z, x, dp, gamma, beta = _stem_case(bb, ss, dtype, gen, channels_last, kind)
        n = bb * ss * ss
        total, total_sq = fs.stem_stats(z)
        again = fs.stem_stats(z)
        want = fs.stem_stats_plain(z, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(total, again[0]) and torch.equal(total_sq, again[1]),
              f"stem_stats not bit-stable ({name})")
        e_stats = 0.0
        for got, ref, what in ((total, want[0], "sum z"), (total_sq, want[1], "sum z^2")):
            err, ok = _close(got, ref)
            check(ok, f"stem_stats {what} ({name}): max abs err {err} vs float64")
            e_stats = max(e_stats, err)
        if kind == "ties":  # the JAX package's engineered case: statistics given
            mean, sigma_inv = torch.zeros(64, device="cuda"), torch.ones(64, device="cuda")
        else:
            mean = total / n
            sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + 1e-5)
        scale, bias = fs.fold_affine(gamma, beta, mean, sigma_inv)

        pooled = fs.stem_norm_relu_pool(z, scale, bias)
        pooled_plain = fs.stem_norm_relu_pool_plain(z, scale, bias)
        torch.cuda.synchronize()
        e_pool = float((pooled.float() - pooled_plain.float()).abs().max())
        check(pooled.dtype == dtype and torch.equal(pooled, pooled_plain),
              f"stem_norm_relu_pool != plain ({name}): max abs err {e_pool}")

        args = (z, dp, scale, bias, mean, sigma_inv)
        s1, s2 = fs.stem_bwd_sums(*args)
        again = fs.stem_bwd_sums(*args)
        want = fs.stem_bwd_sums_plain(*args, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(s1, again[0]) and torch.equal(s2, again[1]),
              f"stem_tail_bwd sums not bit-stable ({name})")
        e_sums = 0.0
        for got, ref, what in ((s1, want[0], "s1 (dbeta)"), (s2, want[1], "s2 (dgamma)")):
            err, ok = _close(got, ref)
            check(ok or (kind == "negative" and err == 0.0),
                  f"stem_tail_bwd {what} ({name}): max abs err {err} vs float64")
            e_sums = max(e_sums, err)

        wargs = (z, dp, x, scale, bias, mean, sigma_inv, s1 / n, s2 / n)
        dw = fs.stem_bwd_wgrad(*wargs)
        again = fs.stem_bwd_wgrad(*wargs)
        want = fs.stem_bwd_wgrad_plain(*wargs, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(dw, again), f"stem_tail_bwd wgrad not bit-stable ({name})")
        e_wgrad, ok = _close(dw, want)
        check(tuple(dw.shape) == (64, 3, 7, 7) and (ok or (kind == "negative" and e_wgrad == 0.0)),
              f"stem_tail_bwd dW ({name}): max abs err {e_wgrad} vs float64, "
              f"max |dW| {float(want.abs().max())}")
        note = ""
        if kind == "ties":  # equal-split keeps every window's mass: dbeta = sum dp
            mass = dp.double().sum(dim=(0, 2, 3))
            err, ok = _close(s1, mass)
            check(ok, f"all-tie z: dbeta differs from sum dp by {err}")
            note = f"; dbeta = sum dp within {err:.2e}"
        if kind == "negative":
            check(not pooled.float().any() and not s1.any() and not s2.any() and not dw.any(),
                  "all-negative pre-activation: a pooled value or a gradient is not 0")
            note = "; pooled, dbeta, dgamma and dW all 0"
        for key, err in (("stats", e_stats), ("pool", e_pool), ("sums", e_sums),
                         ("wgrad", e_wgrad)):
            errs[key] = max(errs[key], err)
        print(f"[10] fused stem {name}: statistics max abs err {e_stats:.3e}, pooled equal bit "
              f"for bit, s1/s2 {e_sums:.3e}, dW {e_wgrad:.3e} vs float64 (each within 1e-5 * "
              f"max|tensor|), all bit-stable{note}")
        del z, x, dp, pooled, pooled_plain, want, dw, again

    # times at the training slice's shape and layout, z out of the L2 cache
    z, x, dp, gamma, beta = _stem_case(b, s, bf16, gen)
    n = b * s * s
    total, total_sq = fs.stem_stats(z)
    mean = total / n
    sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + 1e-5)
    scale, bias = fs.fold_affine(gamma, beta, mean, sigma_inv)
    args = (z, dp, scale, bias, mean, sigma_inv)
    s1, s2 = fs.stem_bwd_sums(*args)
    wargs = (z, dp, x, scale, bias, mean, sigma_inv, s1 / n, s2 / n)
    chain_fwd, chain_bwd = _unfused_stem_chain(z, x, dp, gamma, beta)
    calls = {
        "stats": (lambda: fs.stem_stats(z), lambda: fs.stem_stats_plain(z)),
        "pool": (lambda: fs.stem_norm_relu_pool(z, scale, bias),
                 lambda: fs.stem_norm_relu_pool_plain(z, scale, bias)),
        "sums": (lambda: fs.stem_bwd_sums(*args), lambda: fs.stem_bwd_sums_plain(*args)),
        "wgrad": (lambda: fs.stem_bwd_wgrad(*wargs), lambda: fs.stem_bwd_wgrad_plain(*wargs)),
    }
    nbytes = {t: v.numel() * v.element_size() for t, v in (("z", z), ("x", x), ("dp", dp))}
    vec = 64 * 4
    taps = 7 * 7 * 3
    # operations on these inputs: sums of z and z^2; affine, relu and the 9-way
    # maximum (9 visits per pooled value); the same recomputed plus tie counts,
    # shares and the two sums; the same plus dz, all float32 outside the tensor
    # cores.  Then the contraction, 2 * 147 * 64 operations a conv pixel: its
    # operands are dz and the image in z's dtype (bf16 here), so its peak is
    # the tensor cores' for that type, whatever units the kernel uses.
    contraction, elementwise = 2 * taps * z.numel(), 16 * z.numel()
    tensor_ops_per_s = BF16_OPS_PER_S if z.dtype == bf16 else TF32_OPS_PER_S
    least = {
        "stats": least_time(nbytes["z"] + 2 * vec, 3 * z.numel(), F32_OPS_PER_S),
        "pool": least_time(nbytes["z"] + nbytes["dp"] + 2 * vec, 6 * z.numel(), F32_OPS_PER_S),
        "sums": least_time(nbytes["z"] + nbytes["dp"] + 6 * vec, elementwise, F32_OPS_PER_S),
        # the two kinds of operation one after the other, as tensor-core operations
        "wgrad": least_time(nbytes["z"] + nbytes["dp"] + nbytes["x"] + 6 * vec + 64 * taps * 4,
                            contraction + elementwise * tensor_ops_per_s / F32_OPS_PER_S,
                            tensor_ops_per_s),
    }
    # beside the bound, not in it: the kernel contracts with float32 FMAs
    fma_ms = (contraction + elementwise) / F32_OPS_PER_S * 1e3
    chain = {"fwd": cold_device_ms(chain_fwd, reps=10), "bwd": cold_device_ms(chain_bwd, reps=10)}
    records = {}
    for key, (kernel, plain) in calls.items():
        records[key] = {"max_abs_err": errs[key], "ms": cold_device_ms(kernel, reps=10),
                        "plain_ms": cold_device_ms(plain, reps=5), **least[key],
                        "library_ms": None}  # no single PyTorch call computes it
        moved = least[key]["bound_ms"] if least[key]["bound_by"] == "bytes" else None
        print(f"[10] stem {key} at z [8, 64, 256, 256] bf16 NHWC, inputs out of L2: device time "
              f"kernel {records[key]['ms']:.4f} ms, plain {records[key]['plain_ms']:.4f} ms, "
              f"bound {least[key]['bound_ms']:.4f} ms by {least[key]['bound_by']}"
              + ("" if moved is None else
                 f" ({moved * HBM_BYTES_PER_S / 1e9:.1f} MB)")
              + (f"; the kernel uses float32 FMAs, at whose peak rate its operations alone "
                 f"would take {fma_ms:.4f} ms" if key == "wgrad" else ""))
    records["wgrad"]["units"] = "f32 FMA, no tensor cores"
    records["wgrad"]["f32_fma_ops_ms"] = fma_ms
    for pair, keys in (("fwd", ("stats", "pool")), ("bwd", ("sums", "wgrad"))):
        ours = sum(records[k]["ms"] for k in keys)
        for k in keys:
            records[k]["unfused_chain_ms"] = chain[pair]
            records[k]["unfused_chain_of"] = "+".join(keys)
        print(f"[10] stem {pair}: kernels {' + '.join(keys)} {ours:.4f} ms; the unfused chain on "
              f"the same tensors (another function: "
              + ("F.batch_norm train + ReLU + F.max_pool2d" if pair == "fwd" else
                 "their autograd backward + the conv's cuDNN weight gradient")
              + f") {chain[pair]:.4f} ms")
    return records


def phase_stem_slice(fs, ce) -> tuple:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, augment_batch, batch_iterator, generate_scene
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import logit_diff_verdict
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import Trainer, TrainState, make_optimizer, make_train_step

    rng = np.random.default_rng(SEED)

    def scenes(n):
        images, masks = zip(*(generate_scene(rng, size=(640, 640)) for _ in range(n)))
        return ArrayDataset(np.stack(images), np.stack(masks))

    train_ds, val_ds = scenes(32), scenes(VAL_SCENES)
    cfg = Config()  # phase 6's configuration, with the fused stem
    cfg.model.fused_stem = "always"
    cfg.data.crop_size, cfg.data.batch_size = 512, 8
    cfg.train.total_itrs = cfg.train.val_interval = STEM_STEPS
    cfg.train.quick_eval_interval = cfg.train.print_interval = STEM_STEPS // 2
    cfg.train.save_val_results = False  # the PNG dump needs PIL
    out = TRAIN_OUT.with_name("chip_smoke_stem")
    shutil.rmtree(out, ignore_errors=True)
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(out / name))
    trainer = Trainer(cfg, device="cuda", train_ds=train_ds, val_ds=val_ds)

    def counts():
        return (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums,
                fs.launches_bwd_wgrad)

    fs.launches_stats = fs.launches_pool = fs.launches_bwd_sums = fs.launches_bwd_wgrad = 0
    ce.launches_fwd = ce.launches_bwd = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = counts()
    eval_forwards = 2 * -(-len(val_ds) // cfg.data.val_batch_size)  # a quick-eval, a validation
    want = (STEM_STEPS, STEM_STEPS + eval_forwards, STEM_STEPS, STEM_STEPS)
    check(train_launches == want,
          f"stem launches (stats, pool, bwd sums, bwd wgrad) {train_launches}, expected {want}: "
          f"{STEM_STEPS} steps and {eval_forwards} eval forwards")
    check((ce.launches_fwd, ce.launches_bwd) == (STEM_STEPS, STEM_STEPS),
          f"fused CE launches {(ce.launches_fwd, ce.launches_bwd)} in {STEM_STEPS} steps")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    unfused_cfg = Config().model
    check(unfused_cfg.fused_stem == "never", "fused_stem does not default to 'never'")
    build_model(unfused_cfg).load_state_dict(payload["model_state"], strict=True)
    print(f"[11] training with fused_stem='always': {STEM_STEPS} steps + 1 quick-eval + 1 "
          f"validation in {fit_s:.2f} s; launches stats {train_launches[0]}, pool "
          f"{train_launches[1]} ({STEM_STEPS} steps + {eval_forwards} eval forwards), bwd sums "
          f"{train_launches[2]}, bwd wgrad {train_launches[3]}; losses "
          f"{[round(v, 4) for v in losses]}; {Path(trainer.best_path).name} loads strict=True "
          f"into an unfused model")

    # one step fused and one unfused from one state, on one augmented batch,
    # with one dropout mask and deterministic algorithms.  The two forwards
    # differ in the last bit of some pooled values (the unfused BatchNorm
    # rounds before the ReLU and the pool and takes another variance formula),
    # and a whole step of this model answers any such difference with
    # gradients that differ by a large part of their size: so the step's
    # gradients are printed beside those of an unfused step whose pooled
    # values were moved by an ulp or two (of bf16, or of the TF32 that float32
    # convs read) at one value in a million, and the
    # backward is held to the unfused chain where the two can agree: on the
    # fused step's own image, parameters and pooled cotangent.
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                         trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
    model = trainer.state.model
    backbone = model.backbone
    start, trained_dtype = copy.deepcopy(model.state_dict()), model.compute_dtype
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
    step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused="auto", device="cuda"))
    stem = ("backbone.conv1.weight", "backbone.bn1.weight", "backbone.bn1.bias")
    F = torch.nn.functional

    def one_step(mode, hooked, hook):
        """(loss, gradients, bn1's running mean and var) of one step from
        ``start`` with ``hook`` on the forward of the module ``hooked``."""
        backbone.fused_stem = mode
        model.load_state_dict(start)
        state = TrainState(model, *factory(model.parameters()), 0)
        torch.cuda.manual_seed(SEED)
        handle = hooked.register_forward_hook(hook)
        with warnings.catch_warnings():  # ops without a deterministic version
            warnings.simplefilter("ignore")
            loss = float(step(state, x, y))
        handle.remove()
        return (loss, {k: p.grad.float().clone() for k, p in model.named_parameters()},
                backbone.bn1.running_mean.clone(), backbone.bn1.running_var.clone())

    def ratios_of(got, want):
        return sorted((float((got[k] - want[k]).abs().max()
                             / want[k].abs().max().clamp_min(1e-30)), k) for k in want)

    def nudge(module, args, out):
        """One pooled value in a million moved up by an ulp or two of what the
        convs after it read: bf16, or TF32 from a float32 tensor."""
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        where = torch.rand(out.shape, generator=gen, device="cuda") < 1e-6
        ulp = 2.0 ** (-7 if out.dtype == torch.bfloat16 else -10)
        return torch.where(where, (out.double() * (1.0 + ulp)).to(out.dtype), out)

    # limits on (loss, conv1's gradient, bn1's two gradients), from the
    # readings of seven runs on an H100, which spread (the state after four
    # steps differs between runs), so each limit stands at three to seven
    # times the largest reading.  Loss: bf16 1.8e-4 to 2.8e-3, float32 3.3e-5
    # to 1.5e-4 (the pooled values differ by an ulp here and there); bf16
    # conv1 1.3e-2 to 3.1e-2 (tie routing) and bn1 1.3e-3 to 4.3e-3; float32
    # conv1 5.9e-4 to 1.3e-3 (the library's weight gradient reads TF32) and
    # bn1 up to 9e-7
    for dtype, loss_tol, conv_tol, bn_tol in ((torch.bfloat16, 2e-2, 1e-1, 2e-2),
                                              (torch.float32, 1e-3, 5e-3, 1e-5)):
        model.compute_dtype = dtype
        seen = {}

        def grab(module, args, out):
            seen["x"] = args[0].detach()
            out.register_hook(lambda g: seen.__setitem__("dp", g.detach().clone()))

        loss_k, g_k, mean_k, var_k = one_step("always", backbone.fused_stem_pool, grab)
        loss_p, g_p, mean_p, var_p = one_step("never", backbone.maxpool, lambda *a: None)
        _, g_n, _, _ = one_step("never", backbone.maxpool, nudge)
        var_err = float((var_k - var_p).abs().max() / var_p.abs().max())
        mean_err = float((mean_k - mean_p).abs().max() / var_p.sqrt().max())
        check(var_err <= 1e-5 and mean_err <= 1e-5,
              f"{dtype}: bn1 running statistics after one fused step differ from the unfused "
              f"step's: var {var_err:.2e} * max|var|, mean {mean_err:.2e} * max sqrt(var)")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        check(rel <= loss_tol, f"{dtype}: fused step loss {loss_k} vs unfused {loss_p}")
        # the unfused chain's autograd on the fused step's inputs and cotangent
        leaves = [start[k].clone().requires_grad_() for k in stem]
        z = F.conv2d(seen["x"], leaves[0].to(dtype), None, 2, 3)
        bn = backbone.bn1
        pooled = F.max_pool2d(torch.relu(F.batch_norm(
            z, None, None, leaves[1], leaves[2], True, 0.0, bn.eps)), 3, 2, 1)
        chain = dict(zip(stem, torch.autograd.grad(pooled, leaves, seen["dp"])))
        own = ratios_of({k: g_k[k] for k in stem}, chain)
        for ratio, key in own:
            limit = conv_tol if key == stem[0] else bn_tol
            check(ratio <= limit,
                  f"{dtype}: the fused stem's gradient of {key} differs from the unfused "
                  f"chain's on the same inputs by {ratio:.2e} * max|grad| (limit {limit})")
        whole, floor = ratios_of(g_k, g_p), ratios_of(g_n, g_p)
        print(f"[11] one step fused vs fused_stem='never', {dtype}: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (rel {rel:.2e}, limit {loss_tol}); bn1 running var {var_err:.2e}, "
              f"mean {mean_err:.2e} (limit 1e-5); the stem's gradients against the unfused "
              f"chain's autograd on the same image, parameters and cotangent: "
              + ", ".join(f"{k.removeprefix('backbone.')} {r:.2e}" for r, k in own)
              + f" * max|grad| (limits: conv1 {conv_tol}, bn1 {bn_tol}); whole-step "
              f"gradients, median tensor of "
              f"{len(whole)}: fused vs unfused {whole[len(whole) // 2][0]:.2e}, unfused vs "
              f"unfused with one pooled value in a million moved by an ulp or two "
              f"{floor[len(floor) // 2][0]:.2e} (not held: the step is chaotic)")
        del seen, chain, z, pooled
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    model.compute_dtype = trained_dtype
    model.load_state_dict(start)

    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    step_ms, device_ms_of, stem_ms = {}, {}, 0.0
    for mode in ("never", "always", "always", "never"):
        model.backbone.fused_stem = mode
        times = []
        for i in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, xu8, yu8)
            torch.cuda.synchronize()
            if i >= 3:  # after warm-up
                times.append(time.perf_counter() - t0)
        step_ms.setdefault(mode, []).extend(times)
    for mode in ("never", "always"):
        model.backbone.fused_stem = mode
        kernels = traced_kernels(lambda: trainer.train_step(trainer.state, xu8, yu8), 3, 1)
        device_ms_of[mode] = sum(kernels.values())
        if mode == "always":
            ours = {k: v for k, v in kernels.items() if any(n in k for n in STEM_KERNELS)}
            check(len(ours) >= 5, f"the trace of a fused step names {sorted(ours)}")
            stem_ms = sum(ours.values())
    never, always = (float(np.median(step_ms[m])) * 1e3 for m in ("never", "always"))
    rounds = {m: [round(float(np.median(step_ms[m][i:i + 8])) * 1e3, 2) for i in (0, 8)]
              for m in step_ms}
    print(f"[11] train step, batch 8 at 512^2, median of {len(step_ms['never'])} each (never, "
          f"always, always, never): fused_stem='never' {never:.2f} ms, 'always' {always:.2f} ms "
          f"(host-bound; by round of 8: never {rounds['never']}, always {rounds['always']}); "
          f"device time of a step (profiler, per-kernel means): 'never' "
          f"{device_ms_of['never']:.2f} ms, 'always' {device_ms_of['always']:.2f} ms, of which "
          f"the stem kernels {stem_ms:.3f} ms ({100 * stem_ms / device_ms_of['always']:.2f}%); "
          f"so the unfused stem tail is {device_ms_of['never'] - device_ms_of['always'] + stem_ms:.3f} "
          f"ms of the unfused step (the difference of the two totals, plus the stem kernels)")
    del trainer, model

    # serving: the 1024x1536 scene through the tile engine, bf16
    scene = np.random.default_rng(SEED).integers(0, 256, (*SCENES[0], 3), dtype=np.uint8)
    predictors = {}
    for mode in ("always", "never"):
        pcfg = Config()
        pcfg.model.fused_stem = mode
        predictors[mode] = Predictor(pcfg, device="cuda")
    p = pcfg.predict
    tiles = (len(tile_origins(SCENES[0][0], p.tile_size, p.tile_size - p.tile_overlap))
             * len(tile_origins(SCENES[0][1], p.tile_size, p.tile_size - p.tile_overlap)))
    chunks = -(-tiles // p.tile_batch)
    before = counts()
    product = predictors["always"].predict_image(scene)
    torch.cuda.synchronize()
    serve_launches = tuple(a - b for a, b in zip(counts(), before))
    check(serve_launches == (0, chunks, 0, 0),
          f"serving launched (stats, pool, bwd sums, bwd wgrad) {serve_launches}, expected "
          f"the pool kernel once for each of {chunks} chunks and no other")
    check(product["mask"].shape == SCENES[0] and bool(np.isfinite(product["prob_fg"]).all()),
          "the fused Predictor's products")
    from iswm_tpu_torch.data import val_transform_batch

    xs = val_transform_batch(torch.from_numpy(scene).cuda())
    logits = {m: pr.engine.infer_scene(xs) for m, pr in predictors.items()}
    check(bool(torch.isfinite(logits["always"]).all()), "fused scene logits not finite")
    agree, verdict = logit_diff_verdict(logits["never"].cpu().numpy(),
                                        logits["always"].cpu().numpy())
    check(agree >= 0.999, f"fused vs unfused Predictor: mask agreement {agree} ({verdict})")
    latency = {}
    for mode in ("never", "always", "always", "never"):
        predictors[mode].predict_image(scene)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictors[mode].predict_image(scene)
            torch.cuda.synchronize()
            latency.setdefault(mode, []).append(time.perf_counter() - t0)
    never, always = (float(np.median(latency[m])) * 1e3 for m in ("never", "always"))
    print(f"[11] bf16 Predictor on the {SCENES[0][0]}x{SCENES[0][1]} scene ({tiles} tiles, "
          f"{chunks} chunks): stem_norm_relu_pool launches {serve_launches[1]}, logits finite, "
          f"mask agreement with the unfused Predictor {agree:.6f} ({verdict}); scene latency "
          f"median of {len(latency['never'])}: fused_stem='never' {never:.2f} ms, 'always' "
          f"{always:.2f} ms")
    return tuple(a + b for a, b in zip(train_launches, serve_launches))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an H100",
              file=sys.stderr)
        return 1
    from iswm_tpu_torch.ops.kernels import confusion as cm
    from iswm_tpu_torch.ops.kernels import fused_ce as ce
    from iswm_tpu_torch.ops.kernels import fused_stem as fs
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    phase_device()
    phase_build({"int8_matmul": k8, "fused_ce": ce, "confusion": cm, "fused_stem": fs})
    record = phase_kernel(k8)
    # int8_matmul_prequant is on no main path (in the JAX package only tests
    # and benchmarks call it, and so here): its count over the three main
    # paths stays 0; phase 7's launches hold it against its plain version
    k8.launches_prequant = 0
    launches = phase_slice(k8)
    ce_record = phase_fused_ce(ce)
    (ce_fwd, ce_bwd, cm_launches), trainer = phase_train(ce, cm)
    prequant_launches = k8.launches_prequant
    cm_record, prequant_record = phase_eval_kernels(k8, cm)
    phase_quick_eval(cm, trainer, cm_launches)
    del trainer
    k8.launches_prequant = 0
    phase_compare_variants(k8)
    prequant_launches += k8.launches_prequant
    stem_records = phase_stem_kernels(fs)
    stem_launches = dict(zip(("stats", "pool", "sums", "wgrad"), phase_stem_slice(fs, ce)))
    for name, count in (("int8_matmul", launches), ("fused_binary_ce_fwd", ce_fwd),
                        ("fused_binary_ce_bwd", ce_bwd), ("binary_confusion_matrix", cm_launches),
                        *((f"stem {k}", v) for k, v in stem_launches.items())):
        check(count > 0, f"the main paths never launched {name}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("iswm_tpu", "jax", "flax"))
    check(not loaded, f"the port imported {loaded}")
    fused = "iswm_tpu/ops/pallas/fused_ce.py"
    matmul = "iswm_tpu/ops/pallas/int8_matmul.py"
    stem = "iswm_tpu/ops/pallas/fused_stem.py"
    stem_rows = (
        ("stem_stats", "stats", f"{stem}:106 (stem_stats {stem}:98)"),
        ("stem_norm_relu_pool", "pool", f"{stem}:168 (stem_norm_relu_pool {stem}:154)"),
        ("stem_tail_bwd_sums", "sums",
         f"{stem}:420 (_bwd_sums_kernel, first call of stem_tail_bwd {stem}:368)"),
        ("stem_tail_bwd_wgrad", "wgrad",
         f"{stem}:450 (_bwd_wgrad_kernel, second call of stem_tail_bwd {stem}:368)"),
    )
    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_matmul.cu",
         "replaces": f"{matmul}:43", "launches": launches, **record},
        {"name": "int8_matmul_prequant", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_matmul.cu",
         "replaces": f"{matmul}:96", "launches": prequant_launches,
         "on_a_main_path": False, **prequant_record},
        {"name": "fused_binary_ce_fwd", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/fused_ce.cu",
         "replaces": f"{fused}:76 (_fwd_kernel, reached from fused_binary_ce {fused}:134)",
         "launches": ce_fwd, **ce_record["fwd"]},
        {"name": "fused_binary_ce_bwd", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/fused_ce.cu",
         "replaces": f"{fused}:117 (_bwd_kernel, reached from fused_binary_ce {fused}:134)",
         "launches": ce_bwd, **ce_record["bwd"]},
        {"name": "binary_confusion_matrix", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/confusion.cu",
         "replaces": "iswm_tpu/ops/pallas/confusion.py:54",
         "launches": cm_launches, **cm_record},
        *({"name": name, "route": "cuda", "source": "iswm_tpu_torch/csrc/fused_stem.cu",
           "replaces": replaces, "launches": stem_launches[key], **stem_records[key]}
          for name, key, replaces in stem_rows),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
