"""Exportable hand kernels, on the CPU: the dispatcher's ``iswm`` operators
(``iswm_tpu_torch/ops/kernels/__init__.py``) and ``infer/engine.py``'s
``serialize`` / ``deserialize`` of the serving fns that reach them.

- Each operator passes ``torch.library.opcheck`` (schema, autograd
  registration, fake tensor) on small CPU inputs, in both
  scale forms where it has two, and its fake gives the strides of its
  implementation on each device: the CPU's plain version's here, the
  kernel's documented layout for a fake CUDA tensor (contiguous, NHWC memory
  for the stem's pool), which is what the trace on the card decides from.
- The port's ``int8_exec``, ``int8_exec_xla`` (``--int8_stem``) and
  ``fused_stem="always"`` bf16 fns of ResNet-18 at 32^2, float32, through
  ``serialize(device="cpu")`` -> ``deserialize``, give the eager fn's logits
  bit for bit; the graph calls the ``iswm`` operators; the trace runs no
  plain version and moves no launch counter, and the loaded artifact runs
  the plain versions (the CPU implementations).
- The ``int8_exec_xla`` artifact against the JAX package's
  ``deserialize(serialize(make_int8_exec_fn(...)))``, built as
  ``tests/test_quantization.py``'s round trip builds it (on its input,
  ``default_rng(31)``), with the port's weights crossed into it and the
  port's calibrated scales on both sides (the JAX keys traced, not
  compiled: the JAX artifact is the one JAX compile): within 1e-2 *
  max|logit| and mask agreement >= 0.999 (ROADMAP.md's int8 rule); its
  routed weights are int8 constants and the blob is smaller than the
  float32 parameters.
- An artifact saved to a file loads through ``deserialize`` in a fresh
  interpreter that imports nothing of the port but ``infer.engine``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from iswm_tpu_torch.config import ModelConfig
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.infer.engine import deserialize, serialize
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.ops.kernels import fused_stem as fs
from iswm_tpu_torch.ops.kernels import int8_conv as kc
from iswm_tpu_torch.ops.kernels import int8_matmul as k8

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SHAPE = (1, 32, 32, 3)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


def _op_cases():
    """{name: (operator, args, the kernel's output layout on the card)}."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    ops = torch.ops.iswm
    x_nhwc = randn(2, 5, 6, 24, dtype=torch.bfloat16)
    z = randn(2, 64, 8, 8, dtype=torch.bfloat16)
    return {
        "int8_matmul": (ops.int8_matmul.default,
                        (randn(16, 128), _codes(rng, (128, 256)), randn(256).abs(), 0.05)),
        # quantized_conv1x1 passes the OIHW weights' transposed view
        "int8_matmul_transposed_w": (ops.int8_matmul.default,
                                     (randn(16, 128, dtype=torch.bfloat16),
                                      _codes(rng, (128, 128)).t(), randn(128).abs(), 0.01)),
        "int8_matmul_prequant": (ops.int8_matmul_prequant.default,
                                 (_codes(rng, (16, 128)), _codes(rng, (128, 128)),
                                  randn(128).abs(), 0.05)),
        # Int8ConcatConvBN's part: a channel slice of one NHWC tensor
        "quantize_s8_slice": (ops.quantize_s8.default, (x_nhwc[..., 8:16], 0.02, None)),
        "quantize_s8_amax": (ops.quantize_s8.default,
                             (x_nhwc.float(), 1.0, torch.tensor(2.5))),
        "conv_s8_igemm": (ops.conv_s8_igemm.default,
                          (_codes(rng, (2, 7, 9, 16)), _codes(rng, (48, 3, 3, 16)),
                           randn(48).abs(), 0.05, None, randn(48), [2, 1], [1, 2, 0, 1],
                           [1, 1], torch.bfloat16)),
        "conv_s8_igemm_amax": (ops.conv_s8_igemm.default,
                               (_codes(rng, (2, 7, 9, 16)), _codes(rng, (48, 3, 3, 16)),
                                randn(48).abs(), 1.0, torch.tensor(3.0), None, [1, 1],
                                [2, 2, 2, 2], [2, 2], torch.float32)),
        "conv_s8_direct": (ops.conv_s8_direct.default,
                           (_codes(rng, (2, 7, 9, 16)), _codes(rng, (16, 3, 3, 4)),
                            randn(16).abs(), 0.05, None, None, [1, 1], [1, 1, 1, 1], [1, 1], 4,
                            torch.float32)),
        "stem_norm_relu_pool": (ops.stem_norm_relu_pool.default,
                                (z.float(), randn(64), randn(64))),
        "stem_norm_relu_pool_channels_last": (
            ops.stem_norm_relu_pool.default,
            (z.contiguous(memory_format=torch.channels_last), randn(64), randn(64))),
    }


OP_CASES = sorted(_op_cases())
OPCHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


@pytest.mark.parametrize("case", OP_CASES)
def test_op_passes_opcheck_and_its_fake_gives_each_devices_strides(case):
    op, args, = _op_cases()[case]
    torch.library.opcheck(op, args, test_utils=OPCHECKS)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
        assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
        on_card = op(*(torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                       if isinstance(a, torch.Tensor) else a for a in args))
    layout = (torch.channels_last if op is torch.ops.iswm.stem_norm_relu_pool.default
              else torch.contiguous_format)
    assert on_card.device.type == "cuda" and on_card.is_contiguous(memory_format=layout)
    assert (on_card.shape, on_card.dtype) == (real.shape, real.dtype)


# ---------------------------------------------------------------- artifacts
@pytest.fixture(scope="module")
def crossed():
    """(the port's ResNet-18 V3+ float32 model with BatchNorm perturbed, the
    JAX model, params and statistics with its weights, the input)."""
    from .test_torch_int8_xla import _crossed

    x = np.random.default_rng(31).normal(size=SHAPE).astype(np.float32)
    return (*_crossed("deeplabv3plus", "resnet18"), x)


def _fn(variant, crossed):
    model, _, _, _, x = crossed
    images = [torch.from_numpy(x).permute(0, 3, 1, 2)]
    if variant == "int8_exec_xla":
        scales = pq.calibrate_conv_inputs(model, images, wide=True, stem=True)
        return pq.make_variant_fn(model, variant, conv_scales=scales, stem=True)
    if variant == "int8_exec":
        return pq.make_variant_fn(model, variant, conv_scales=pq.calibrate_conv_inputs(
            model, images))
    fused = build_model(ModelConfig(name="deeplabv3plus", backbone="resnet18",
                                    compute_dtype="float32", fused_stem="always"))
    fused.load_state_dict(model.state_dict())
    return pq.make_variant_fn(fused, "bf16")


# the operators each artifact's graph calls
VARIANT_OPS = {
    "int8_exec": {"int8_matmul"},
    "int8_exec_xla": {"int8_matmul", "quantize_s8", "conv_s8_igemm"},
    "bf16_fused_stem": {"stem_norm_relu_pool"},
}
# each operator's plain version, its CPU implementation
PLAINS = {"int8_matmul": (k8, "int8_matmul_plain"), "quantize_s8": (kc, "quantize_s8_plain"),
          "conv_s8_igemm": (kc, "conv_s8_plain"),
          "stem_norm_relu_pool": (fs, "stem_norm_relu_pool_plain")}
COUNTERS = ((k8, "launches"), (kc, "launches_quantize"), (kc, "launches_igemm"),
            (kc, "launches_direct"), (fs, "launches_pool"))


@pytest.fixture(scope="module")
def artifacts(crossed):
    """{variant: (serving fn, blob, the loaded artifact, plain versions run
    by the trace, by the loaded artifact's call)}, each serialized once."""
    out = {}
    x = torch.from_numpy(crossed[-1])
    for variant in VARIANT_OPS:
        fn = _fn(variant, crossed)
        ran = []
        with pytest.MonkeyPatch.context() as mp:
            for module, name in PLAINS.values():
                original = getattr(module, name)
                mp.setattr(module, name, lambda *a, _f=original, _n=name, **k: (
                    ran.append(_n), _f(*a, **k))[1])
            counts = [getattr(m, c) for m, c in COUNTERS]
            blob = serialize(fn, SHAPE, torch.float32, device="cpu")
            assert [getattr(m, c) for m, c in COUNTERS] == counts
            traced = list(ran)
            served = deserialize(blob)
            served(x)
        out[variant] = (fn, blob, served, traced, ran[len(traced):])
    return out


@pytest.mark.parametrize("variant", sorted(VARIANT_OPS))
def test_artifact_bit_equals_the_eager_fn(artifacts, crossed, variant):
    fn, _, served, traced, replayed = artifacts[variant]
    assert traced == []  # the trace ran the fakes alone
    assert set(replayed) == {PLAINS[op][1] for op in VARIANT_OPS[variant]}
    called = {str(n.target).split(".")[1] for n in served.graph.nodes
              if str(n.target).startswith("iswm.")}
    assert called == VARIANT_OPS[variant]
    rng = np.random.default_rng(7)
    for x in (crossed[-1], rng.normal(size=SHAPE).astype(np.float32)):
        got, want = served(torch.from_numpy(x)), fn(torch.from_numpy(x))
        assert got.dtype == want.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_exec_xla_artifact_agrees_with_jax(artifacts, crossed):
    import jax.numpy as jnp

    from iswm_tpu.infer import engine as jax_engine
    from iswm_tpu.infer import quantization as jq

    from .test_torch_int8_xla import _TraceOnly

    model, jmodel, params, stats, x = crossed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "jax", _TraceOnly())
        keys = jq.calibrate_conv_inputs(jmodel, params, stats, [jnp.asarray(x)], wide=True,
                                        stem=True)
    scales = pq.calibrate_conv_inputs(model, [torch.from_numpy(x).permute(0, 3, 1, 2)],
                                      wide=True, stem=True)
    assert {pq.port_site_key(k, "resnet18") for k in keys} == set(scales)
    jax_scales = {k: scales[pq.port_site_key(k, "resnet18")] for k in keys}
    jfn = jq.make_int8_exec_fn(jmodel, stats, params, jax_scales, backend="xla", stem=True)
    want = np.asarray(jax_engine.deserialize(jax_engine.serialize(jfn, SHAPE, jnp.float32))(
        jnp.asarray(x)))
    fn, blob, served, _, _ = artifacts["int8_exec_xla"]
    assert set(fn.routed_sites) == {pq.port_site_key(k, "resnet18") for k in jfn.routed_sites}
    got = served(torch.from_numpy(x)).numpy()
    agree, _ = pq.logit_diff_verdict(got, want)
    assert agree >= 0.999
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    # the routed weights ride along as int8 constants: one a routed conv (two
    # for the concat conv's parts), and the blob is below the float32 weights
    constants = [getattr(served, n.target) for n in served.graph.nodes if n.op == "get_attr"]
    int8 = [t for t in constants if t.dtype == torch.int8 and t.dim() == 4]
    assert len(int8) == len(fn.routed_sites) + 1
    f32_bytes = sum(4 * p.numel() for p in model.parameters())
    assert len(blob) < f32_bytes, (len(blob), f32_bytes)


def test_artifact_loads_in_a_fresh_interpreter(artifacts, crossed, tmp_path):
    fn, blob, _, _, _ = artifacts["int8_exec_xla"]
    x = torch.from_numpy(crossed[-1])
    (tmp_path / "engine.pt2").write_bytes(blob)
    torch.save(x, tmp_path / "x.pt")
    code = (
        "import sys, torch\n"
        "from iswm_tpu_torch.infer.engine import deserialize\n"
        "d = sys.argv[1]\n"
        "fn = deserialize(open(f'{d}/engine.pt2', 'rb').read())\n"
        "torch.save(fn(torch.load(f'{d}/x.pt')), f'{d}/out.pt')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    torch.testing.assert_close(torch.load(tmp_path / "out.pt"), fn(x), rtol=0, atol=0)
