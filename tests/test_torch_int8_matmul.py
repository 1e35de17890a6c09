"""The port's int8 matmul against the JAX package's Pallas kernel.

The plain PyTorch version (what the wrapper runs for a CPU tensor) must
equal the Pallas kernel, run in interpret mode, bit for bit: the int32
sum is exact and every float step is the same IEEE operation.  The CUDA
kernel is held against the plain version on the card, where there is no
jax: there this file runs alone,
``python -m pytest --noconftest tests/test_torch_int8_matmul.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.ops.kernels import int8_matmul as port_int8


@pytest.fixture(scope="module")
def jax_int8():
    from iswm_tpu.ops.pallas import int8_matmul

    return int8_matmul


def _weights(rng, k, n):
    w = rng.normal(size=(k, n)).astype(np.float32)
    amax = np.abs(w).max(axis=0)
    w_scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    return w_q, w_scale


def _inputs(case, rng, m, k):
    """x (float32 values) and x_scale for one edge case."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    x_scale = float(np.abs(x).max() / 127.0)
    if case == "saturate":  # |x / x_scale| up to 4 x 127: clipped codes
        x_scale /= 4.0
    elif case == "ties":  # exact .5 quotients: round half to even
        x_scale = 0.25
        x = (rng.integers(-300, 300, size=(m, k)) + 0.5).astype(np.float32) * 0.25
    return x, x_scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "saturate", "ties"])
@pytest.mark.parametrize("mkn", [(100, 256, 128), (300, 128, 256)])
def test_plain_int8_matmul_bit_equals_pallas(jax_int8, dtype, case, mkn):
    import jax.numpy as jnp

    m, k, n = mkn  # m deliberately not a multiple of the 256-row TPU tile
    rng = np.random.default_rng([len(case), *mkn, dtype == "bfloat16"])
    x, x_scale = _inputs(case, rng, m, k)
    w_q, w_scale = _weights(rng, k, n)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_int8.int8_matmul(
        xj, jnp.asarray(w_q), jnp.asarray(w_scale), x_scale, interpret=True
    ))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = port_int8.int8_matmul(
        xt, torch.from_numpy(w_q), torch.from_numpy(w_scale), x_scale
    )
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_quantized_conv1x1_bit_equals_pallas(jax_int8, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 256)).astype(np.float32)
    w_q, w_scale = _weights(rng, 256, 128)
    x_scale = float(np.abs(x).max() / 127.0) / 2.0
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_int8.quantized_conv1x1(
        xj, jnp.asarray(w_q).reshape(1, 1, 256, 128),
        jnp.asarray(w_scale).reshape(1, 1, 1, 128), x_scale, interpret=True,
    ))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_q.T)).reshape(128, 256, 1, 1)
    got = port_int8.quantized_conv1x1(xt, w_oihw, torch.from_numpy(w_scale), x_scale)
    assert got.shape == (2, 5, 7, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(200, 128), (128, 100)])
def test_wrapper_rejects_k_or_n_not_multiple_of_128(k, n):
    x = torch.zeros(16, k)
    w_q = torch.zeros(k, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 128"):
        port_int8.int8_matmul(x, w_q, torch.ones(n), 0.1)


# One shape for each branch of the kernel's plan, and what the plan does
# there, given x's bytes a value (2 bf16, 4 f32, 1 int8): a K split at
# M = 8 and at a ragged M, two N groups at a ragged M, a 3-stage ring,
# 32-row strips (mma.sync), 128-row strips (wgmma, as the 64-row ones)
PLAN_BRANCHES = {
    "k_split_m8": ((8, 2048, 256), lambda p, xb: p["splits"] > 1),
    "k_split_ragged_m": ((200, 2048, 512), lambda p, xb: p["splits"] > 1),
    "n_groups_ragged_m": ((4001, 256, 1024),
                          lambda p, xb: p["bm"] == 64 and p["groups"] == 2 and p["splits"] == 1),
    "three_stages": ((32768, 512, 256), lambda p, xb: p["stages"] == 3 or xb != 4),
    "rows_32": ((1000, 1024, 512), lambda p, xb: p["bm"] == 32 and p["splits"] == 1),
    "rows_128": ((8192, 1024, 2048), lambda p, xb: p["bm"] == 128 or xb != 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("branch", sorted(PLAN_BRANCHES))
def test_cuda_kernel_bit_equals_plain(branch, dtype):
    """int8_matmul (bf16, f32 x) and int8_matmul_prequant (int8 x) against
    their plain versions, bit for bit, at a shape of each branch of the
    plan; the plan must be in shared memory and take that branch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    (m, k, n), reaches = PLAN_BRANCHES[branch]
    rng = np.random.default_rng(5)
    x, x_scale = _inputs("saturate", rng, m, k)
    w_q, w_scale = _weights(rng, k, n)
    w_qt, w_st = torch.from_numpy(w_q).cuda(), torch.from_numpy(w_scale).cuda()
    xt = torch.from_numpy(x).cuda()
    x_bytes = {"bfloat16": 2, "float32": 4, "int8": 1}[dtype]
    plan = port_int8.plan(m, k, n, x_bytes)
    assert reaches(plan, x_bytes), plan
    assert plan["smem"] <= 227 * 1024
    if dtype == "int8":
        xs = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
        xt = torch.clamp(torch.round(xt / xs), -127, 127).to(torch.int8)
        before = port_int8.launches_prequant
        got = port_int8.int8_matmul_prequant(xt, w_qt, w_st, x_scale)
        want = port_int8.int8_matmul_prequant_plain(xt, w_qt, w_st, x_scale)
        count = port_int8.launches_prequant
    else:
        xt = xt.to(getattr(torch, dtype))
        before = port_int8.launches
        got = port_int8.int8_matmul(xt, w_qt, w_st, x_scale)
        want = port_int8.int8_matmul_plain(xt, w_qt, w_st, x_scale)
        count = port_int8.launches
    torch.cuda.synchronize()
    assert count == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_cuda_conv1x1_takes_nchw_contiguous_pixels(batch):
    """An NCHW-contiguous activation permuted to NHWC: at batch 1 its pixels
    reshape to a transposed [M, K] view, which the wrapper must copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(batch, 256, 6, 5)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    w_q, w_scale = _weights(rng, 256, 128)
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_q.T)).reshape(128, 256, 1, 1).cuda()
    w_st = torch.from_numpy(w_scale).cuda()
    got = port_int8.quantized_conv1x1(x, w_oihw, w_st, 0.05)
    torch.cuda.synchronize()
    assert got.shape == (batch, 6, 5, 128)
    assert torch.equal(got, port_int8.quantized_conv1x1_plain(x, w_oihw, w_st, 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("x_scale", [0.25, 0.012345, 3.7e-3, 1e-30, 3e-39, 1e30])
def test_cuda_quantize_every_bf16_value(x_scale):
    """Every bf16 value (NaN aside) and float32 values within three ulps of
    a rounding tie of x / x_scale give the plain version's codes: the IEEE
    division, rounding half to even, clipping; also at scales whose
    reciprocal is not a normal float."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(512, 128).cuda()
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    rng = np.random.default_rng(7)
    s32 = float(np.float32(x_scale))
    ties = ((rng.integers(-130, 130, size=(512, 128)) + 0.5) * s32).astype(np.float32)
    for _ in range(3):
        step = rng.integers(-1, 2, size=ties.shape)
        ties = np.nextafter(ties, (ties + step * np.abs(ties)).astype(np.float32))
    w_q, w_scale = _weights(rng, 128, 128)
    w_qt, w_st = torch.from_numpy(w_q).cuda(), torch.from_numpy(w_scale).cuda()
    for xt in (x, torch.from_numpy(ties.astype(np.float32)).cuda()):
        got = port_int8.int8_matmul(xt, w_qt, w_st, x_scale)
        torch.cuda.synchronize()
        assert torch.equal(got, port_int8.int8_matmul_plain(xt, w_qt, w_st, x_scale))
