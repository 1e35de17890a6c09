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


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(1000, 256, 128), (8, 2048, 256)])
def test_cuda_kernel_bit_equals_plain(mkn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    m, k, n = mkn
    rng = np.random.default_rng(5)
    x, x_scale = _inputs("saturate", rng, m, k)
    w_q, w_scale = _weights(rng, k, n)
    xt = torch.from_numpy(x).cuda().to(torch.bfloat16)
    w_qt, w_st = torch.from_numpy(w_q).cuda(), torch.from_numpy(w_scale).cuda()
    before = port_int8.launches
    got = port_int8.int8_matmul(xt, w_qt, w_st, x_scale)
    torch.cuda.synchronize()
    assert port_int8.launches == before + 1
    assert torch.equal(got, port_int8.int8_matmul_plain(xt, w_qt, w_st, x_scale))


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
