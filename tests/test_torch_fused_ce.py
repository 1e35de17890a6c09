"""The port's fused binary CE and losses against the JAX package's, on the CPU.

The plain PyTorch versions of the fused CE (what the wrappers run for a CPU
tensor) are held against ``fused_binary_ce`` run through the Pallas
interpreter and ``jax.grad`` of it, as ``tests/test_pallas_kernels.py``
runs it, in float32: forward sums and loss within rtol 1e-5 (summation
order), gradients within 1e-6 * max|grad|.  The CUDA kernels are held
against the plain versions on the card, where there is no jax:
``python -m pytest --noconftest tests/test_torch_fused_ce.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.ops import losses as port_losses
from iswm_tpu_torch.ops.kernels import fused_ce as port_ce

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module")
def jax_ce():
    from iswm_tpu.ops.pallas import fused_ce

    return fused_ce


def _case(name, seed=0):
    """NCHW logits (float32 numpy), labels, class weights of one case."""
    shape = (2, 17, 23) if name == "odd" else (2, 32, 40)
    rng = np.random.default_rng([seed, len(name)])
    logits = (rng.normal(size=(shape[0], 2, *shape[1:])) * 3).astype(np.float32)
    labels = rng.integers(0, 2, shape).astype(np.int32)
    labels[rng.random(shape) < 0.1] = 255
    cw = np.array([1.0, 3.2] if name in ("weighted", "bf16") else [1.0, 1.0], np.float32)
    if name == "all_ignored":
        labels[:] = 255
    if name == "label2":  # neither 1 nor ignore: class 0 by the kernel's rule
        labels[0, :3] = 2
    return logits, labels, cw


CASES = ["ignore", "weighted", "odd", "bf16", "all_ignored", "label2"]


def _jax_loss_and_grad(jax_ce, logits, labels, cw, dtype="float32"):
    import jax
    import jax.numpy as jnp

    nhwc = jnp.asarray(np.transpose(logits, (0, 2, 3, 1))).astype(dtype)
    lbl, w = jnp.asarray(labels), jnp.asarray(cw)

    def f(x):
        return jax_ce.fused_binary_ce(x, lbl, w, 255, True)

    loss, grad = jax.value_and_grad(f)(nhwc)
    return float(loss), np.transpose(np.asarray(grad.astype(jnp.float32)), (0, 3, 1, 2))


@pytest.mark.parametrize("name", CASES)
def test_plain_fused_ce_matches_pallas(jax_ce, name):
    logits, labels, cw = _case(name)
    dtype = "bfloat16" if name == "bf16" else "float32"
    want_loss, want_grad = _jax_loss_and_grad(jax_ce, logits, labels, cw, dtype)

    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    loss = port_ce.fused_binary_ce(x, torch.from_numpy(labels), torch.from_numpy(cw))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5, atol=1e-7)
    got_grad = x.grad.float().numpy()
    if dtype == "bfloat16":  # both round the same f32 values to bf16: 1 ulp
        np.testing.assert_allclose(got_grad, want_grad, rtol=2 ** -7, atol=1e-12)
    else:
        assert np.abs(got_grad - want_grad).max() <= 1e-6 * max(np.abs(want_grad).max(), 1e-30)
    if name == "all_ignored":
        assert float(loss) == 0.0 and not got_grad.any()


def test_plain_forward_sums(jax_ce):
    """The two sums themselves, and the label-2 rule: class 0's logit, w0."""
    logits, labels, cw = _case("label2")
    sums = port_ce.fused_binary_ce_fwd_plain(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(cw))
    as0 = labels.copy()
    as0[as0 == 2] = 0
    want = port_ce.fused_binary_ce_fwd_plain(
        torch.from_numpy(logits), torch.from_numpy(as0), torch.from_numpy(cw),
        dtype=torch.float64)
    np.testing.assert_allclose(sums.numpy(), want.numpy(), rtol=1e-5)
    assert float(want[1]) == float((labels != 255).sum())


@pytest.mark.parametrize("name", ["weighted", "odd", "bf16"])
def test_plain_backward_is_autograd_of_plain_forward(name):
    logits, labels, cw = _case(name)
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    lbl, w = torch.from_numpy(labels), torch.from_numpy(cw)
    sums = port_ce.fused_binary_ce_fwd_plain(x, lbl, w)
    w_sum = torch.clamp_min(sums[1], 1e-12)
    (sums[0] / w_sum).backward()
    got = port_ce.fused_binary_ce_bwd_plain(x.detach(), lbl, w, w_sum.detach(),
                                            torch.tensor(1.0))
    want = x.grad.float()
    assert got.dtype == dtype
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert (got.float() - want).abs().max() <= tol * want.abs().max()


def test_wrapper_runs_plain_for_cpu_tensors_without_counting():
    logits, labels, cw = _case("weighted")
    before = (port_ce.launches_fwd, port_ce.launches_bwd)
    x = torch.from_numpy(logits).requires_grad_(True)
    port_ce.fused_binary_ce(x, torch.from_numpy(labels), torch.from_numpy(cw)).backward()
    assert (port_ce.launches_fwd, port_ce.launches_bwd) == before
    with pytest.raises(ValueError, match=r"\[B, 2, H, W\]"):
        port_ce.fused_binary_ce_fwd(x[:, :1], torch.from_numpy(labels), torch.ones(2))


def _jax_loss_fns():
    from iswm_tpu.ops import losses as jl

    return jl


@pytest.mark.parametrize("loss_type,gamma", [
    ("ce_loss", 0.0), ("IWce_loss", 0.0), ("focal_loss", 0.0), ("focal_loss", 2.0),
])
def test_losses_match_jax(loss_type, gamma):
    """The autograd losses (``fused="never"``) against ``iswm_tpu.ops.losses``:
    loss within rtol 1e-5, gradient within 1e-5 * max|grad| (JAX's own
    float32 gradient of the weighted CE is up to 6.1e-6 * max|grad| from a
    float64 one here; the port's is within 4e-7).

    Focal loss at gamma 0: JAX differentiates ``(1 - pt) ** 0`` as
    ``0 * (1 - pt) ** -1``, which is NaN where ``1 - pt`` rounds to 0: at
    every ignored pixel and at the most confident others; torch's ``pow``
    gives 0 there.  The comparison runs where JAX's gradient is finite."""
    import jax
    import jax.numpy as jnp

    jl = _jax_loss_fns()
    logits, labels, cw = _case("weighted", seed=3)
    cw = cw if loss_type == "IWce_loss" else None
    kwargs = dict(ignore_index=255)
    if loss_type == "ce_loss":
        jfn = lambda x: jl.cross_entropy_loss(x, jnp.asarray(labels), **kwargs)  # noqa: E731
    elif loss_type == "IWce_loss":
        jfn = lambda x: jl.weighted_cross_entropy_loss(  # noqa: E731
            x, jnp.asarray(labels), jnp.asarray(cw), **kwargs)
    else:
        jfn = lambda x: jl.focal_loss(x, jnp.asarray(labels), alpha=0.5,  # noqa: E731
                                      gamma=gamma, **kwargs)
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(np.transpose(logits, (0, 2, 3, 1))))
    want_grad = np.transpose(np.asarray(want_grad), (0, 3, 1, 2))

    fn = port_losses.make_loss_fn(loss_type, class_weights=cw, focal_alpha=0.5,
                                  focal_gamma=gamma, fused="never")
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = fn(x, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got_grad = x.grad.numpy()
    finite = np.isfinite(want_grad)
    if loss_type == "focal_loss" and gamma == 0.0:
        ignored = np.broadcast_to((labels == 255)[:, None], finite.shape)
        assert (~finite)[ignored].all() and finite.mean() > 0.5
        assert not got_grad[ignored].any()
    else:
        assert finite.all()
    assert np.isfinite(got_grad).all()
    err = np.abs(got_grad - want_grad)[finite].max()
    assert err <= 1e-5 * np.abs(want_grad[finite]).max()


@pytest.mark.parametrize("fused,device,want_fused", [
    ("auto", "cpu", False), ("never", "cpu", False), ("always", "cpu", True),
    ("interpret", "cpu", True),
])
def test_make_loss_fn_routing(fused, device, want_fused):
    fn = port_losses.make_loss_fn("IWce_loss", class_weights=[1.0, 2.0], fused=fused,
                                  device=device)
    assert (getattr(fn, "func", None) is port_ce.fused_binary_ce) == want_fused
    focal = port_losses.make_loss_fn("focal_loss", fused="always")
    assert focal.func is port_losses.focal_loss  # the kernel is binary CE only


def _cl_strides(b, h, w):
    return (2 * h * w, 1, 2 * w, 2)


@pytest.mark.parametrize("shape,strides,pointers,d_strides,want", [
    # the training step's channels-last logits (d_logits alike)
    ((8, 2, 512, 512), _cl_strides(8, 512, 512), (0, 4096, 8192), _cl_strides(8, 512, 512),
     ("channels_last", False)),
    # contiguous NCHW with H * W a multiple of 8 (the forward: no d_logits)
    ((2, 2, 24, 40), (2 * 960, 960, 40, 1), (512, 1024), None, ("nchw", False)),
    # an odd H * W
    ((3, 2, 17, 23), (2 * 391, 391, 23, 1), (0, 0, 0), (2 * 391, 391, 23, 1),
     ("strided", True)),
    # channels-last strides 2 bytes past a 16-byte boundary (a storage offset of 1)
    ((4, 2, 64, 64), _cl_strides(4, 64, 64), (4096 + 2, 0), None, ("strided", True)),
    # labels at an offset that is not a multiple of 16 bytes
    ((4, 2, 64, 64), _cl_strides(4, 64, 64), (0, 8, 0), _cl_strides(4, 64, 64),
     ("strided", True)),
    # d_logits in other strides than the logits
    ((4, 2, 64, 64), _cl_strides(4, 64, 64), (0, 0, 0), (8192, 4096, 64, 1),
     ("strided", True)),
    # a slice of a larger tensor
    ((2, 2, 16, 16), (3 * 18 * 21, 18 * 21, 21, 1), (0, 0), None, ("strided", True)),
    # 2 * B * H * W = 2^31 elements: the vector body with 64-bit indices
    ((2**14, 2, 256, 256), _cl_strides(2**14, 256, 256), (0, 0, 0),
     _cl_strides(2**14, 256, 256), ("channels_last", True)),
    ((2**14 - 1, 2, 256, 256), (2 * 65536, 65536, 256, 1), (0, 0), None, ("nchw", False)),
])
def test_choose_layout(shape, strides, pointers, d_strides, want):
    """The wrapper's choice of body, from shapes, strides and addresses
    alone (nothing is allocated)."""
    assert tuple(port_ce.choose_layout(shape, strides, pointers, d_strides)) == want


def _cuda_case(name, dtype, channels_last=False):
    logits, labels, cw = _case(name, seed=11)
    x = torch.from_numpy(logits).cuda().to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, torch.from_numpy(labels).cuda().to(torch.uint8), torch.from_numpy(cw).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,channels_last", [
    ("weighted", torch.bfloat16, False), ("odd", torch.float32, False),
    ("all_ignored", torch.float32, False), ("label2", torch.bfloat16, True),
])
def test_cuda_kernels_match_plain(name, dtype, channels_last):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, lbl, cw = _cuda_case(name, dtype, channels_last)
    before = (port_ce.launches_fwd, port_ce.launches_bwd)
    sums = port_ce.fused_binary_ce_fwd(x, lbl, cw)
    want = port_ce.fused_binary_ce_fwd_plain(x, lbl, cw, dtype=torch.float64)
    torch.cuda.synchronize()
    assert torch.allclose(sums.double(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(sums, port_ce.fused_binary_ce_fwd(x, lbl, cw))  # bit-stable
    w_sum, g = torch.clamp_min(sums[1], 1e-12), torch.tensor(0.7, device="cuda")
    d = port_ce.fused_binary_ce_bwd(x, lbl, cw, w_sum, g)
    d_plain = port_ce.fused_binary_ce_bwd_plain(x, lbl, cw, w_sum, g)
    torch.cuda.synchronize()
    assert (port_ce.launches_fwd, port_ce.launches_bwd) == (before[0] + 2, before[1] + 1)
    assert d.dtype == x.dtype and d.stride() == x.stride()
    err = (d.float() - d_plain.float()).abs().max()
    if dtype == torch.bfloat16:
        assert err <= 2 ** -7 * d_plain.float().abs().max()
    else:
        assert err <= 1e-6 * d_plain.abs().max()


def _layout_case(layout, dtype, label_dtype, seed):
    """Logits that the wrapper sends through ``layout`` (``strided``: a
    slice of a larger tensor), and labels of ``label_dtype`` with ~10%
    ignored and a few 2s."""
    logits, labels, cw = _case("weighted", seed=seed)
    x = torch.from_numpy(logits).cuda().to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        big = torch.zeros((x.shape[0], 3, x.shape[2] + 1, x.shape[3] + 3), dtype=dtype,
                          device="cuda")
        big[:, 1:, 1:, 3:] = x
        x = big[:, 1:, 1:, 3:]
    labels[0, 0, :4] = 2
    return x, torch.from_numpy(labels).cuda().to(label_dtype), torch.from_numpy(cw).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "nchw", "strided"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label_dtype", [torch.uint8, torch.int32, torch.int64])
def test_cuda_every_layout_matches_plain(layout, dtype, label_dtype):
    """Each body against the plain versions: the forward within 1e-5
    relative of float64 and bit-stable, the backward within 1 bf16 ulp or
    1e-6 * max, through the body the layout calls for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, lbl, cw = _layout_case(layout, dtype, label_dtype, seed=21)
    before = dict(port_ce.launches_by_layout)
    sums = port_ce.fused_binary_ce_fwd(x, lbl, cw)
    again = port_ce.fused_binary_ce_fwd(x, lbl, cw)
    want = port_ce.fused_binary_ce_fwd_plain(x, lbl, cw, dtype=torch.float64)
    w_sum, g = torch.clamp_min(sums[1], 1e-12), torch.tensor(0.7, device="cuda")
    d = port_ce.fused_binary_ce_bwd(x, lbl, cw, w_sum, g)
    d_plain = port_ce.fused_binary_ce_bwd_plain(x, lbl, cw, w_sum, g)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in port_ce.launches_by_layout.items() if v != before[k]}
    assert took == {layout: 3}
    assert torch.equal(sums, again)
    assert torch.allclose(sums.double(), want, rtol=1e-5, atol=0)
    err = (d.float() - d_plain.float()).abs()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(d_plain.float().abs().clamp_min(1e-38))) - 7)
        assert bool((err <= ulp).all())
    else:
        assert err.max() <= 1e-6 * d_plain.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_vector_and_strided_backward_bit_equal(dtype):
    """The vector bodies keep the strided body's operations: the same values
    through ``channels_last``, ``nchw`` and ``strided`` give the same
    d_logits bits; and a forward after an all-ignored one gives its bits
    again (the last block reset the ticket)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    out = {}
    for layout in ("channels_last", "nchw", "strided"):
        x, lbl, cw = _layout_case(layout, dtype, torch.int32, seed=22)
        d = port_ce.fused_binary_ce_bwd(x, lbl, cw, torch.tensor(97.0, device="cuda"),
                                        torch.tensor(1.0, device="cuda"))
        out[layout] = (port_ce.fused_binary_ce_fwd(x, lbl, cw), d)
    torch.cuda.synchronize()
    assert torch.equal(out["channels_last"][1], out["strided"][1])
    assert torch.equal(out["nchw"][1], out["strided"][1])
    x, lbl, cw = _layout_case("channels_last", dtype, torch.int32, seed=22)
    assert not port_ce.fused_binary_ce_fwd(x, torch.full_like(lbl, 255), cw).any()
    assert torch.equal(port_ce.fused_binary_ce_fwd(x, lbl, cw), out["channels_last"][0])
