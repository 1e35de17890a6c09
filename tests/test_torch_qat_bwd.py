"""The int8 backward of quantization-aware training (``int8_bwd``) against the
JAX package's ``iswm_tpu/ops/int8_train.py`` (``int8_conv_fullq``,
``int8_conv_fullq_static``, ``_dil_bwd``), on the CPU (the kernels' plain
versions).

- Planted integer grids (every scale exactly 1, so that quantizing loses
  nothing): the output, dx and dw of ``int8_conv_fullq`` bit-equal to the
  dense conv's VJP across k in {1, 3}, stride {1, 2}, dilation {1, 2, 3} on a
  10 x 9 map, and of ``int8_dilated_conv3x3(..., int8_bwd=True)`` at d = 1,
  2, 3, 6 (``tests/test_int8_train.py``'s two grids; the dense VJP in
  float64, exact on these integers).
- Random inputs: the three functions' outputs and gradients bit-equal to the
  JAX package's in float32 (compiled with ``IEEE_XLA``, which divides ``amax
  / 127.0`` as written: the int32 sums are exact and every float step is the
  same IEEE operation).
- The plain versions against the dense VJP at odd extents and stride 2, dx
  over x's whole extent; the dense conv at :func:`dgrad_geometry` over the
  zero-inserted cotangent (the card's route) equal to the plain dgrad.
- One float64 ResNet-18 step with ``int8_training_bwd`` against the JAX
  package's at 1e-6 of each tensor's largest update (``test_torch_qat``'s
  method: the QAT quantizes in float32 on both sides).

The ``cuda`` cases hold each entry bit-equal to its plain version on the card,
where this file runs alone without jax:
``python -m pytest --noconftest tests/test_torch_qat_bwd.py -m cuda``.
"""

import copy
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iswm_tpu_torch.ops import int8_train as pt
from iswm_tpu_torch.ops.kernels import int8_conv as kc

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)
from .test_torch_qat import IEEE_XLA, QAT, _jax_step64


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _planted(rng, shape):
    """Integers in [-126, 126] with a 127 planted: amax 127, scale 1."""
    a = rng.integers(-126, 127, shape).astype(np.float32)
    a.flat[0] = 127.0
    return a


def _dense_vjp(x, w, g, s, p, d):
    """(out, dx, dw) of the dense conv and its VJP in NHWC / HWIO at the
    cotangent g, in float64 (exact on these integers), as float32."""
    xt, wt, gt = _nchw(x).double(), _oihw(w).double(), _nchw(g).double()
    out = F.conv2d(xt, wt, None, s, p, d)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gt, xt, wt, None, [s, s], [p, p], [d, d], False, [0, 0], 1, [True, True, False])
    return _nhwc(out.float()), _nhwc(dx.float()), dw.float().permute(2, 3, 1, 0).numpy()


def _jax_vjp(fn, *args):
    """(out, d args...) of a JAX function at the cotangent (the last of
    ``args``), compiled once with ``IEEE_XLA`` (the division by 127 as
    written)."""
    import jax

    def run(*a):
        out, vjp = jax.vjp(fn, *a[:-1])
        return (out, *vjp(a[-1]))

    compiled = jax.jit(run).lower(*args).compile(compiler_options=IEEE_XLA)
    return tuple(np.asarray(t) for t in compiled(*args))


def _out_hw(h, w, k, s, p, d):
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1 for n in (h, w))


def _port(fn, x, w, g):
    """(out, dx, dw) of a port function of (x, w) in NHWC / HWIO."""
    xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
    out = fn(xt, wt)
    out.backward(_nchw(g))
    return _nhwc(out), _nhwc(xt.grad), wt.grad.permute(2, 3, 1, 0).numpy()


# ------------------------------------------------------------ planted grids
GRID = [(k, s, d) for k, s, d in itertools.product((1, 3), (1, 2), (1, 2, 3))
        if k == 3 or d == 1]


@pytest.mark.parametrize("k,s,d", GRID)
def test_int8_conv_fullq_exact_on_grid(k, s, d):
    """``tests/test_int8_train.py``'s grid: with every scale 1 the int8
    forward and backward are the dense conv and its VJP, bit for bit."""
    rng = np.random.default_rng(7)
    p = (k // 2) * d
    x, w = _planted(rng, (2, 10, 9, 4)), _planted(rng, (k, k, 4, 6))
    w[0, 0, 0, :] = 127.0  # per-O scales 1 too
    g = _planted(rng, (2, *_out_hw(10, 9, k, s, p, d), 6))
    want = _dense_vjp(x, w, g, s, p, d)
    got = _port(lambda x, w: pt.int8_conv_fullq(x, w, s, p, d), x, w, g)
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_int8_dilated_conv3x3_bwd_exact_on_grid(d):
    """The valid-tap atrous conv's int8 backward (``_dil_bwd``) on the
    planted grid: the dense dilated conv's VJP, bit for bit; at d = 6 some
    taps lie wholly in the padding of the 10 x 9 map."""
    rng = np.random.default_rng(13)
    x, w = _planted(rng, (2, 10, 9, 4)), _planted(rng, (3, 3, 4, 6))
    w[0, 0, 0, :] = 127.0
    g = _planted(rng, (2, 10, 9, 6))
    dense = _dense_vjp(x, w, g, 1, d, d)
    got = _port(lambda x, w: pt.int8_dilated_conv3x3(x, w, d, int8_bwd=True), x, w, g)
    for name, a, b in zip(("out", "dx", "dw"), got, dense):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------ random vs the JAX side
RANDOM = [(3, 1, 1, 1), (3, 2, 1, 1), (1, 2, 0, 1), (3, 1, 2, 2), (1, 1, 0, 1)]  # k, s, p, d


@pytest.mark.parametrize("k,s,p,d", RANDOM)
def test_int8_conv_fullq_matches_jax(k, s, p, d):
    """Random activations, weights and cotangent on an odd map: output, dx
    and dw bit-equal to ``int8_conv_fullq``'s in float32."""
    from iswm_tpu.ops.int8_train import int8_conv_fullq

    rng = np.random.default_rng(21 + k + s + d)
    x = rng.normal(size=(2, 11, 9, 32)).astype(np.float32)
    w = (rng.normal(size=(k, k, 32, 16)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, *_out_hw(11, 9, k, s, p, d), 16)).astype(np.float32)
    want = _jax_vjp(lambda x, w: int8_conv_fullq(x, w, (s, s), ((p, p), (p, p)), (d, d)),
                    x, w, g)
    got = _port(lambda x, w: pt.int8_conv_fullq(x, w, s, p, d), x, w, g)
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_int8_conv_fullq_static_matches_jax():
    """The delayed form at a warm, a stale and a zero amax (scale 1): output,
    new amax and both gradients bit-equal; no gradient reaches the amax."""
    import jax

    from iswm_tpu.ops.int8_train import int8_conv_fullq_static

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 12, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 32, 16)) * 0.05).astype(np.float32)
    g = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)

    def run(x, w, a, g):
        out, vjp, new = jax.vjp(lambda x, w: int8_conv_fullq_static(
            x, w, a, (2, 2), ((1, 1), (1, 1)), (1, 1)), x, w, has_aux=True)
        return (out, new, *vjp(g))

    warm = np.abs(x).max()
    compiled = jax.jit(run).lower(x, w, warm, g).compile(compiler_options=IEEE_XLA)
    for amax in (warm, warm * np.float32(0.5), np.float32(0.0)):
        out, new, gx, gw = compiled(x, w, amax, g)
        a = np.float32(amax)
        at = torch.tensor(a)
        xt, wt = _nchw(x).requires_grad_(), _oihw(w).requires_grad_()
        got, got_new = pt.int8_conv_fullq_static(xt, wt, at, 2, 1, 1)
        got.backward(_nchw(g))
        np.testing.assert_array_equal(_nhwc(got), np.asarray(out))
        assert got_new.dtype == torch.float32 and float(got_new) == float(new)
        np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(gx))
        np.testing.assert_array_equal(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gw))
        assert at.grad is None


def test_int8_dilated_conv3x3_bwd_matches_jax():
    """``int8_dilated_conv3x3(..., True)`` on random inputs at d = 2 and 6:
    bit-equal gradients (dx: a conv of g_q with the rotated per-tensor codes;
    dw: the per-tap products over the valid windows)."""
    from iswm_tpu.ops.int8_train import int8_dilated_conv3x3

    rng = np.random.default_rng(5)
    for d in (2, 6):
        x = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
        w = (rng.normal(size=(3, 3, 16, 8)) * 0.1).astype(np.float32)
        g = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
        want = _jax_vjp(lambda x, w: int8_dilated_conv3x3(x, w, d, True), x, w, g)
        got = _port(lambda x, w: pt.int8_dilated_conv3x3(x, w, d, int8_bwd=True), x, w, g)
        for name, a, b in zip(("out", "dx", "dw"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} at d = {d}")


# ------------------------------------------------------------ plain versions
PLAIN = [(2, 11, 9, 8, 12, 3, 2, 1, 1), (1, 10, 7, 4, 8, 1, 2, 0, 1),
         (2, 9, 9, 8, 4, 3, 1, 2, 2), (1, 13, 8, 12, 4, 3, 2, 3, 3), (8, 1, 1, 8, 4, 1, 1, 0, 1)]


@pytest.mark.parametrize("shape", PLAIN)
def test_plain_backward_is_the_dense_vjp(shape):
    """At odd extents and stride 2, with every scale 1: the plain dgrad is
    the dense conv's dx over x's whole extent and the plain wgrad its dw (in
    OIHW), and the card's route for the dgrad (the dense conv over the
    zero-inserted cotangent at ``dgrad_geometry``) gives the same."""
    b, h, w, c, n, k, s, p, d = shape
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_planted(rng, (b, c, h, w)))
    wt = torch.from_numpy(_planted(rng, (n, c, k, k)))
    out = F.conv2d(x.double(), wt.double(), None, s, p, d)
    g = torch.from_numpy(_planted(rng, tuple(out.shape)))
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.double(), x.double(), wt.double(), None, [s, s], [p, p], [d, d], False, [0, 0], 1,
        [True, True, False])
    amax = torch.tensor(127.0)
    x_q, g_q = x.to(torch.int8).permute(0, 2, 3, 1), g.to(torch.int8).permute(0, 2, 3, 1)
    w_rot = wt.to(torch.int8).flip(2, 3).permute(1, 2, 3, 0).contiguous()
    got = kc.conv_s8_dgrad_plain(g_q, w_rot, amax, amax, (h, w), s, p, d)
    assert got.shape == (b, h, w, c)
    assert torch.equal(got.permute(0, 3, 1, 2).double(), dx)
    got_w = kc.conv_s8_wgrad_plain(x_q, g_q, amax, amax, k, s, p, d)
    assert torch.equal(got_w.double(), dw)
    # the card's route: zeros between g's pixels, then the dense conv
    geo = kc.dgrad_geometry(g_q.shape, w_rot.shape, (h, w), s, p, d)
    assert (geo["Ho"], geo["Wo"]) == (h, w)
    dil = torch.zeros((b, geo["H"], geo["W"], n), dtype=torch.int8)
    dil[:, ::s, ::s] = g_q
    route = kc.conv_s8_plain(dil, w_rot, torch.ones(c), 1.0, None, 1, geo["pads"],
                             (geo["dh"], geo["dw"]))
    assert torch.equal(route, got)
    assert kc.as_rows(geo) is geo or (s, k, p) == (1, 1, 0)


def test_plain_backward_epilogue_and_wrap():
    """The epilogue is ``float(acc) * (a_s * b_s)`` in float32 (the product
    first), each scale ``amax / 127`` or 1 at a zero amax; a sum past int32
    wraps as the int32 accumulator's does."""
    rng = np.random.default_rng(2)
    g_q = torch.from_numpy(rng.integers(-127, 128, (2, 5, 5, 8)).astype(np.int8))
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 5, 5, 4)).astype(np.int8))
    w_rot = torch.from_numpy(rng.integers(-127, 128, (4, 3, 3, 8)).astype(np.int8))
    for a, b in ((torch.tensor(3.7), torch.tensor(0.02)), (torch.tensor(0.0), torch.tensor(5.0))):
        scale = kc.scale_of(a, "cpu") * kc.scale_of(b, "cpu")
        ones = torch.tensor(127.0)
        dx1 = kc.conv_s8_dgrad_plain(g_q, w_rot, ones, ones, (5, 5), 1, 1, 1)
        dx = kc.conv_s8_dgrad_plain(g_q, w_rot, a, b, (5, 5), 1, 1, 1)
        assert torch.equal(dx, dx1 * scale)
        dw1 = kc.conv_s8_wgrad_plain(x_q, g_q, ones, ones, 3, 1, 1, 1)
        dw = kc.conv_s8_wgrad_plain(x_q, g_q, a, b, 3, 1, 1, 1, out_dtype=torch.bfloat16)
        assert dw.dtype == torch.bfloat16 and torch.equal(dw, (dw1 * scale).to(torch.bfloat16))
    big = torch.tensor([2.0**31 + 5, -2.0**31 - 2, 2.0**31 - 1], dtype=torch.float64)
    assert kc._wrap_int32(big).tolist() == [-2**31 + 5, 2**31 - 2, 2**31 - 1]


def _count_backward_entries(mp, calls: list) -> None:
    """Record each call of the two backward entries by name into ``calls``."""
    for name in ("dgrad", "wgrad"):
        fn = getattr(kc, f"conv_s8_{name}")
        mp.setattr(pt, f"conv_s8_{name}",
                   lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))


def test_rows_of_a_one_pixel_cotangent():
    """The cotangent of the ASPP projection's pooled part ([B, N, 1, 1]) may
    come with strides of its size-1 dims that no contiguous layout has: the
    quantize reads it as B rows of N all the same."""
    g = torch.zeros(8, 256, 1, 1).as_strided((8, 256, 1, 1), (256, 1, 1, 1))
    assert kc._rows(g.permute(0, 2, 3, 1)) == (8, 256, 256)
    assert kc._rows(torch.zeros(4, 6, 5, 16)[:, :, :, 2:10]) == (120, 8, 16)
    with pytest.raises(ValueError, match="rows of contiguous channels"):
        kc._rows(torch.zeros(4, 6, 5, 16).permute(0, 2, 1, 3))


def test_int8_bwd_skips_the_dgrad_where_x_needs_no_gradient(monkeypatch):
    """A first layer's input needs no gradient: no dgrad runs for it."""
    calls = []
    _count_backward_entries(monkeypatch, calls)
    x = torch.randn(2, 8, 6, 6)
    w = torch.randn(4, 8, 3, 3, requires_grad=True)
    pt.int8_conv_fullq(x, w, 1, 1, 1).sum().backward()
    assert calls == ["wgrad"] and w.grad is not None
    x.requires_grad_()
    pt.int8_conv_fullq(x, w, 1, 1, 1).sum().backward()
    assert calls == ["wgrad", "dgrad", "wgrad"] and x.grad.shape == x.shape


# ------------------------------------------------- ResNet-18, one float64 step
def test_resnet18_int8_bwd_step_float64_matches_jax():
    """``test_resnet18_qat_step_float64_matches_jax``'s method with
    ``int8_training_bwd`` in dynamic mode: one step from the same weights on
    both sides (the port's seeded ones, BatchNorm perturbed, read by the JAX
    package's importer), each parameter's update within 1e-6 of its
    largest."""
    from iswm_tpu.compat.torch_import import import_torch_state_dict
    from iswm_tpu_torch.config import ModelConfig, OptimConfig
    from iswm_tpu_torch.data import generate_scene, normalize
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.models.layers import BatchNorm2d, routed_sites
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    fields = {"int8_scale_mode": "dynamic", "int8_training_bwd": True}
    model = build_model(ModelConfig(compute_dtype="float32", **QAT, **fields))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(1.0 + 0.2 * rng.normal(size=c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.normal(size=c)))
                m.running_var.copy_(torch.from_numpy(0.5 + rng.random(size=c)))
    params, stats = import_torch_state_dict(model.state_dict(), backbone="resnet18")
    rng = np.random.default_rng(1)
    images, labels = zip(*(generate_scene(rng, size=(32, 32)) for _ in range(8)))
    images = normalize(torch.from_numpy(np.stack(images)).float() / 255.0).numpy()
    labels = np.stack(labels).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255
    optim, total = OptimConfig(), 50
    _, want = _jax_step64({**QAT, **fields}, params, stats, {}, images.astype(np.float64),
                          labels, optim, total)

    model = copy.deepcopy(model).to(torch.float64)
    model.compute_dtype = torch.float64
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    factory, _ = make_optimizer(optim, total)
    tstate = TrainState(model, *factory(model.parameters()), 0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm2d, "forward", lambda self, x: F.batch_norm(
            x, None, None, self.weight, self.bias, True, 0.0, self.eps))
        _count_backward_entries(mp, calls)
        make_train_step(make_loss_fn("ce_loss", fused="never"))(
            tstate, torch.from_numpy(images).double(), torch.from_numpy(labels))
    sites = len(routed_sites(model, True))
    assert (calls.count("dgrad"), calls.count("wgrad")) == (sites, sites) and sites > 20
    for k, v in model.named_parameters():
        got = (v.detach() - before[k]).double()
        assert float((got - want[k]).abs().max()) <= 1e-6 * float(want[k].abs().max()), k


# -------------------------------------------------------------- on the card
# (B, H, W, C, N, k, stride, pad, dilation): ResNet-50's three stride-2
# sites, an odd map, the pooled part (M = 8), a narrow N for the bytewise
# dgrad body, channels no multiple of 4 for the wgrad's padded route
CUDA_SHAPES = ((8, 128, 128, 256, 512, 1, 2, 0, 1), (8, 64, 64, 256, 256, 3, 2, 1, 1),
               (2, 33, 17, 64, 96, 3, 2, 1, 1), (8, 1, 1, 256, 256, 1, 1, 0, 1),
               (2, 16, 16, 256, 24, 3, 1, 6, 6), (2, 9, 7, 6, 10, 3, 1, 1, 1),
               (8, 32, 32, 512, 512, 3, 1, 2, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_backward_entries_bit_equal(shape):
    """conv_s8_dgrad and conv_s8_wgrad equal their plain versions in float32
    and bf16, at a positive and a zero cotangent amax; the launches count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, n, k, s, p, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    geo = kc.conv_geometry((b, h, w, c), (n, k, k, c), s, p, d)
    x_q = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda").to(torch.int8)
    g = torch.randn((b, geo["Ho"], geo["Wo"], n), generator=gen, device="cuda")
    w_rot = torch.randint(-127, 128, (c, k, k, n), generator=gen, device="cuda").to(torch.int8)
    x_amax, w_amax = torch.tensor(3.5, device="cuda"), torch.tensor(0.25, device="cuda")
    for g_amax in (pt.activation_amax(g), torch.zeros((), device="cuda")):
        g_q = kc.quantize_s8(g, g_amax)
        before = (kc.launches_dgrad, kc.launches_wgrad)
        for dt in (torch.float32, torch.bfloat16):
            got = kc.conv_s8_dgrad(g_q, w_rot, g_amax, w_amax, (h, w), s, p, d, out_dtype=dt)
            want = kc.conv_s8_dgrad_plain(g_q, w_rot, g_amax, w_amax, (h, w), s, p, d,
                                          out_dtype=dt)
            assert got.dtype == dt and torch.equal(got, want), ("dgrad", dt)
            got = kc.conv_s8_wgrad(x_q, g_q, x_amax, g_amax, k, s, p, d, out_dtype=dt)
            want = kc.conv_s8_wgrad_plain(x_q, g_q, x_amax, g_amax, k, s, p, d, out_dtype=dt)
            assert got.dtype == dt and torch.equal(got, want), ("wgrad", dt)
        torch.cuda.synchronize()
        assert (kc.launches_dgrad, kc.launches_wgrad) == (before[0] + 2, before[1] + 2)
