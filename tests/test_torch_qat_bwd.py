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
  over x's whole extent; the data gradient split by output parity
  (:func:`dgrad_classes`, the card's route at a stride above 1: each class a
  stride-1 conv of the undilated cotangent over its taps) equal to the plain
  dgrad.
- One float64 ResNet-18 step with ``int8_training_bwd`` against the JAX
  package's at 1e-6 of each tensor's largest update (``test_torch_qat``'s
  method: the QAT quantizes in float32 on both sides).
- The weight gradient's ``wgmma`` body without a card: its planar copies'
  plain version against the codes permuted, and its schedule (the plan's
  boxes, tap shifts, skipped stages, work items and tiles, each TMA box read
  with its out-of-bounds zero fill) walked in int64 at reduced copies of a
  ResNet-50 step's 25 distinct weight-gradient geometries, equal to the
  plain weight gradient.
- The data gradient's launch without a card: its schedule (each block's
  parity class, output rectangle, tap-skipped taps, K stages, splits and
  channel tile, and the epilogue's strided rows of dx) walked in int64 at
  reduced copies of the same 25 site geometries (its 49 calls), an odd
  extent and forced K splits, equal to the plain dgrad; the weight prep's
  plain layout against ``quantize_weight_rotated``.

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
    OIHW), and the card's route for the dgrad at a stride above 1 (each
    output parity class of :func:`dgrad_classes` a stride-1 conv of the
    undilated cotangent over its taps; at 1 the dense conv at
    ``dgrad_geometry``) gives the same."""
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
    # the card's route: the parity classes, each over the undilated g
    if s == 1:
        geo = kc.dgrad_geometry(g_q.shape, w_rot.shape, (h, w), s, p, d)
        assert (geo["Ho"], geo["Wo"]) == (h, w)
        route = kc.conv_s8_plain(g_q, w_rot, torch.ones(c), 1.0, None, 1, geo["pads"],
                                 (geo["dh"], geo["dw"]))
        assert kc.as_rows(geo) is geo or (k, p) == (1, 0)
    else:
        classes = kc.dgrad_classes(k, (h, w), s, p, d)
        assert len(classes) == s * s and sum(len(cl["taps"]) for cl in classes) == k * k
        route = torch.full((b, h, w, c), 7, dtype=torch.float32)
        gp = F.pad(g_q.long(), (0, 0, 0, 2 * w, 0, 2 * h))  # reads past g: zeros
        for cl in classes:
            acc = torch.zeros((b, cl["Hc"], cl["Wc"], c), dtype=torch.int64)
            for i, j, dy, dx_ in cl["taps"]:
                part = torch.roll(gp, (-dy, -dx_), (1, 2))[:, :cl["Hc"], :cl["Wc"]]
                acc += part @ w_rot[:, i, j, :].long().T
            route[:, cl["a"]::s, cl["b"]::s] = acc.float()
    assert torch.equal(route, got)


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


# --------------------------------------- the weight gradient's wgmma body
# The distinct weight-gradient geometries of a ResNet-50 int8-backward step
# at 512^2 (H, W of x, C, N, k, stride, pad, dilation): layer1-4, the ASPP
# branches and pooled part (M = 8), the projection's parts, the decoder.
WGRAD_SITES = (
    (1, 1, 256, 256, 1, 1, 0, 1), (1, 1, 2048, 256, 1, 1, 0, 1), (32, 32, 256, 256, 1, 1, 0, 1),
    (32, 32, 256, 256, 3, 1, 1, 1), (32, 32, 256, 1024, 1, 1, 0, 1),
    (32, 32, 512, 512, 3, 1, 1, 1), (32, 32, 512, 512, 3, 1, 2, 2),
    (32, 32, 512, 2048, 1, 1, 0, 1), (32, 32, 1024, 256, 1, 1, 0, 1),
    (32, 32, 1024, 512, 1, 1, 0, 1), (32, 32, 1024, 2048, 1, 1, 0, 1),
    (32, 32, 2048, 256, 1, 1, 0, 1), (32, 32, 2048, 256, 3, 1, 6, 6),
    (32, 32, 2048, 256, 3, 1, 12, 12), (32, 32, 2048, 256, 3, 1, 18, 18),
    (32, 32, 2048, 512, 1, 1, 0, 1), (64, 64, 256, 256, 3, 2, 1, 1),
    (64, 64, 512, 128, 1, 1, 0, 1), (64, 64, 512, 256, 1, 1, 0, 1),
    (64, 64, 512, 1024, 1, 2, 0, 1), (128, 128, 256, 48, 1, 1, 0, 1),
    (128, 128, 256, 64, 1, 1, 0, 1), (128, 128, 256, 128, 1, 1, 0, 1),
    (128, 128, 256, 256, 3, 1, 1, 1), (128, 128, 256, 512, 1, 2, 0, 1))


def _narrow(c: int) -> int:
    """A reduced channel count: an eighth above 64, as it is up to 64."""
    return c // 8 if c > 64 else c


def _tma_box(t, x0, r0, rows):
    """A 2-D TMA box of t [rows, len] (the map's extents) at (x0, r0): 128
    bytes x ``rows`` int64, zeros past the map's rows."""
    out = torch.zeros((rows, 128), dtype=torch.int64)
    rb = min(r0 + rows, t.shape[0])
    if r0 < rb:
        out[:rb - r0] = t[r0:rb, x0:x0 + 128]
    return out


def _walk_wgmma_schedule(x_q, g_q, geo):
    """dw's int32 sums [N, C, KH, KW] as the wgmma body forms them: each
    block (tap, work item, tile) walks its stages, one 128-byte box of each
    operand a stage from g's planar copy and x's copy for the tap through the
    two maps, and adds its int64 products into the tap's sums, wrapped to
    int32 at the end (the atomic int32 adds wrap, in any order).  Every box
    lies inside its image's copy (the margins hold every row a stage reads)."""
    p = kc.wgrad_plan(geo)
    b_, n, c = geo["B"], geo["N"], geo["C"]
    xt = kc.planar_plain(x_q, geo).reshape(c, -1).long()
    gt = kc.planar_plain(g_q, geo, cotangent=True).reshape(n, -1).long()
    a_map, b_map = (xt, gt) if p["x_is_a"] else (gt, xt)
    m_ext, j_ext = (c, n) if p["x_is_a"] else (n, c)
    bm, bn, np_, pitch = p["bm"], p["bn"], len(p["planes"]), p["pitch"]
    copy, image = p["hc"] * pitch, p["ho_pad"] * pitch  # bytes of an x copy, of a g image
    sums = torch.zeros((len(p["taps"]), m_ext, j_ext), dtype=torch.int64)
    for tap, (shift_y, plane, rg_lo, nrg, cc_lo, ncc, item0, items) in enumerate(p["taps"]):
        stages = b_ * nrg * ncc
        assert (item0, items) == (tap * p["splits"], p["splits"])
        for split in range(items):  # an item of a short tap may hold no stage
            s0, s1 = split * stages // items, (split + 1) * stages // items
            for mt in range(p["m_tiles"]):
                for jt in range(p["j_tiles"]):
                    acc = torch.zeros((bm, bn), dtype=torch.int64)
                    for st in range(s0, s1):
                        b, rest = divmod(st, nrg * ncc)
                        oy, ox = (rg_lo + rest // ncc) * p["rows"], (cc_lo + rest % ncc) * p["tw"]
                        g_at = (b * p["ho_pad"] + oy) * pitch + ox
                        x_at = (((b * np_ + plane) * p["hc"] + oy + shift_y + p["margin"]) * pitch
                                + ox)
                        z = b * np_ + plane
                        assert z * copy <= x_at and x_at + 128 <= (z + 1) * copy
                        assert b * image <= g_at and g_at + 128 <= (b + 1) * image
                        a_at, b_at = (x_at, g_at) if p["x_is_a"] else (g_at, x_at)
                        acc += _tma_box(a_map, a_at, mt * bm, bm) @ _tma_box(b_map, b_at,
                                                                             jt * bn, bn).T
                    m0, j0 = mt * bm, jt * bn
                    m1, j1 = min(m0 + bm, m_ext), min(j0 + bn, j_ext)
                    sums[tap, m0:m1, j0:j1] += acc[:m1 - m0, :j1 - j0]
    sums = sums.permute(1, 2, 0)
    if p["x_is_a"]:
        sums = sums.transpose(0, 1)
    return kc._wrap_int32(sums.double()).reshape(n, c, geo["KH"], geo["KW"])


def test_planar_copies_plain_are_the_codes_permuted():
    """The planar copies' plain version: g's [N, B, Ho', pitch] the codes
    permuted (zeros past Ho and Wo); x's at stride 1 the same between its
    zero margin rows, one copy a column shift of a 3x3, shifted; at stride 2
    the parity planes."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 9, 13, 32)).astype(np.float32))
    x_q = kc.quantize_s8_plain(x, torch.tensor(2.5))
    geo = kc.conv_geometry(x_q.shape, (16, 1, 1, 32), 1, 0, 1)
    p = kc.wgrad_plan(geo)
    assert (p["pitch"], p["rows"], p["margin"], p["hc"], p["ho_pad"]) == (32, 4, 3, 15, 12)
    assert p["planes"] == ((0, 0, 0),)
    codes = x_q.permute(3, 0, 1, 2)
    want = torch.zeros((32, 2, 15, 32), dtype=torch.int8)
    want[:, :, 3:12, :13] = codes
    assert torch.equal(kc.planar_plain(x_q, geo), want)
    want_g = torch.zeros((16, 2, 12, 32), dtype=torch.int8)
    want_g[:, :, :9, :13] = codes[:16]
    assert torch.equal(kc.planar_plain(x_q[..., :16], geo, cotangent=True), want_g)
    geo = kc.conv_geometry(x_q.shape, (16, 3, 3, 32), 1, 1, 1)
    assert kc.wgrad_plan(geo)["planes"] == ((0, 0, -1), (0, 0, 0), (0, 0, 1))
    copies = kc.planar_plain(x_q, geo).reshape(32, 2, 3, 15, 32)
    assert torch.equal(copies[:, :, 0, 3:12, 1:14], codes)  # s = -1: column u holds x' = u - 1
    assert torch.equal(copies[:, :, 2, 3:12, :12], codes[..., 1:])  # s = 1: x' = u + 1
    assert int(copies[:, :, :, :3].abs().sum() + copies[:, :, :, 12:].abs().sum()) == 0
    geo = kc.conv_geometry(x_q.shape, (16, 3, 3, 32), 2, 1, 1)
    p = kc.wgrad_plan(geo)
    planes = kc.planar_plain(x_q, geo).reshape(32, 2, len(p["planes"]), p["hc"], 32)
    for i, (py, px, sx) in enumerate(p["planes"]):
        part = x_q[:, py::2, px::2].permute(3, 0, 1, 2)[..., max(0, sx):]
        u0, m = max(0, -sx), p["margin"]
        assert torch.equal(planes[:, :, i, m:m + part.shape[2], u0:u0 + part.shape[3]], part)


@pytest.mark.parametrize("site", WGRAD_SITES)
def test_wgmma_schedule_walk_equals_plain(site):
    """The wgmma body's schedule, walked in int64 on the CPU at a reduced
    copy of each site (B = 1, narrow channels, the real map, kernel, stride,
    padding and dilation), equals the plain weight gradient bit for bit; the
    pooled part (M = 8) is the mma body's, every other site the wgmma one's."""
    h, w, c, n, k, s, p, d = site
    c, n = _narrow(c), _narrow(n)
    rng = np.random.default_rng(h + c + n + k + s + p + d)
    geo = kc.conv_geometry((1, h, w, c), (n, k, k, c), s, p, d)
    assert kc.wgrad_body(geo) == ("mma" if h == 1 else "wgmma")
    x_q = torch.from_numpy(rng.integers(-127, 128, (1, h, w, c)).astype(np.int8))
    g_q = torch.from_numpy(rng.integers(-127, 128, (1, geo["Ho"], geo["Wo"], n)).astype(np.int8))
    x_amax, g_amax = torch.tensor(3.5), torch.tensor(0.75)
    got = _walk_wgmma_schedule(x_q, g_q, geo).float() * kc.product_scale(x_amax, g_amax)
    want = kc.conv_s8_wgrad_plain(x_q, g_q, x_amax, g_amax, k, s, p, d)
    assert torch.equal(got, want)


# ------------------------------------------- the data gradient's launch
def _walk_dgrad_launch(g_q, w_rows, lay):
    """dx's int32 sums [B, H, W, C] as the card's launch forms them
    (:func:`kc.dgrad_launch`): every block (class, image, output rectangle,
    K split, channel tile) lists the taps that read inside g for a pixel of
    its rectangle, walks the K' bytes of its split's 128-byte stages (a
    valid tap's channels after another's), sums its products in int64 and
    writes its rows (a class's pixel (u, v) is dx's (a + u sh, b + v sw));
    wrapped to int32 at the end, as the int32 adds wrap in any order.  Each
    pixel of dx is written once by each split."""
    geo, p = lay["geom"], lay["plan"]
    bsz, cg, n_out = geo["B"], geo["C"], geo["N"]
    g = F.pad(g_q, (0, cg - g_q.shape[3])).reshape(bsz, geo["H"], geo["W"], cg).long()
    w = w_rows.long()
    tw, bn, splits = p["tw"], p["bn"], p["splits"]
    th = 128 // tw
    if lay["parity"]:
        sh, sw = (lay["c_parity"][1], lay["c_parity"][2])
        h_out, w_out = geo["Ho"], geo["Wo"]
        classes = [(cl["a"], cl["b"], cl["Hc"], cl["Wc"], 1, 1,
                    [(dy, dx, (i * geo["KW"] + j) * cg) for i, j, dy, dx in cl["taps"]])
                   for cl in lay["classes"]]
    else:
        sh = sw = 1
        h_out, w_out = geo["Ho"], geo["Wo"]
        taps = [(kh * geo["dh"] - geo["ph"], kw * geo["dw"] - geo["pw"], (kh * geo["KW"] + kw) * cg)
                for kh in range(geo["KH"]) for kw in range(geo["KW"])]
        classes = [(0, 0, h_out, w_out, geo["sh"], geo["sw"], taps)]
    sums = torch.zeros((bsz, h_out, w_out, n_out), dtype=torch.int64)
    writes = torch.zeros((bsz, h_out, w_out), dtype=torch.int64)

    def hits(o0, o1, s, off, size):  # the kernel's axis_hits
        lo = 0 if off >= 0 else (-off + s - 1) // s
        return size - 1 - off >= 0 and max(lo, o0) <= min((size - 1 - off) // s, o1)

    for a, b_, hc, wc, s_y, s_x, taps in classes:
        for bi, ty, tx in itertools.product(range(bsz), range(-(-hc // th)), range(-(-wc // tw))):
            oy0, ox0 = ty * th, tx * tw
            oy1, ox1 = min(oy0 + th, hc) - 1, min(ox0 + tw, wc) - 1
            valid = [t for t in taps if hits(oy0, oy1, s_y, t[0], geo["H"])
                     and hits(ox0, ox1, s_x, t[1], geo["W"])]
            r = torch.arange(128)
            oy, ox = oy0 + r // tw, ox0 + r % tw
            inside = (oy < hc) & (ox < wc)
            a_cols = []
            for dy, dx, _ in valid:  # the A tile's columns: each valid tap's channels
                iy, ix = oy * s_y + dy, ox * s_x + dx
                ok = inside & (iy >= 0) & (iy < geo["H"]) & (ix >= 0) & (ix < geo["W"])
                a_cols.append(torch.where(ok[:, None], g[bi, iy.clamp(0, geo["H"] - 1),
                                                         ix.clamp(0, geo["W"] - 1)], 0))
            k_all = len(valid) * cg
            a_tile = torch.cat(a_cols, 1) if a_cols else torch.zeros((128, 0), dtype=torch.int64)
            b_tile = (torch.cat([w[:, kofs:kofs + cg] for _, _, kofs in valid], 1) if valid
                      else torch.zeros((n_out, 0), dtype=torch.int64))
            steps = -(-k_all // 128)
            rows_y, rows_x = a + oy[inside] * sh, b_ + ox[inside] * sw  # dx's pixels
            for split in range(splits):
                k0, k1 = split * steps // splits * 128, min((split + 1) * steps // splits * 128,
                                                            k_all)
                acc = a_tile[:, k0:k1] @ b_tile[:, k0:k1].T  # every channel tile at once
                sums[bi, rows_y, rows_x] += acc[inside]
                writes[bi, rows_y, rows_x] += 1
        assert a < sh and b_ < sw
    assert bool((writes == splits).all())
    if lay["parity"]:
        return kc._wrap_int32(sums.double())
    return kc._wrap_int32(sums.double()).reshape(g_q.shape[0], *lay["x_hw"], n_out)


DGRAD_SITES = WGRAD_SITES + ((33, 17, 64, 96, 3, 2, 1, 1),)  # ... and an odd extent


# the split's halo geometries (``parallel/spatial.py``: a rank's rows with
# their halo, run at H padding 0), ResNet-50's routed 3x3s at crop 512 on a
# model axis of 2: layer3.0's strided one (33 rows), a layer3 one, a dilated
# layer4 one, the ASPP's three (at d = 18 the halo is taller than a shard)
HALO_SITES = ((33, 64, 256, 256, 3, 2, (0, 1), 1), (18, 32, 256, 256, 3, 1, (0, 1), 1),
              (20, 32, 512, 512, 3, 1, (0, 2), 2), (28, 32, 2048, 256, 3, 1, (0, 6), 6),
              (40, 32, 2048, 256, 3, 1, (0, 12), 12), (52, 32, 2048, 256, 3, 1, (0, 18), 18))


@pytest.mark.parametrize("site", HALO_SITES)
def test_backward_walks_at_a_halo_geometry(site):
    """Both gradients' plans at a halo geometry (H padding 0, W padding p,
    odd or halo-extended heights; at a stride of 2 the parity split), walked
    as the two tests above walk them, equal the plain versions bit for
    bit."""
    h, w, c, n, k, s, p, d = site
    c, n = _narrow(c), _narrow(n)
    rng = np.random.default_rng(h + c + n)
    geo = kc.conv_geometry((1, h, w, c), (n, k, k, c), s, p, d)
    assert kc.wgrad_body(geo) == "wgmma"
    x_q = torch.from_numpy(rng.integers(-127, 128, (1, h, w, c)).astype(np.int8))
    g_q = torch.from_numpy(rng.integers(-127, 128, (1, geo["Ho"], geo["Wo"], n)).astype(np.int8))
    x_amax, g_amax = torch.tensor(3.5), torch.tensor(0.75)
    got = _walk_wgmma_schedule(x_q, g_q, geo).float() * kc.product_scale(x_amax, g_amax)
    assert torch.equal(got, kc.conv_s8_wgrad_plain(x_q, g_q, x_amax, g_amax, k, s, p, d))
    w_rows, w_amax = kc.rotated_weight_codes(
        torch.from_numpy(rng.normal(size=(n, c, k, k)).astype(np.float32)), s)
    lay = dict(kc.dgrad_launch(g_q.shape, c, k, (h, w), s, p, d), x_hw=(h, w))
    assert lay["parity"] == (s == 2) and lay["body"] == "wgmma"
    got = _walk_dgrad_launch(g_q, w_rows, lay).float() * kc.product_scale(g_amax, w_amax)
    assert torch.equal(got, kc.conv_s8_dgrad_plain(g_q, w_rows, g_amax, w_amax, (h, w), s, p,
                                                   d, kernel_size=k))


@pytest.mark.parametrize("site,plan", [(s, None) for s in DGRAD_SITES]
                         + [(DGRAD_SITES[16], (32, 64, 4, 4)), (DGRAD_SITES[4], (64, 128, 3, 2))])
def test_dgrad_launch_walk_equals_plain(site, plan):
    """The card's data gradient as :func:`kc.dgrad_launch` plans it, walked
    in int64 on the CPU at a reduced copy of each site (B = 1, 8 at the
    pooled part's 1 x 1 maps; narrow channels; the real map, kernel, stride,
    padding and dilation), equals the plain dgrad bit for bit: the three
    stride-2 sites and the odd extent through the parity classes (every
    class of a 1x1 of stride 2 but one writes zeros), the others through the
    dense conv at the transpose geometry; two sites also under forced K
    splits."""
    h, w, c, n, k, s, p, d = site
    c, n = _narrow(c), _narrow(n)
    b = 8 if h == 1 else 1
    rng = np.random.default_rng(h + c + n + k + s + p + d)
    geo = kc.conv_geometry((b, h, w, c), (n, k, k, c), s, p, d)
    g_q = torch.from_numpy(rng.integers(-127, 128, (b, geo["Ho"], geo["Wo"], n)).astype(np.int8))
    w_f = torch.from_numpy(rng.normal(size=(n, c, k, k)).astype(np.float32))
    w_rows, w_amax = kc.rotated_weight_codes(w_f, s)
    lay = dict(kc.dgrad_launch(g_q.shape, c, k, (h, w), s, p, d, plan=plan), x_hw=(h, w))
    assert lay["parity"] == (s == 2) and lay["body"] == "wgmma"
    if s == 2:
        assert len(lay["classes"]) == 4 and sum(len(cl["taps"]) for cl in lay["classes"]) == k * k
    g_amax = torch.tensor(0.75)
    got = _walk_dgrad_launch(g_q, w_rows, lay).float() * kc.product_scale(g_amax, w_amax)
    want = kc.conv_s8_dgrad_plain(g_q, w_rows, g_amax, w_amax, (h, w), s, p, d,
                                  kernel_size=k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(12, 8, 3, 3, 1), (10, 6, 3, 3, 2), (32, 24, 1, 1, 2)])
def test_rotated_weight_codes_plain_is_quantize_weight_rotated(shape):
    """The weight prep's plain version: ``quantize_weight_rotated``'s codes as
    the dense body's rows [C, ldw], N padded to 16 with zeros at a stride of
    2 (N = 10), the rows to a multiple of 16, the same amax; and the rows
    read back as the rotated codes by the plain dgrad."""
    n, c, kh, kw, s = shape
    rng = np.random.default_rng(n + c + s)
    w = torch.from_numpy(rng.normal(size=(n, c, kh, kw)).astype(np.float32)).to(torch.bfloat16)
    rows, amax = kc.rotated_weight_codes(w, s)
    codes, want_amax = pt.quantize_weight_rotated(w)
    np_ = kc.dgrad_channels(n, s)
    assert np_ == (-(-n // 16) * 16 if s == 2 else n)
    ldw = -(-kh * kw * np_ // 16) * 16
    want = torch.zeros((c, ldw), dtype=torch.int8)
    want[:, :kh * kw * np_] = F.pad(codes, (0, np_ - n)).reshape(c, -1)
    assert torch.equal(rows, want) and torch.equal(amax, want_amax)
    assert torch.equal(kc._rotated_codes(rows, (kh, kw), n, s), codes)


# -------------------------------------------------------------- on the card
# (B, H, W, C, N, k, stride, pad, dilation): ResNet-50's three stride-2
# sites, an odd map, the pooled part (M = 8), a narrow N for the bytewise
# dgrad body, channels no multiple of 4 for the wgrad's padded route, the
# ASPP branch at d = 18 on its 32^2 map (taps and stages wholly in the
# padding), the 1x1s with N = 48 and 64 (the wgmma body's 64-row tiles)
CUDA_SHAPES = ((8, 128, 128, 256, 512, 1, 2, 0, 1), (8, 64, 64, 256, 256, 3, 2, 1, 1),
               (2, 33, 17, 64, 96, 3, 2, 1, 1), (8, 1, 1, 256, 256, 1, 1, 0, 1),
               (2, 16, 16, 256, 24, 3, 1, 6, 6), (2, 9, 7, 6, 10, 3, 1, 1, 1),
               (8, 32, 32, 512, 512, 3, 1, 2, 2), (8, 32, 32, 2048, 256, 3, 1, 18, 18),
               (8, 128, 128, 256, 48, 1, 1, 0, 1), (8, 128, 128, 256, 64, 1, 1, 0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_backward_entries_bit_equal(shape):
    """conv_s8_dgrad and conv_s8_wgrad equal their plain versions in float32
    and bf16, at a positive and a zero cotangent amax, the data gradient with
    its rotated codes as given and as ``rotated_weight_codes`` makes them on
    the card (equal to its plain version, OIHW and channels-last kernels);
    the launches count: the weight gradient's by the body
    :func:`kc.wgrad_body` picks, the data gradient's strided ones as parity
    launches (no zeros inserted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, n, k, s, p, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    geo = kc.conv_geometry((b, h, w, c), (n, k, k, c), s, p, d)
    x_q = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda").to(torch.int8)
    g = torch.randn((b, geo["Ho"], geo["Wo"], n), generator=gen, device="cuda")
    w_rot = torch.randint(-127, 128, (c, k, k, n), generator=gen, device="cuda").to(torch.int8)
    w_f = torch.randn((n, c, k, k), generator=gen, device="cuda").to(torch.bfloat16)
    x_amax, w_amax = torch.tensor(3.5, device="cuda"), torch.tensor(0.25, device="cuda")
    body = kc.wgrad_body(geo)
    assert body == ("mma" if h * w == 1 or n == 24 or c == 6 else "wgmma")
    for wt in (w_f, w_f.contiguous(memory_format=torch.channels_last), w_f.float()):
        before = kc.launches_rotated
        rows, rows_amax = kc.rotated_weight_codes(wt, s)
        want_rows, want_amax = kc.rotated_weight_codes_plain(wt, s)
        assert torch.equal(rows, want_rows) and torch.equal(rows_amax, want_amax)
        assert kc.launches_rotated == before + 1
    for g_amax in (pt.activation_amax(g), torch.zeros((), device="cuda")):
        g_q = kc.quantize_s8(g, g_amax)
        before = (kc.launches_dgrad, kc.launches_dgrad_by_body["parity"], kc.launches_wgrad,
                  kc.launches_wgrad_by_body[body])
        for dt in (torch.float32, torch.bfloat16):
            got = kc.conv_s8_dgrad(g_q, w_rot, g_amax, w_amax, (h, w), s, p, d, out_dtype=dt)
            want = kc.conv_s8_dgrad_plain(g_q, w_rot, g_amax, w_amax, (h, w), s, p, d,
                                          out_dtype=dt)
            assert got.dtype == dt and torch.equal(got, want), ("dgrad", dt)
            got = kc.conv_s8_dgrad(g_q, rows, g_amax, rows_amax, (h, w), s, p, d, out_dtype=dt,
                                   kernel_size=k)
            want = kc.conv_s8_dgrad_plain(g_q, rows, g_amax, rows_amax, (h, w), s, p, d,
                                          out_dtype=dt, kernel_size=k)
            assert got.dtype == dt and torch.equal(got, want), ("dgrad from rows", dt)
            got = kc.conv_s8_wgrad(x_q, g_q, x_amax, g_amax, k, s, p, d, out_dtype=dt)
            want = kc.conv_s8_wgrad_plain(x_q, g_q, x_amax, g_amax, k, s, p, d, out_dtype=dt)
            assert got.dtype == dt and torch.equal(got, want), ("wgrad", dt)
        torch.cuda.synchronize()
        assert (kc.launches_dgrad, kc.launches_dgrad_by_body["parity"], kc.launches_wgrad,
                kc.launches_wgrad_by_body[body]) == (
            before[0] + 4, before[1] + 4 * (s == 2), before[2] + 2, before[3] + 2)
