"""The port's fused bottleneck convs and blocks against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The JAX side
runs ``matmul_bn_stats`` / ``conv3x3_bn_stats`` and ``Bottleneck(fused_mode=
"interpret")`` with its Pallas kernels in interpret mode, as
``tests/test_fused_block.py`` does; the port runs the plain PyTorch versions
(what its wrappers run for a CPU tensor).  Sizes: those of
``tests/test_fused_block.py`` plus an M of two TPU row tiles (4096 > 2048) and a
3x3 with H = 32 (two row tiles, so the halo rows between them are exercised).

Tolerances, each relative to the largest magnitude of the tensor compared:
float32 1e-5 for y, s and q (summation order), 1e-4 for gradients, which pass
through two products.  bfloat16: both sides round the same float32-accumulated
values, so y, dx and the 1x1's dw (rounded to bf16 on both sides) are held to
one bf16 ulp (2^-7 of the largest value: a sum may land on the other side of a
rounding boundary; here they come out equal) and the float32 sums s, q, da, db
as in float32 (measured 6e-8 to 1.5e-7).  The block as a whole in float32:
output 1e-5, running statistics 1e-5, gradients 1e-4.  The port's fused block
against its own unfused modules at the JAX test's bands (bf16: output 2e-2,
statistics 1e-4, gradients 3e-2).  The CUDA kernels are held against the plain
versions on the card, where there is no jax:
``python -m pytest --noconftest tests/test_torch_fused_block.py -m cuda``.
"""

import copy

import numpy as np
import pytest
import torch

from iswm_tpu_torch.config import ModelConfig
from iswm_tpu_torch.models import _resolve_fused_mode, build_model
from iswm_tpu_torch.models import fused_block as mfb
from iswm_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from iswm_tpu_torch.ops.kernels import fused_block as fb

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)

F32 = np.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ULP = 2.0 ** -7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (both as float32 numpy)."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def _mm_inputs(m, k, n, seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(m, k)).astype(F32),
        w=(rng.normal(size=(k, n)) * 0.1).astype(F32),
        a=(rng.normal(size=k) * 0.5 + 1.0).astype(F32),
        b=(rng.normal(size=k) * 0.1).astype(F32),
        dy=rng.normal(size=(m, n)).astype(F32),
        ds=rng.normal(size=n).astype(F32),
        dq=(rng.normal(size=n) * 1e-2).astype(F32),
    )


def _c3_inputs(b, h, w, c, n, seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        y1=rng.normal(size=(b, h, w, c)).astype(F32),
        a=(rng.normal(size=c) * 0.5 + 1.0).astype(F32),
        b=(rng.normal(size=c) * 0.1).astype(F32),
        w=(rng.normal(size=(3, 3, c, n)) * 0.2).astype(F32),
        dy=rng.normal(size=(b, h, w, n)).astype(F32),
        ds=rng.normal(size=n).astype(F32),
        dq=(rng.normal(size=n) * 1e-2).astype(F32),
    )


def _bands(dtype):
    """(y and dx, s and q, the gradients' float32 sums, the 1x1's dw)."""
    if dtype == "float32":
        return 1e-5, 1e-5, 1e-4, 1e-4
    return BF16_ULP, 1e-5, 1e-4, BF16_ULP


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [256, 4096])
def test_matmul_bn_stats_matches_pallas(m, dtype, prologue):
    import jax
    import jax.numpy as jnp

    from iswm_tpu.ops.pallas import fused_block as jfb

    d = _mm_inputs(m, 16, 32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(d["x"], jdt), jnp.asarray(d["w"], jdt)
    (jy, js, jq), vjp = jax.vjp(
        lambda x, w, a, b: jfb.matmul_bn_stats(x, w, a, b, prologue, True),
        jx, jw, jnp.asarray(d["a"]), jnp.asarray(d["b"]))
    jgrads = vjp((jnp.asarray(d["dy"], jdt), jnp.asarray(d["ds"]), jnp.asarray(d["dq"])))

    tdt = DTYPES[dtype]
    leaves = [_t(d["x"], tdt), _t(d["w"], tdt), _t(d["a"]), _t(d["b"])]
    for t in leaves:
        t.requires_grad_()
    y, s, q = fb.matmul_bn_stats(*leaves, prologue=prologue)
    assert y.dtype == tdt and s.dtype == q.dtype == torch.float32
    used = leaves if prologue else leaves[:2]
    grads = torch.autograd.grad((y, s, q), used,
                                (_t(d["dy"], tdt), _t(d["ds"]), _t(d["dq"])))
    y_tol, stat_tol, sum_tol, dw_tol = _bands(dtype)
    _close(_np(y), np.asarray(jy, F32), y_tol)
    _close(_np(s), js, stat_tol)
    _close(_np(q), jq, stat_tol)
    assert grads[0].dtype == tdt and grads[1].dtype == tdt  # dw in the weight's dtype
    _close(_np(grads[0]), np.asarray(jgrads[0], F32), max(y_tol, 1e-4))
    _close(_np(grads[1]), np.asarray(jgrads[1], F32), dw_tol)
    if prologue:
        _close(_np(grads[2]), jgrads[2], sum_tol)
        _close(_np(grads[3]), jgrads[3], sum_tol)
    else:  # structurally zero in the JAX package, no gradient here
        assert not np.asarray(jgrads[2]).any() and not np.asarray(jgrads[3]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 16), (1, 32, 8, 8, 16)])
def test_conv3x3_bn_stats_matches_pallas(shape, dtype):
    import jax
    import jax.numpy as jnp

    from iswm_tpu.ops.pallas import fused_block as jfb

    d = _c3_inputs(*shape)
    jdt = jnp.dtype(dtype)
    (jy, js, jq), vjp = jax.vjp(
        lambda y1, a, b, w: jfb.conv3x3_bn_stats(y1, a, b, w, True),
        jnp.asarray(d["y1"], jdt), jnp.asarray(d["a"]), jnp.asarray(d["b"]),
        jnp.asarray(d["w"]))
    jgrads = vjp((jnp.asarray(d["dy"], jdt), jnp.asarray(d["ds"]), jnp.asarray(d["dq"])))

    tdt = DTYPES[dtype]
    leaves = [_t(d["y1"], tdt), _t(d["a"]), _t(d["b"]), _t(d["w"])]
    for t in leaves:
        t.requires_grad_()
    y, s, q = fb.conv3x3_bn_stats(*leaves)
    grads = torch.autograd.grad((y, s, q), leaves,
                                (_t(d["dy"], tdt), _t(d["ds"]), _t(d["dq"])))
    y_tol, stat_tol, sum_tol, _ = _bands(dtype)
    _close(_np(y), np.asarray(jy, F32), y_tol)
    _close(_np(s), js, stat_tol)
    _close(_np(q), jq, stat_tol)
    assert grads[0].dtype == tdt and grads[3].dtype == torch.float32  # dw stays float32
    _close(_np(grads[0]), np.asarray(jgrads[0], F32), max(y_tol, 1e-4))
    _close(_np(grads[1]), jgrads[1], sum_tol)
    _close(_np(grads[2]), jgrads[2], sum_tol)
    _close(_np(grads[3]), jgrads[3], sum_tol)


def test_conv3x3_pads_with_zero_after_the_prologue():
    """A border pixel sees 0 outside the image, not relu(b): with a = 0 and
    b = 1 every z is 1, and the corner's output sums four taps, not nine."""
    y1 = torch.zeros(1, 4, 4, 8)
    w = torch.ones(3, 3, 8, 8)
    y2, s, q = fb.conv3x3_bn_stats(y1, torch.zeros(8), torch.ones(8), w)
    assert float(y2[0, 0, 0, 0]) == 4 * 8 and float(y2[0, 1, 1, 0]) == 9 * 8
    assert float(y2[0, 0, 1, 0]) == 6 * 8
    torch.testing.assert_close(s, y2.sum((0, 1, 2)))
    torch.testing.assert_close(q, (y2 * y2).sum((0, 1, 2)))


@pytest.mark.parametrize("case", ["mm", "mm_prologue", "c3"])
def test_plain_backward_is_the_autograd_of_the_plain_forward(case):
    """The plain backwards are written out by hand: in float64, where no
    rounding point does anything, they equal autograd of the plain forwards."""
    f64 = torch.float64
    if case == "c3":
        d = _c3_inputs(2, 5, 6, 8, 16, seed=1)
        leaves = [_t(d[k], f64).requires_grad_() for k in ("y1", "w", "a", "b")]
        y1, w, a, b = leaves
        out = fb.conv3x3_bn_stats_plain(y1, a, b, w, dtype=f64)
        cot = tuple(_t(d[k], f64) for k in ("dy", "ds", "dq"))
        got = fb.conv3x3_bn_stats_bwd_plain(y1.detach(), a.detach(), b.detach(), w.detach(),
                                            out[0].detach(), *cot, dtype=f64)
    else:
        prologue = case == "mm_prologue"
        d = _mm_inputs(64, 16, 24, seed=1)
        leaves = [_t(d[k], f64).requires_grad_() for k in ("x", "w", "a", "b")]
        x, w, a, b = leaves
        out = fb.matmul_bn_stats_plain(x, w, a, b, prologue, dtype=f64)
        cot = tuple(_t(d[k], f64) for k in ("dy", "ds", "dq"))
        got = fb.matmul_bn_stats_bwd_plain(x.detach(), w.detach(), a.detach(), b.detach(),
                                           out[0].detach(), *cot, prologue, dtype=f64)
        if not prologue:
            assert not got[2].any() and not got[3].any()
            leaves, got = leaves[:2], got[:2]
    want = torch.autograd.grad(out, leaves, cot)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-10)


def test_wrappers_run_plain_for_cpu_tensors_without_counting():
    d = _mm_inputs(64, 16, 32)
    before = (fb.launches_mm_fwd, fb.launches_mm_bwd, fb.launches_c3_fwd, fb.launches_c3_bwd)
    x = _t(d["x"]).requires_grad_()
    y, s, q = fb.matmul_bn_stats(x, _t(d["w"]), _t(d["a"]), _t(d["b"]), prologue=True)
    (y.sum() + s.sum() + q.sum()).backward()
    want = fb.matmul_bn_stats_plain(x.detach(), _t(d["w"]), _t(d["a"]), _t(d["b"]), True)
    assert all(torch.equal(u, v) for u, v in zip((y, s, q), want))
    c = _c3_inputs(1, 4, 4, 8, 8)
    fb.conv3x3_bn_stats(_t(c["y1"]).requires_grad_(), _t(c["a"]), _t(c["b"]),
                        _t(c["w"]))[0].sum().backward()
    assert before == (fb.launches_mm_fwd, fb.launches_mm_bwd, fb.launches_c3_fwd,
                      fb.launches_c3_bwd)
    with pytest.raises(ValueError, match=r"x \[M, K\] and w \[K, N\]"):
        fb.matmul_bn_stats_fwd(torch.zeros(4, 8), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="prologue needs a and b"):
        fb.matmul_bn_stats_fwd(torch.zeros(4, 8), torch.zeros(8, 8), prologue=True)
    with pytest.raises(ValueError, match=r"w \[3, 3, C, N\]"):
        fb.conv3x3_bn_stats_fwd(torch.zeros(1, 4, 4, 8), torch.ones(8), torch.ones(8),
                                torch.zeros(3, 3, 16, 8))


def test_unused_statistics_get_zero_cotangents():
    """autograd hands the backward zeros for s and q when only y is used."""
    d = _mm_inputs(32, 16, 8)
    x, w = _t(d["x"]).requires_grad_(), _t(d["w"]).requires_grad_()
    y, _, _ = fb.matmul_bn_stats(x, w)
    dy = _t(d["dy"][:32, :8])
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.testing.assert_close(gx, dy @ w.detach().t())
    torch.testing.assert_close(gw, x.detach().t() @ dy)


# ------------------------------------------------------------------ the block
def _block_state_from_jax(params, stats, downsample):
    """A JAX Bottleneck's trees -> the port block's state dict, through the
    port's reference-format bridge."""
    from iswm_tpu_torch.compat.torch_import import _export_convbn

    sd = {}
    names = [("conv1", "conv1", "bn1"), ("conv2", "conv2", "bn2"), ("conv3", "conv3", "bn3")]
    if downsample:
        names.append(("downsample", "downsample.0", "downsample.1"))
    for flax_name, conv, bn in names:
        _export_convbn(sd, params, stats, (flax_name,), conv, bn)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _perturbed(tree, rng, stats=False):
    import jax

    def leaf(path, x):
        name, x = path[-1].key, np.asarray(x)
        if name == "kernel":
            return x
        if name == "var":
            return (0.5 + rng.random(x.shape)).astype(F32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.2 * rng.normal(size=x.shape)).astype(F32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("downsample", [True, False])
def test_fused_bottleneck_matches_jax_interpret(downsample):
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.resnet import Bottleneck as JaxBottleneck

    rng = np.random.default_rng(3)
    cin, planes = (16, 8) if downsample else (32, 8)
    x = np.abs(rng.normal(size=(2, 8, 8, cin))).astype(F32)  # post-ReLU, as in the model
    g = rng.normal(size=(2, 8, 8, 4 * planes)).astype(F32)
    jblock = JaxBottleneck(planes=planes, downsample=downsample, fused_mode="interpret",
                           dtype=jnp.float32)
    v = jblock.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    params = _perturbed(v["params"], rng)
    stats = _perturbed(v["batch_stats"], rng)

    def loss(params, x):
        out, mut = jblock.apply({"params": params, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    block = Bottleneck(cin, planes, downsample=downsample, fused_mode="always").train()
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1  # flax's 0.9
    block.load_state_dict(_block_state_from_jax(params, stats, downsample), strict=True)
    xt = _t(np.transpose(x, (0, 3, 1, 2))).requires_grad_()
    out = block(xt)
    out.backward(_t(np.transpose(g, (0, 3, 1, 2))))
    _close(_np(out.permute(0, 2, 3, 1)), jout, 1e-5)
    _close(_np(xt.grad.permute(0, 2, 3, 1)), jgx, 1e-4)
    want = _block_state_from_jax(jax.device_get(params), jax.device_get(jstats), downsample)
    want_grads = _block_state_from_jax(jax.device_get(jgp), jax.device_get(jstats), downsample)
    got = block.state_dict()
    for k, p in block.named_parameters():
        _close(_np(p.grad), want_grads[k].numpy(), 1e-4)
    for k in got:
        if "running_" in k:
            _close(_np(got[k]), want[k].numpy(), 1e-5)
        elif "num_batches" in k:
            assert int(got[k]) == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_bottleneck_matches_the_unfused_modules(dtype):
    """The JAX package's own check (``tests/test_fused_block.py``), at its
    bands in bf16; in float32 the two paths differ by summation order."""
    out_tol, stat_tol, grad_tol = (2e-2, 1e-4, 3e-2) if dtype == "bfloat16" else (
        1e-5, 1e-5, 1e-4)
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(2, 16, 8, 8)).astype(F32), DTYPES[dtype])
    fused = Bottleneck(16, 8, downsample=True, fused_mode="interpret").train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in fused.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.3)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    unfused = copy.deepcopy(fused)
    unfused.fused_mode = "never"
    assert list(fused.state_dict()) == list(unfused.state_dict())
    outs = {}
    for name, block in (("fused", fused), ("unfused", unfused)):
        xin = x.clone().requires_grad_()
        out = block(xin)
        out.float().square().sum().backward()
        outs[name] = (out, xin.grad)
    _close(_np(outs["fused"][0]), _np(outs["unfused"][0]), out_tol)
    _close(_np(outs["fused"][1]), _np(outs["unfused"][1]), grad_tol)
    for (k, p), (_, p2) in zip(fused.named_parameters(), unfused.named_parameters()):
        _close(_np(p.grad), _np(p2.grad), grad_tol)
    for (k, b), (_, b2) in zip(fused.named_buffers(), unfused.named_buffers()):
        assert torch.equal(b, b2) if "num_batches" in k else (
            float((b - b2).abs().max()) < stat_tol), k


# -------------------------------------------------------------------- the gate
@pytest.fixture()
def fused_calls(monkeypatch):
    """The calls of ``fused_bottleneck_apply``, which still runs."""
    calls, real = [], mfb.fused_bottleneck_apply

    def counting(block, x):
        calls.append(tuple(x.shape))
        return real(block, x)

    monkeypatch.setattr(mfb, "fused_bottleneck_apply", counting)
    return calls


GATE = {
    "eligible": (dict(in_ch=16, planes=8), (2, 16, 8, 8), True, True),
    "eval mode": (dict(in_ch=16, planes=8), (2, 16, 8, 8), False, False),
    "stride 2": (dict(in_ch=16, planes=8, strides=2, downsample=True), (2, 16, 8, 8), True,
                 False),
    "dilation 2": (dict(in_ch=32, planes=8, dilation=2), (2, 32, 8, 8), True, False),
    "resnext50_32x4d": (dict(in_ch=64, planes=16, groups=32, base_width=4, downsample=True),
                        (2, 64, 8, 8), True, False),
    "wide_resnet50_2": (dict(in_ch=32, planes=8, base_width=128), (2, 32, 8, 8), True, False),
    "B*H*W not divisible by 16": (dict(in_ch=32, planes=8), (1, 32, 6, 6), True, False),
    "image under 3x3": (dict(in_ch=32, planes=8), (16, 32, 2, 2), True, False),
}


@pytest.mark.parametrize("name", sorted(GATE))
def test_gate(fused_calls, name):
    kw, shape, train, fuses = GATE[name]
    kw.setdefault("downsample", kw["in_ch"] != 4 * kw["planes"])
    block = Bottleneck(**kw, fused_mode="always").train(train)
    out = block(torch.randn(shape, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(out).all()
    assert bool(fused_calls) == fuses
    assert mfb.fused_block_eligible(shape) == (name not in (
        "B*H*W not divisible by 16", "image under 3x3"))


def test_auto_fuses_on_a_cuda_tensor_only(fused_calls):
    block = Bottleneck(32, 8, fused_mode="auto").train()
    block(torch.zeros(2, 32, 8, 8))
    assert not fused_calls and not block.fuses_on(torch.device("cpu"))
    assert block.fuses_on(torch.device("cuda"))
    assert not Bottleneck(32, 8, fused_mode="never").fuses_on(torch.device("cuda"))


def test_pick_tile_m_is_the_jax_rule():
    from iswm_tpu.ops.pallas.fused_block import _pick_tile_m

    for m in (16, 128, 592, 2048, 4096, 131072, 36, 8, 2049 * 16):
        assert mfb._pick_tile_m(m) == _pick_tile_m(m)


def _blocks_cfg(mode, backbone="resnet50"):
    cfg = ModelConfig(backbone=backbone, compute_dtype="float32")
    cfg.fused_blocks = mode
    return cfg


@pytest.mark.parametrize("value", ["never", "auto", "always", "interpret", "sometimes"])
def test_resnet_hands_the_mode_to_every_bottleneck(value):
    if value == "sometimes":
        with pytest.raises(ValueError, match="unknown fused_blocks setting 'sometimes'"):
            _resolve_fused_mode(value, "fused_blocks")
        with pytest.raises(ValueError, match="unknown fused_blocks setting"):
            build_model(_blocks_cfg(value))
        return
    net = ResNet("resnet50", fused_blocks=value)
    blocks = [m for m in net.modules() if isinstance(m, Bottleneck)]
    assert len(blocks) == 16 and all(b.fused_mode == value for b in blocks)
    assert list(net.state_dict()) == list(ResNet("resnet50").state_dict())
    assert ModelConfig().fused_blocks == "never"
    basic = ResNet("resnet18", fused_blocks=value)
    assert not any(hasattr(m, "fused_mode") for m in basic.modules()
                   if isinstance(m, BasicBlock))


def test_build_model_resolves_fused_blocks_and_only_training_fuses(fused_calls):
    model = build_model(_blocks_cfg("interpret"))
    assert all(m.fused_mode == "interpret" for m in model.modules()
               if isinstance(m, Bottleneck))
    assert list(model.state_dict()) == list(build_model(_blocks_cfg("never")).state_dict())
    x = torch.zeros(2, 3, 64, 64)
    with torch.no_grad():
        model(x)  # build_model returns an eval-mode model
        assert not fused_calls
        model.train()(x)
    # OS 16 at 64x64: layer1 (16x16) and layer2.{1,2,3} (8x8) and layer3.{1..5},
    # layer4.0 (4x4) pass the gate; stride-2 and dilated blocks do not
    assert len(fused_calls) == 12
    build_model(_blocks_cfg("never")).load_state_dict(model.state_dict(), strict=True)


# ------------------------------------------------------- the slice as a whole
SLICE_SIZE, SLICE_BATCH, SLICE_SEED = 32, 8, 1


@pytest.fixture(scope="module")
def slice_runs():
    """One SGD step of the backbone's fused part in both packages: ResNet-50's
    ``layer1`` (three blocks, the first with downsample) and ``layer2``
    (its stride-2 first block unfused, three fused blocks), float32, from the
    same weights, on the same input and cotangent.

    Cut from the whole ``deeplabv3plus_resnet50`` train step, which cannot
    be held at this tolerance: at 64x64 and 32x32, batch 2 and 8, over four
    batch seeds, every parameter's update differs between the two packages by
    2e-2 to 5e-1 of its largest element, and ``layer3`` / ``layer4`` running
    variances by more than 1e-5, with ``fused_blocks`` on both sides AND with
    it off on both sides (the losses agree to 1e-5): 53 BatchNorm layers on
    4x4 maps amplify float32 rounding, as ``tests/test_torch_train_step.py``
    describes for one flipped ReLU.  The stack here holds every kind of block
    the gate passes or refuses; the Trainer's whole step with ``fused_blocks``
    is driven in ``tests/test_torch_train.py``."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.resnet import Bottleneck as JaxBottleneck

    rng = np.random.default_rng(SLICE_SEED)
    x = np.abs(rng.normal(size=(2, 8, 8, 64))).astype(F32)
    specs = [(64, 1, True)] + [(64, 1, False)] * 2 + [(128, 2, True)] + [(128, 1, False)] * 3
    jblocks = [JaxBottleneck(planes=p, strides=s, downsample=ds, fused_mode="interpret",
                             dtype=jnp.float32) for p, s, ds in specs]
    variables, h = [], jnp.asarray(x)
    for i, blk in enumerate(jblocks):
        v = blk.init({"params": jax.random.key(i)}, h, train=False)
        v = {"params": _perturbed(v["params"], rng), "batch_stats": _perturbed(
            v["batch_stats"], rng)}
        variables.append(v)
        h = blk.apply(v, h, train=False)
    g = rng.normal(size=h.shape).astype(F32)
    lr = 0.1

    def loss(params):
        h, new_stats = jnp.asarray(x), []
        for blk, p, v in zip(jblocks, params, variables):
            h, mut = blk.apply({"params": p, "batch_stats": v["batch_stats"]}, h, train=True,
                               mutable=["batch_stats"])
            new_stats.append(mut["batch_stats"])
        return jnp.sum(h * g) / g.size, new_stats

    params = [v["params"] for v in variables]
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    new_params = jax.tree.map(lambda p, d: p - lr * d, params, jgrads)

    in_ch, blocks = 64, []
    for p, s, ds in specs:
        blocks.append(Bottleneck(in_ch, p, strides=s, downsample=ds, fused_mode="always"))
        in_ch = 4 * p
    net = torch.nn.Sequential(*blocks).train()
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1
    for blk, v, (_, _, ds) in zip(net, variables, specs):
        blk.load_state_dict(_block_state_from_jax(v["params"], v["batch_stats"], ds),
                            strict=True)
    calls, real = [], mfb.fused_bottleneck_apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mfb, "fused_bottleneck_apply",
                   lambda b, t: (calls.append(1), real(b, t))[1])
        out = net(_t(np.transpose(x, (0, 3, 1, 2))))
    tloss = (out * _t(np.transpose(g, (0, 3, 1, 2)))).sum() / g.size
    tloss.backward()
    before = copy.deepcopy(net.state_dict())
    torch.optim.SGD(net.parameters(), lr=lr).step()
    want = [_block_state_from_jax(jax.device_get(p), jax.device_get(s), ds)
            for p, s, (_, _, ds) in zip(new_params, jstats, specs)]
    old = [_block_state_from_jax(jax.device_get(p), jax.device_get(s), ds)
           for p, s, (_, _, ds) in zip(params, jstats, specs)]
    return float(jloss), float(tloss), len(calls), before, net.state_dict(), old, want


def test_slice_loss_and_fused_block_count(slice_runs):
    jloss, tloss, n_fused, *_ = slice_runs
    assert n_fused == 6  # layer1.{0,1,2} and layer2.{1,2,3}; layer2.0 has stride 2
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_slice_updated_parameters_and_statistics_match_jax(slice_runs):
    """``tests/test_torch_train_step.py``'s tolerance: each parameter's update
    within 1e-3 * max|update| plus one float32 ulp of the parameter; running
    statistics within 1e-5."""
    *_, before, after, old, want = slice_runs
    n = 0
    for i, (w_old, w_new) in enumerate(zip(old, want)):
        for k, new in w_new.items():
            key = f"{i}.{k}"
            if "num_batches" in k:
                continue
            if "running_" in k:
                _close(_np(after[key]), new.numpy(), 1e-5)
                continue
            update = new.numpy() - w_old[k].numpy()
            got = (after[key] - before[key]).numpy()
            assert np.abs(update).max() > 0, key
            ulp = np.spacing(np.abs(new.numpy()))
            assert (np.abs(got - update) <= 1e-3 * np.abs(update).max() + ulp).all(), key
            n += 1
    assert n == 3 * (3 * 7 + 2)  # conv + gamma + beta of every ConvBN


# ---------------------------------------------------------------- on the card
def _ulp_error(got, want, dtype):
    """Largest error in bf16 ulps (taken at max(|want|, max|want| / 128)), or
    in units of 1e-5 * max|want| for float32."""
    err = (got.double() - want.double()).abs()
    top = float(want.double().abs().max())
    if dtype == torch.bfloat16:
        mag = want.double().abs().clamp_min(max(top / 128, 1e-30))
        return float((err / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())
    return float(err.max()) / max(1e-5 * top, 1e-300)


def _sums_close(got, want, tol):
    return float((got.double() - want.double()).abs().max()) <= tol * float(
        want.double().abs().max())


CUDA_MM = [(16 * 37, 64, 64, True), (16 * 37, 64, 64, False), (128, 64, 64, True),
           (256, 16, 32, True), (4096, 128, 256, True),
           # the bf16 backward's edges: C = 64 (the 64-row weight-gradient tile),
           # C = 1024 with N = 2048 (eight dx tiles across C, 32 stages deep, and
           # one weight-gradient split: dw written directly), and an M that
           # divides into neither the 64-pixel stage nor the split length
           (8192 + 16 * 37, 64, 64, False), (4096, 1024, 2048, True),
           (8192 + 16 * 37, 512, 128, True),
           # the bf16 forward's plans (plan_fwd): 64 x 64 above (N <= 64), 128 x 64
           # at (8192 + 16 * 37, 64, 64), 64 x 128 at every other shape above;
           # 128 x 128 without the prologue, and 128 x 64 walking 2 column tiles a
           # block at N = 192, the last block 1, M ragged
           (32768, 128, 256, False), (65536 - 16 * 37, 64, 192, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,prologue", CUDA_MM)
def test_cuda_matmul_kernels_match_plain(m, k, n, prologue, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tdt = DTYPES[dtype]
    d = _mm_inputs(m, k, n, seed=5)
    x, w = _t(d["x"] + 0.5, tdt).cuda(), _t(d["w"], tdt).cuda()
    a, b = _t(d["a"]).cuda(), _t(d["b"]).cuda()
    cot = (_t(d["dy"], tdt).cuda(), _t(d["ds"]).cuda(), _t(d["dq"]).cuda())
    before = (fb.launches_mm_fwd, fb.launches_mm_bwd)
    y, s, q = fb.matmul_bn_stats_fwd(x, w, a, b, prologue)
    again = fb.matmul_bn_stats_fwd(x, w, a, b, prologue)
    assert all(torch.equal(u, v) for u, v in zip((y, s, q), again))  # bit-stable
    want = fb.matmul_bn_stats_plain(x, w, a, b, prologue, dtype=torch.float64)
    assert y.dtype == tdt and _ulp_error(y, want[0], tdt) <= 1.0
    assert _sums_close(s, y.double().sum(0), 1e-5)
    assert _sums_close(q, (y.double() ** 2).sum(0), 1e-5)
    got = fb.matmul_bn_stats_bwd(x, w, a, b, y, *cot, prologue)
    again = fb.matmul_bn_stats_bwd(x, w, a, b, y, *cot, prologue)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = fb.matmul_bn_stats_bwd_plain(x, w, a, b, y, *cot, prologue, dtype=torch.float64)
    assert _ulp_error(got[0], want[0], tdt) <= 1.0
    band = 5e-5 if tdt == torch.bfloat16 else 1e-5
    assert all(_sums_close(g, w_, band) for g, w_ in zip(got[1:], want[1:]))
    torch.cuda.synchronize()
    assert (fb.launches_mm_fwd, fb.launches_mm_bwd) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 16), (1, 5, 7, 16, 8), (2, 12, 12, 64, 64),
                                   # the bf16 backward's edges: C and N off the 64-deep
                                   # stage, a 128-pixel block across two images and
                                   # ragged image edges; C off the 128-wide dx tile
                                   (3, 9, 11, 72, 40), (2, 16, 16, 192, 128),
                                   # the bf16 forward's tiles (plan_fwd): 128 x 64 at the
                                   # shapes above; 128 x 128 at N = 192 with C off the
                                   # 32-deep stage, and 128 x 64 at M = 32768 with C = 16
                                   (4, 64, 64, 72, 192), (2, 128, 128, 16, 64)])
def test_cuda_conv3x3_kernels_match_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tdt = DTYPES[dtype]
    d = _c3_inputs(*shape, seed=5)
    y1, w = _t(d["y1"] + 0.5, tdt).cuda(), _t(d["w"]).cuda()
    a, b = _t(d["a"]).cuda(), _t(d["b"]).cuda()
    cot = (_t(d["dy"], tdt).cuda(), _t(d["ds"]).cuda(), _t(d["dq"]).cuda())
    y, s, q = fb.conv3x3_bn_stats_fwd(y1, a, b, w)
    again = fb.conv3x3_bn_stats_fwd(y1, a, b, w)
    assert all(torch.equal(u, v) for u, v in zip((y, s, q), again))  # bit-stable
    want = fb.conv3x3_bn_stats_plain(y1, a, b, w, dtype=torch.float64)
    assert y.dtype == tdt and _ulp_error(y, want[0], tdt) <= 1.0
    assert _sums_close(s, y.double().sum((0, 1, 2)), 1e-5)
    assert _sums_close(q, (y.double() ** 2).sum((0, 1, 2)), 1e-5)
    got = fb.conv3x3_bn_stats_bwd(y1, a, b, w, y, *cot)
    again = fb.conv3x3_bn_stats_bwd(y1, a, b, w, y, *cot)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = fb.conv3x3_bn_stats_bwd_plain(y1, a, b, w, y, *cot, dtype=torch.float64)
    assert _ulp_error(got[0], want[0], tdt) <= 1.0
    band = 5e-5 if tdt == torch.bfloat16 else 1e-5
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == tuple(w.shape)
    assert all(_sums_close(g, w_, band) for g, w_ in zip(got[1:], want[1:]))


@pytest.mark.cuda
def test_cuda_all_negative_prologue_gives_exact_zeros_and_bad_inputs_raise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    d = _mm_inputs(2048, 128, 64, seed=2)
    x, w = _t(d["x"], torch.bfloat16).cuda(), _t(d["w"], torch.bfloat16).cuda()
    a, b = _t(np.abs(d["a"])).cuda(), _t(d["b"] - 100.0).cuda()
    y, s, q = fb.matmul_bn_stats_fwd(x, w, a, b, True)
    got = fb.matmul_bn_stats_bwd(x, w, a, b, y, _t(d["dy"], torch.bfloat16).cuda(),
                                 _t(d["ds"]).cuda(), _t(d["dq"]).cuda(), True)
    assert not any(bool(t.float().any()) for t in (y, s, q, *got))
    with pytest.raises(ValueError, match="divisible by 8"):
        fb.matmul_bn_stats_fwd(torch.zeros(16, 12, device="cuda"),
                               torch.zeros(12, 8, device="cuda"))
    with pytest.raises(TypeError, match="bf16 or f32"):
        fb.matmul_bn_stats_fwd(torch.zeros(16, 8, device="cuda", dtype=torch.float16),
                               torch.zeros(8, 8, device="cuda", dtype=torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_fused_block_matches_the_unfused_modules_and_counts(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tdt = DTYPES[dtype]
    out_tol, grad_tol = (2e-2, 3e-2) if tdt == torch.bfloat16 else (1e-4, 1e-3)
    torch.backends.cudnn.allow_tf32 = False
    fused = Bottleneck(64, 32, downsample=True, fused_mode="always").cuda().train()
    fused = fused.to(memory_format=torch.channels_last)
    unfused = copy.deepcopy(fused)
    unfused.fused_mode = "never"
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 64, 16, 16, generator=gen, device="cuda").relu().to(tdt)
    x = x.contiguous(memory_format=torch.channels_last)
    before = (fb.launches_mm_fwd, fb.launches_c3_fwd, fb.launches_mm_bwd, fb.launches_c3_bwd)
    results = []
    for block in (fused, unfused):
        xin = x.clone().requires_grad_()
        out = block(xin)
        out.float().square().mean().backward()
        results.append((out, xin.grad))
    torch.backends.cudnn.allow_tf32 = True
    assert (fb.launches_mm_fwd, fb.launches_c3_fwd, fb.launches_mm_bwd,
            fb.launches_c3_bwd) == (before[0] + 3, before[1] + 1, before[2] + 3, before[3] + 1)
    fused.eval()(x)  # evaluation never reaches the kernels
    assert fb.launches_mm_fwd == before[0] + 3
    rel = lambda u, v: float((u.float() - v.float()).abs().max() / v.float().abs().max())
    assert rel(results[0][0], results[1][0]) <= out_tol
    assert rel(results[0][1], results[1][1]) <= grad_tol
    for (k, p), (_, p2) in zip(fused.named_parameters(), unfused.named_parameters()):
        assert rel(p.grad, p2.grad) <= grad_tol, k
    for (k, u), (_, v) in zip(fused.named_buffers(), unfused.named_buffers()):
        assert "num_batches" in k or float((u - v).abs().max()) <= 1e-5, k
