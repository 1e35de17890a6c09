"""``int8_exec_xla`` serving of the port against the JAX package's, on the CPU.

- The plain versions of the int8 quantize and convs (what the wrappers run
  for a CPU tensor), through the port's ``ops/int8_xla.py``, equal the JAX
  package's ``iswm_tpu/ops/int8_xla.py`` bit for bit on the same float32
  inputs: the int32 sums are exact and every float step is the same IEEE
  operation (tolerance 0).
- The routed sites and the calibration keys, ``#p{i}`` parts included,
  equal the JAX package's, mapped by ``port_site_key``.  The JAX side is only
  traced (``jax.jit`` -> ``jax.eval_shape``, its dequantized weights left
  int8): which sites route is decided while tracing, so nothing of ResNet-50
  is compiled on the CPU.
- ``int8_exec_xla`` logits of ResNet-18 at 64^2 (BatchNorm perturbed) with
  the JAX-calibrated scales lie within 1e-2 * max|logit| of the JAX
  package's, with mask agreement >= 0.999 (ROADMAP.md's int8 rule: an
  ulp-level activation difference can flip one int8 level at a site), and
  the port's own calibration gives the JAX scales site by site within 1e-6
  relative (an absmax of float32 activations summed in another order).

- The plain conv's ``out_dtype`` (bf16 is float32 rounded), the serving
  modules' output dtypes (``Int8Conv`` writes its input's dtype, giving the
  bits of the float32 result cast after; ``Int8ConcatConvBN``'s parts stay
  float32) and the dense kernel's tap-skipping rule (``tile_taps``: a tap it
  skips reads only padding for every pixel of the block) and plans.

The ``cuda`` cases hold each kernel bit-equal to its plain version on the
card, in float32 and in bf16, where this file runs alone without jax:
``python -m pytest --noconftest tests/test_torch_int8_xla.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.config import ModelConfig
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.ops import int8_xla as px
from iswm_tpu_torch.ops.kernels import int8_conv as k8c

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)


def _weights(rng, kh, kw, cg, n):
    """HWIO float weights -> (int8 HWIO codes, per-O float32 scales)."""
    w = rng.normal(size=(kh, kw, cg, n)).astype(np.float32)
    amax = np.abs(w).max(axis=(0, 1, 2))
    w_scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(w / w_scale), -127, 127).astype(np.int8), w_scale


def _oihw(w_q):
    return torch.from_numpy(np.ascontiguousarray(w_q.transpose(3, 2, 0, 1)))


# (function, C, H, W, k, stride, dilation, groups, N, x dtype): every k in
# {1, 3, 7}, stride in {1, 2}, dilation in {1, 2, 6}, groups in {1, 4, C}, N
# in {2, 48, 128}; C of 16 and 32 take the kernel's 16-byte gather, 3 and 24
# the bytewise one
CONV_CASES = {
    "conv_k3": ("conv", 16, 9, 11, 3, 1, 1, 1, 48, "bfloat16"),
    "conv_k3_s2_n2": ("conv", 24, 9, 10, 3, 2, 1, 1, 2, "float32"),
    "conv_k3_d2_n128": ("conv", 32, 8, 8, 3, 1, 2, 1, 128, "bfloat16"),
    "conv_k1_s2": ("conv", 64, 7, 9, 1, 2, 1, 1, 48, "float32"),
    "conv_g4": ("conv", 32, 8, 7, 3, 1, 1, 4, 48, "bfloat16"),
    "conv_depthwise_s2_d2": ("conv", 16, 10, 9, 3, 2, 2, 16, 16, "float32"),
    "conv_k7_s2_c3": ("conv", 3, 12, 10, 7, 2, 1, 1, 48, "float32"),
    "shifted_d2": ("shifted", 16, 9, 9, 3, 1, 2, 1, 48, "bfloat16"),
    "shifted_d6": ("shifted", 32, 8, 8, 3, 1, 6, 1, 128, "float32"),
    "stem_packed": ("stem", 3, 12, 14, 7, 2, 1, 1, 48, "float32"),
    "stem_odd": ("stem", 3, 11, 13, 7, 2, 1, 1, 2, "bfloat16"),
    "conv1x1_matmul": ("conv1x1", 128, 5, 6, 1, 1, 1, 1, 128, "bfloat16"),
    "conv1x1_igemm": ("conv1x1", 64, 5, 6, 1, 1, 1, 1, 48, "float32"),
    "matmul": ("matmul", 128, 1, 37, 1, 1, 1, 1, 128, "float32"),
    "matmul_k147_n2": ("matmul", 147, 1, 37, 1, 1, 1, 1, 2, "bfloat16"),
    "matmul_prequant": ("prequant", 128, 1, 37, 1, 1, 1, 1, 128, "float32"),
    "matmul_prequant_n48": ("prequant", 64, 1, 37, 1, 1, 1, 1, 48, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_plain_bit_equals_jax(case):
    """Each JAX function runs under one ``jax.jit`` (x_scale an argument,
    as in the serving program, so that no division meets a constant)."""
    import functools

    import jax
    import jax.numpy as jnp

    from iswm_tpu.ops import int8_xla as jx

    fn, c, h, w, k, stride, dil, groups, n, dtype = CONV_CASES[case]
    rng = np.random.default_rng([len(case), c, n])
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    x_scale = float(np.abs(x).max() / 127.0) / 2.0  # some codes clip
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    w_q, w_scale = _weights(rng, k, k, c // groups, n)
    wj, sj = jnp.asarray(w_q), jnp.asarray(w_scale).reshape(1, 1, 1, n)
    wt, st = _oihw(w_q), torch.from_numpy(w_scale)
    if fn == "conv":
        pad = ((k // 2 * dil, k // 2 * dil), (k // 2 * dil, k // 2 * dil))
        jfn = functools.partial(jx.quantized_conv_xla, strides=(stride, stride), padding=pad,
                                dilation=(dil, dil), feature_group_count=groups)
        got = px.quantized_conv_xla(xt, wt, st, x_scale, strides=stride, padding=pad,
                                    dilation=dil, feature_group_count=groups)
    elif fn == "shifted":
        jfn = functools.partial(jx.int8_shifted_dilated_conv, d=dil)
        got = px.int8_shifted_dilated_conv(xt, wt, st, x_scale, dil)
    elif fn == "stem":
        jfn = functools.partial(jx.int8_packed_stem_conv, k=k)
        got = px.int8_packed_stem_conv(xt, wt, st, x_scale, k)
    elif fn == "conv1x1":
        jfn = jx.quantized_conv1x1_xla
        got = px.quantized_conv1x1_xla(xt, wt, st, x_scale)
    else:  # a matmul over the 2 x 37 rows
        xj, xt = xj.reshape(-1, c), xt.reshape(-1, c)
        wm = w_q.reshape(c, n)
        wj, sj, wt = jnp.asarray(wm), jnp.asarray(w_scale), torch.from_numpy(wm)
        if fn == "matmul":
            jfn = jx.int8_matmul_xla
            got = px.int8_matmul_xla(xt, wt, st, x_scale)
        else:
            codes = np.array(jax.jit(jx.quantize_activations)(xj, x_scale))
            np.testing.assert_array_equal(px.quantize_activations(xt, x_scale).numpy(), codes)
            jfn, xj = jx.int8_matmul_prequant_xla, jnp.asarray(codes)
            got = px.int8_matmul_prequant_xla(torch.from_numpy(codes), wt, st, x_scale)
    want = np.asarray(jax.jit(jfn)(xj, wj, sj, x_scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_conv_bias_and_asymmetric_padding():
    """The plain conv's bias is added after the epilogue; ((top, bottom),
    (left, right)) pads match the JAX conv's."""
    import jax.numpy as jnp

    from iswm_tpu.ops import int8_xla as jx

    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 7, 8, 16)).astype(np.float32)
    w_q, w_scale = _weights(rng, 3, 3, 16, 48)
    bias = rng.normal(size=48).astype(np.float32)
    pad = ((2, 0), (1, 3))
    want = np.asarray(jx.quantized_conv_xla(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale), 0.01, strides=(2, 1),
        padding=pad)) + bias
    x_q = k8c.quantize_s8(torch.from_numpy(x), 0.01)
    w_ohwi = torch.from_numpy(np.ascontiguousarray(w_q.transpose(3, 0, 1, 2)))
    got = k8c.conv_s8_igemm(x_q, w_ohwi, torch.from_numpy(w_scale), 0.01,
                            torch.from_numpy(bias), stride=(2, 1), padding=pad)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------- output dtypes and the plan
@pytest.mark.parametrize("case", ["conv_k3_d2_n128", "conv_g4", "conv_k7_s2_c3"])
def test_plain_out_dtype_bf16_is_rounded_float32(case):
    _, c, h, w, k, stride, dil, groups, n, _ = CONV_CASES[case]
    rng = np.random.default_rng([len(case), 7])
    x_q = _codes(rng, (2, h, w, c))
    w_q = _codes(rng, (n, k, k, c // groups))
    w_scale = torch.from_numpy(rng.random(n).astype(np.float32) * 0.01 + 1e-4)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    kw = dict(stride=stride, padding=k // 2 * dil, dilation=dil, groups=groups)
    f32 = k8c.conv_s8_plain(x_q, w_q, w_scale, 0.0123, bias, **kw)
    bf16 = k8c.conv_s8_plain(x_q, w_q, w_scale, 0.0123, bias, out_dtype=torch.bfloat16, **kw)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    entry = k8c.conv_s8_igemm if groups == 1 else k8c.conv_s8_direct
    extra = {} if groups == 1 else {"groups": groups}
    kw.pop("groups")
    assert torch.equal(entry(x_q, w_q, w_scale, 0.0123, bias, out_dtype=torch.bfloat16,
                             **kw, **extra), bf16)
    with pytest.raises(TypeError):
        k8c.conv_s8_plain(x_q, w_q, w_scale, 0.0123, out_dtype=torch.float16, **kw, **extra)


def test_serving_modules_out_dtypes_and_bits(monkeypatch):
    """ResNet-18 V3+ at 64^2 in bf16, int8_exec_xla: every ``Int8Conv`` asks
    the conv for its input's dtype and gives the bits of the float32 result
    cast after (as before the bf16 epilogue); the concat conv's parts stay
    float32; the logits equal those of the float32-then-cast path."""
    model = _bn_perturbed(build_model(ModelConfig(name="deeplabv3plus", backbone="resnet18",
                                                  compute_dtype="bfloat16")), 3)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 3, 64, 64)).astype(np.float32))
    scales = pq.calibrate_conv_inputs(model, [x], wide=True)
    fn = pq.make_variant_fn(model, "int8_exec_xla", conv_scales=scales)
    seen = []
    conv = pq.int8_conv

    def recorded(xh, *args, out_dtype=torch.float32, **kwargs):
        seen.append((xh.dtype, out_dtype))
        return conv(xh, *args, out_dtype=out_dtype, **kwargs)

    monkeypatch.setattr(pq, "int8_conv", recorded)
    got = fn(x.permute(0, 2, 3, 1))
    parts = sum(len(m.widths) for m in fn.model.modules() if isinstance(m, pq.Int8ConcatConvBN))
    routed = sum(isinstance(m, pq.Int8Conv) for m in fn.model.modules())
    assert parts == 2 and routed > 0 and len(seen) == routed + parts
    assert seen.count((torch.bfloat16, torch.bfloat16)) == routed
    assert seen.count((torch.bfloat16, torch.float32)) == parts

    def cast_after(xh, *args, out_dtype=torch.float32, **kwargs):
        return conv(xh, *args, **kwargs).to(out_dtype)

    monkeypatch.setattr(pq, "int8_conv", cast_after)
    assert torch.equal(got, fn(x.permute(0, 2, 3, 1)))


# (B, H, W, C, N, k, stride, pad, dilation): the ASPP branches at 32^2
# (whole blocks in padding at d = 12, 18), a stride-2 3x3 at 128^2, a 1x1 over
# a row of pixels, the stem, ragged sides
TAP_GEOMETRIES = {
    "aspp_d6": (8, 32, 32, 2048, 256, 3, 1, 6, 6),
    "aspp_d12": (8, 32, 32, 2048, 256, 3, 1, 12, 12),
    "aspp_d18": (8, 32, 32, 2048, 256, 3, 1, 18, 18),
    "stride2_128": (8, 128, 128, 128, 128, 3, 2, 1, 1),
    "row_1x1": (1, 1, 131072, 256, 48, 1, 1, 0, 1),
    "stem": (8, 512, 512, 3, 64, 7, 2, 3, 1),
    "ragged_d2": (2, 37, 21, 64, 64, 3, 1, 2, 2),
    "asymmetric": (1, 9, 30, 16, 16, 5, 2, 4, 3),
}


@pytest.mark.parametrize("name", sorted(TAP_GEOMETRIES))
def test_tap_skipping_rule(name):
    """For every block rectangle of every tile width, a tap of ``tile_taps``
    reads inside the input for some pixel of the block, and every other tap
    reads only padding for all of them (so skipping its K adds 0)."""
    b, h, w, c, n, k, stride, pad, dil = TAP_GEOMETRIES[name]
    g = k8c.conv_geometry((b, h, w, c), (n, k, k, c), stride, pad, dil)
    rows_in = [[0 <= oy * stride - pad + kh * dil < h for oy in range(g["Ho"])]
               for kh in range(k)]
    cols_in = [[0 <= ox * stride - pad + kw * dil < w for ox in range(g["Wo"])]
               for kw in range(k)]
    for tw in k8c.TILE_WIDTHS:
        th = 128 // tw
        rows, cols = k8c.tile_taps(g, tw)
        assert len(rows) == -(-g["Ho"] // th) and len(cols) == -(-g["Wo"] // tw)
        for ty, kept in enumerate(rows):
            for kh in range(k):
                assert (kh in kept) == any(rows_in[kh][ty * th:(ty + 1) * th])
        for tx, kept in enumerate(cols):
            for kw in range(k):
                assert (kw in kept) == any(cols_in[kw][tx * tw:(tx + 1) * tw])
    plan = k8c.plan_igemm(g, 2)
    assert 0 < plan["kept"] <= 1 and plan["blocks"] > 0
    if name == "aspp_d18":  # no block rectangle of 128 pixels keeps all 9 taps
        assert plan["kept"] <= 0.67


def test_dense_plans_fit_the_card():
    """At every dense shape of the serving chunk and the odd ones, the
    planned body's shared memory and grid fit an H100; 1x1 stride-1 convs
    are planned as one row of pixels."""
    import chip_smoke as cs

    for shape in (*cs.XLA_IGEMM_SHAPES, cs.XLA_STEM_SHAPE, *cs.XLA_ODD_SHAPES):
        b, h, w, c, n, k, stride, pad, dil = shape
        g = k8c.conv_geometry((b, h, w, c), (n, k, k, c), stride, pad, dil)
        if k8c.igemm_body(g) == "bytes":
            assert c % 16 and shape == cs.XLA_STEM_SHAPE
            continue
        rows = k8c.as_rows(g)
        if k == 1 and stride == 1:
            assert (rows["H"], rows["W"], rows["Wo"]) == (1, b * h * w, b * h * w)
        for out_bytes in (2, 4):
            p = k8c.plan_igemm(rows, out_bytes)
            dyn, static = k8c.dense_smem(p["bn"], p["slots"])
            assert (p["bn"], p["slots"]) in k8c.DENSE_PLANS and dyn + static <= k8c.SMEM_MAX
            assert p["tw"] in k8c.TILE_WIDTHS and p["splits"] in k8c.SPLITS
            assert 0 < p["blocks"] < 2**31


# ------------------------------------------------------------ routed sites
class _TraceOnly:
    """``jax`` as ``iswm_tpu.infer.quantization`` sees it here: a jitted
    call is traced (``jax.eval_shape``) and never compiled, and
    ``device_get`` gives zeros of the traced shapes."""

    def __getattr__(self, name):
        import jax

        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        import jax

        return lambda *args: jax.eval_shape(fn, *args)

    @staticmethod
    def device_get(tree):
        import jax

        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


@pytest.fixture
def traced_jq(monkeypatch):
    from iswm_tpu.infer import quantization as jq

    monkeypatch.setattr(jq, "jax", _TraceOnly())
    monkeypatch.setattr(jq, "dequantize_params", lambda q, s, dtype=None: q)
    return jq


def _bn_perturbed(model, seed=0):
    """``model`` with every BatchNorm's scale, bias and running statistics
    drawn from a numpy seed, so that BN is not the identity."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.weight, 1.0 + 0.2 * rng.normal(size=c)),
                             (m.bias, 0.1 * rng.normal(size=c)),
                             (m.running_mean, 0.1 * rng.normal(size=c)),
                             (m.running_var, 0.5 + rng.random(size=c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def _crossed(head, backbone, seed=0):
    """(port model, JAX model, JAX params, JAX batch_stats) with the port's
    seeded weights (BatchNorm perturbed), imported into the JAX trees."""
    from iswm_tpu.compat.torch_import import import_torch_state_dict
    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.models import build_model as build_jax_model

    model = _bn_perturbed(build_model(ModelConfig(name=head, backbone=backbone,
                                                  compute_dtype="float32")), seed)
    params, stats = import_torch_state_dict(model.state_dict(), backbone=backbone, head=head)
    jmodel = build_jax_model(JaxModelConfig(name=head, backbone=backbone,
                                            compute_dtype="float32"))
    return model, jmodel, params, stats


def _jax_sites(jq, jmodel, params, stats, x, drop=(), **flags):
    """(the JAX calibration's keys, the routed sites of the JAX fn built on
    those keys less ``drop``), traced."""
    import jax.numpy as jnp

    keys = jq.calibrate_conv_inputs(jmodel, params, stats, [jnp.asarray(x)], wide=True,
                                    **flags)
    scales = {k: s for k, s in keys.items() if k not in drop}
    fn = jq.make_int8_exec_fn(jmodel, stats, params, scales, backend="xla", **flags)
    fn(jnp.asarray(x))
    return set(keys), set(fn.routed_sites)


# (head, backbone, flags, routed sites): ResNet-50 adds every 3x3, the 64-input
# 1x1s, the ASPP branches, cls0 / cls1 and the classifier to int8_exec's 30
SITE_MODELS = {
    "v3plus_resnet50": ("deeplabv3plus", "resnet50", {}, 62),
    "v3plus_resnet50_stem": ("deeplabv3plus", "resnet50", {"stem": True}, 63),
    "v3_resnet50": ("deeplabv3", "resnet50", {}, 60),
    "v3plus_mobilenetv2_grouped": ("deeplabv3plus", "mobilenetv2", {"grouped": True}, 51),
    "v3plus_xception": ("deeplabv3plus", "xception", {}, 48),
    "v3plus_resnext50": ("deeplabv3plus", "resnext50_32x4d", {}, 53),
}


@pytest.mark.parametrize("name", sorted(SITE_MODELS))
def test_routed_sites_and_keys_equal_jax(traced_jq, name):
    head, backbone, flags, n_routed = SITE_MODELS[name]
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(np.float32)
    model, jmodel, params, stats = _crossed(head, backbone)
    jax_keys, jax_routed = _jax_sites(traced_jq, jmodel, params, stats, x, **flags)

    def port(key):
        return pq.port_site_key(key, backbone, head)

    scales = pq.calibrate_conv_inputs(model, [torch.from_numpy(x).permute(0, 3, 1, 2)],
                                      wide=True, **flags)
    fn = pq.make_variant_fn(model, "int8_exec_xla", conv_scales=scales, **flags)
    assert set(scales) == {port(k) for k in jax_keys}
    assert set(fn.routed_sites) == {port(k) for k in jax_routed}
    assert len(fn.routed_sites) == n_routed
    modules = dict(fn.model.named_modules())
    if head == "deeplabv3plus" and backbone != "xception":
        assert {"classifier.classifier.0#p0", "classifier.classifier.0#p1"} <= set(scales)
        assert isinstance(modules["classifier.classifier.0"], pq.Int8ConcatConvBN)
    if "stem" in flags:
        assert isinstance(modules["backbone.conv1"], pq.Int8Conv)
    if backbone == "resnext50_32x4d":  # block-diagonal below the gate of 256 only
        assert modules["backbone.layer2.0.conv2"].groups == 1
        assert not isinstance(modules["backbone.layer3.0.conv2"], pq.Int8Conv)


def test_missing_part_scale_keeps_cls0_unrouted(traced_jq):
    """A part without its scale: neither package routes the concat conv."""
    x = np.random.default_rng(2).normal(size=(1, 32, 32, 3)).astype(np.float32)
    model, jmodel, params, stats = _crossed("deeplabv3plus", "resnet18")
    jax_keys, jax_routed = _jax_sites(traced_jq, jmodel, params, stats, x,
                                      drop=("head/cls0#p1",))
    scales = {pq.port_site_key(k, "resnet18"): 1.0 for k in jax_keys if k != "head/cls0#p1"}
    fn = pq.make_variant_fn(model, "int8_exec_xla", conv_scales=scales)
    assert "head/cls0" not in jax_routed and "head/cls1/conv" in jax_routed
    assert set(fn.routed_sites) == {pq.port_site_key(k, "resnet18") for k in jax_routed}
    cls = fn.model.classifier.classifier
    assert isinstance(cls[0], torch.nn.Conv2d) and isinstance(cls[1], torch.nn.BatchNorm2d)
    assert isinstance(cls[3], pq.Int8Conv)


# ----------------------------------------------------------------- logits
def test_int8_exec_xla_logits_and_scales_match_jax():
    import jax.numpy as jnp

    from iswm_tpu.infer import quantization as jq

    model, jmodel, params, stats = _crossed("deeplabv3plus", "resnet18", seed=4)
    rng = np.random.default_rng(3)
    calib = rng.normal(size=(2, 1, 64, 64, 3)).astype(np.float32)
    jax_scales = jq.calibrate_conv_inputs(jmodel, params, stats, list(calib), wide=True,
                                          stem=True)
    scales = pq.calibrate_conv_inputs(
        model, [torch.from_numpy(c).permute(0, 3, 1, 2) for c in calib], wide=True, stem=True)
    want_scales = {pq.port_site_key(k, "resnet18"): s for k, s in jax_scales.items()}
    assert set(scales) == set(want_scales) and len(scales) == 31
    for key, scale in want_scales.items():
        np.testing.assert_allclose(scales[key], scale, rtol=1e-6, err_msg=key)

    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jfn = jq.make_variant_fn(jmodel, stats, params, "int8_exec_xla", conv_scales=jax_scales)
    want = np.asarray(jfn(jnp.asarray(x)))
    fn = pq.make_variant_fn(model, "int8_exec_xla", conv_scales=want_scales)
    got = fn(torch.from_numpy(x)).numpy()
    assert set(fn.routed_sites) == {pq.port_site_key(k, "resnet18") for k in jfn.routed_sites}
    assert "classifier.classifier.0" in fn.routed_sites and len(fn.routed_sites) == 29
    agree, _ = pq.logit_diff_verdict(got, want)
    assert agree >= 0.999
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    # int8 execution is there: the logits differ from weight-only int8's
    assert np.abs(got - pq.make_variant_fn(model, "int8")(torch.from_numpy(x)).numpy()).max() > 0


# ------------------------------------------------------------- entry points
@pytest.mark.parametrize("model,flag,routed", [("deeplabv3plus_resnet18", "--int8_stem", 30),
                                               ("deeplabv3plus_mobilenet", "--int8_grouped", 51)])
def test_predict_cli_serves_int8_exec_xla(tmp_path, monkeypatch, model, flag, routed):
    """The predict CLI -> Predictor -> the int8_exec_xla serving fn, with each
    opt-in route, on the CPU; with int8_exec the flags change nothing, as in
    the JAX package (its 1x1 backend has no such sites)."""
    from PIL import Image

    from iswm_tpu_torch.cli import predict
    from iswm_tpu_torch.infer import predictor

    rng = np.random.default_rng(5)
    (tmp_path / "in").mkdir()
    Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(tmp_path / "in/a.png")
    built = []

    def make_variant_fn(*args, **kwargs):  # the serving fn the Predictor builds
        built.append(pq.make_variant_fn(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(predictor, "make_variant_fn", make_variant_fn)
    args = ["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
            "--device", "cpu", "--model", model, "--compute_dtype", "float32",
            "--tile_size", "64", "--tile_overlap", "16", "--tile_batch", "2"]
    assert predict.main(args + ["--serving_variant", "int8_exec_xla", flag]) == 0
    assert (tmp_path / "out" / "a_predict.png").stat().st_size > 0
    (fn,) = built
    assert len(fn.routed_sites) == routed
    groups = {m.groups for m in fn.model.modules() if isinstance(m, pq.Int8Conv)}
    assert groups == ({1} if flag == "--int8_stem" else {1, 96, 144, 192, 384, 576, 960})
    assert predict.main(args + ["--serving_variant", "int8_exec", flag]) == 0
    routed = {type(m) for m in built[-1].model.modules()
              if isinstance(m, (pq.Int8Conv1x1, pq.Int8Conv, pq.Int8ConcatConvBN))}
    assert len(built) == 2 and built[-1].routed_sites and routed == {pq.Int8Conv1x1}


# ------------------------------------------------------------ on the card
def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


# (B, H, W, C, k, stride, pad, dilation, groups, N) for the card: the slice's
# odd shapes (K = 147 at the stem, N = 2 and 48, M = 8) and both gathers
CUDA_CONVS = {
    "stem_k147": (2, 30, 34, 3, 7, 2, 3, 1, 1, 64),
    "cls0_p0_k432": (2, 17, 19, 48, 3, 1, 1, 1, 1, 256),
    "classifier_n2_bias": (2, 9, 13, 256, 1, 1, 0, 1, 1, 2),
    "project_n48": (1, 33, 31, 256, 1, 1, 0, 1, 1, 48),
    "pool_m8": (8, 1, 1, 2048, 1, 1, 0, 1, 1, 256),
    "aspp_d6": (2, 12, 12, 512, 3, 1, 6, 6, 1, 256),
    "strided_c24": (3, 15, 15, 24, 3, 2, 1, 1, 1, 40),
    "depthwise": (2, 20, 18, 96, 3, 2, 2, 2, 96, 96),
    "grouped_bytes": (2, 11, 9, 30, 3, 1, 1, 1, 10, 20),
    "aspp_d12_32": (2, 32, 32, 256, 3, 1, 12, 12, 1, 256),
    "aspp_d18_32": (2, 32, 32, 256, 3, 1, 18, 18, 1, 256),
    "stride2_128": (1, 128, 128, 64, 3, 2, 1, 1, 1, 128),
    "row_1x1": (1, 1, 3000, 320, 1, 1, 0, 1, 1, 256),
    "n2_bias_3x3": (2, 16, 16, 64, 3, 1, 1, 1, 1, 2),
    "depthwise_s1_d2": (2, 32, 32, 576, 3, 1, 2, 2, 576, 576),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CONVS))
def test_cuda_convs_bit_equal_plain(case):
    """Each case in float32 and in bf16 output, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    b, h, w, c, k, stride, pad, dil, groups, n = CUDA_CONVS[case]
    rng = np.random.default_rng(len(case))
    x_q = _codes(rng, (b, h, w, c)).cuda()
    w_q = _codes(rng, (n, k, k, c // groups)).cuda()
    w_scale = torch.from_numpy(rng.random(n).astype(np.float32) * 0.01 + 1e-4).cuda()
    bias = torch.randn(n, device="cuda") if "bias" in case else None
    kw = dict(stride=stride, padding=pad, dilation=dil)
    for out_dtype in (torch.float32, torch.bfloat16):
        if groups == 1:
            before = k8c.launches_igemm
            got = k8c.conv_s8_igemm(x_q, w_q, w_scale, 0.0123, bias, out_dtype=out_dtype, **kw)
            count = k8c.launches_igemm - before
        else:
            before = k8c.launches_direct
            got = k8c.conv_s8_direct(x_q, w_q, w_scale, 0.0123, bias, groups=groups,
                                     out_dtype=out_dtype, **kw)
            count = k8c.launches_direct - before
        want = k8c.conv_s8_plain(x_q, w_q, w_scale, 0.0123, bias, groups=groups,
                                 out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        assert count == 1 and got.dtype == out_dtype and torch.equal(got, want), out_dtype


@pytest.mark.cuda
@pytest.mark.parametrize("x_scale", [0.25, 0.012345, 3e-39, 1e30])
def test_cuda_quantize_every_bf16_value(x_scale):
    """Every bf16 value (NaN aside), contiguous and as a channel slice of
    wider rows, gives the plain version's codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(256, 256).cuda()
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    for xt in (x, x.float(), x[:, 16:64], x[:, 3:10]):
        got = k8c.quantize_s8(xt, x_scale)
        torch.cuda.synchronize()
        assert torch.equal(got, k8c.quantize_s8_plain(xt, x_scale))
