"""The port's fused stem against the JAX package's, on the CPU in float32.

Inputs are made with numpy from a seed: an image [2, 3, 2S, 2S], a
[7, 7, 3, 64] conv kernel, BatchNorm gamma and beta.  The JAX side packs them
(``pack_stem_input``, the (2, 1) column pad, ``pack_stem_kernel``) and runs
``stem_fused_train`` / ``stem_fused_eval`` / ``stem_tail_bwd`` in Pallas
interpret mode, as ``tests/test_fused_stem.py`` does; the port runs the plain
PyTorch versions (what its wrappers run for a CPU tensor).  Tolerances:
forward rtol 1e-5 / atol 1e-5 (summation order of the conv and the
statistics); gradients rtol 1e-4, atol 1e-5 * max|grad|; the model's eval
logits 2e-4, its running statistics 1e-5.  The CUDA kernels are held against
the plain versions on the card, where there is no jax:
``python -m pytest --noconftest tests/test_torch_fused_stem.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from iswm_tpu_torch.config import ModelConfig
from iswm_tpu_torch.infer import quantization as pq
from iswm_tpu_torch.models import _resolve_fused_mode, build_model
from iswm_tpu_torch.ops.kernels import fused_stem as fs

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)

EPS = 1e-5
F32 = np.float32


def _inputs(s, b=2, seed=0):
    """(image NHWC, kernel HWIO, gamma, beta, pooled weights NHWC) in float32."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(b, 2 * s, 2 * s, 3)).astype(F32)
    kernel = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(F32)
    gamma = (rng.normal(size=64) * 0.5 + 1.0).astype(F32)
    beta = (rng.normal(size=64) * 0.1).astype(F32)
    w = rng.normal(size=(b, s // 2, s // 2, 64)).astype(F32)
    return image, kernel, gamma, beta, w


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_packed(image, kernel):
    """The JAX side's (xp_pad, kk) of an NHWC image and an HWIO kernel."""
    import jax.numpy as jnp

    from iswm_tpu.models.layers import pack_stem_input, pack_stem_kernel

    xp = pack_stem_input(jnp.asarray(image))
    return jnp.pad(xp, ((0, 0), (0, 0), (2, 1), (0, 0))), pack_stem_kernel(jnp.asarray(kernel), 7)


def _unpack_kernel(kk):
    """[4, 4, 12, 64] packed taps -> the [7, 7, 3, 64] kernel's entries (the
    inverse of ``pack_stem_kernel``, which pads one zero row and column)."""
    kk = np.asarray(kk).reshape(4, 4, 2, 2, 3, 64).transpose(0, 2, 1, 3, 4, 5)
    return kk.reshape(8, 8, 3, 64)[1:, 1:]


def _assert_close(got, want, rtol, atol_of_max):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("s", [32, 20])
def test_forward_matches_pallas(s):
    from iswm_tpu.ops.pallas.fused_stem import stem_fused_train

    image, kernel, gamma, beta, _ = _inputs(s)
    xp_pad, kk = _jax_packed(image, kernel)
    p_j, mean_j, var_j = stem_fused_train(xp_pad, kk, gamma, beta, EPS, True)
    p, mean, var = fs.stem_fused_train(_nchw(image), _oihw(kernel), torch.from_numpy(gamma),
                                       torch.from_numpy(beta), EPS)
    assert p.shape == (2, 64, s // 2, s // 2) and p.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(p), p_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), mean_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), var_j, rtol=1e-5, atol=1e-5)
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("s", [32, 20])  # 20: ragged against every tile of the CUDA kernels
def test_gradients_match_jax_grad_through_the_packed_path(s):
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models.layers import pack_stem_kernel
    from iswm_tpu.ops.pallas.fused_stem import stem_fused_train

    image, kernel, gamma, beta, w = _inputs(s)
    xp_pad, _ = _jax_packed(image, kernel)

    def loss(kernel, gamma, beta):
        p, _, _ = stem_fused_train(xp_pad, pack_stem_kernel(kernel, 7), gamma, beta, EPS, True)
        return jnp.sum(p * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(kernel), jnp.asarray(gamma),
                                             jnp.asarray(beta))
    leaves = [t.requires_grad_() for t in (_oihw(kernel), torch.from_numpy(gamma),
                                           torch.from_numpy(beta))]
    p, _, _ = fs.stem_fused_train(_nchw(image), *leaves, EPS)
    (p * _nchw(w)).sum().backward()
    _assert_close(leaves[0].grad.permute(2, 3, 1, 0).numpy(), want[0], 1e-4, 1e-5)
    _assert_close(leaves[1].grad.numpy(), want[1], 1e-4, 1e-5)
    _assert_close(leaves[2].grad.numpy(), want[2], 1e-4, 1e-5)


def test_eval_matches_pallas():
    from iswm_tpu.ops.pallas.fused_stem import stem_fused_eval

    image, kernel, gamma, beta, _ = _inputs(32, seed=1)
    xp_pad, kk = _jax_packed(image, kernel)
    scale, bias = gamma * 0.7, beta - 0.2
    want = stem_fused_eval(xp_pad, kk, scale, bias, interpret=True)
    got = fs.stem_fused_eval(_nchw(image), _oihw(kernel), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_equal_split_ties_match_pallas_and_keep_the_gradient_mass():
    """Integer-valued z: most windows hold their maximum several times, and
    every tying position gets dp / count, as in the TPU kernel."""
    from iswm_tpu.ops.pallas.fused_stem import stem_tail_bwd

    rng = np.random.default_rng(0)
    b, s = 2, 16
    z = rng.integers(0, 3, size=(b, s, s, 64)).astype(F32)
    image = rng.normal(size=(b, 2 * s, 2 * s, 3)).astype(F32)
    dp = rng.normal(size=(b, s // 2, s // 2, 64)).astype(F32)
    gamma, beta = np.ones(64, F32), np.full(64, 5.0, F32)  # the ReLU mask all open
    mu, si = np.zeros(64, F32), np.ones(64, F32)
    xp_pad, _ = _jax_packed(image, np.zeros((7, 7, 3, 64), F32))
    dw_j, dgamma_j, dbeta_j = stem_tail_bwd(z, xp_pad, dp, gamma, beta, mu, si, interpret=True)
    dw, dgamma, dbeta = fs.stem_tail_bwd(
        _nchw(z), _nchw(image), _nchw(dp),
        *(torch.from_numpy(v) for v in (gamma, beta, mu, si)))
    _assert_close(dgamma.numpy(), dgamma_j, 1e-5, 1e-5)
    _assert_close(dbeta.numpy(), dbeta_j, 1e-5, 1e-5)
    _assert_close(dw.permute(2, 3, 1, 0).numpy(), _unpack_kernel(dw_j), 1e-4, 1e-5)
    # equal-split conserves every window's mass: dbeta = sum dp
    np.testing.assert_allclose(dbeta.numpy(), dp.sum((0, 1, 2)), rtol=1e-5, atol=1e-5)
    # and it is not the first-index routing of F.max_pool2d's autograd
    y = (_nchw(z) + 5.0).requires_grad_()
    torch.nn.functional.max_pool2d(y, 3, 2, 1).backward(_nchw(dp))
    d_bn, _ = fs._bwd_terms(_nchw(z), _nchw(dp), torch.ones(64), torch.full((64,), 5.0),
                            torch.zeros(64), torch.ones(64))
    assert (d_bn - y.grad).abs().max() > 0.1
    torch.testing.assert_close(d_bn.sum((0, 2, 3)), y.grad.sum((0, 2, 3)), rtol=1e-4, atol=1e-4)


def test_image_cotangent_is_nan_when_asked_for_and_none_otherwise():
    image, kernel, gamma, beta, w = _inputs(8, b=1)
    x = _nchw(image).requires_grad_()
    weight = _oihw(kernel).requires_grad_()
    p, _, _ = fs.stem_fused_train(x, weight, torch.from_numpy(gamma), torch.from_numpy(beta), EPS)
    (p * _nchw(w)).sum().backward()
    assert x.grad.shape == x.shape and torch.isnan(x.grad).all()
    assert torch.isfinite(weight.grad).all()
    p, _, _ = fs.stem_fused_train(x.detach(), weight, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), EPS)
    grads = fs.StemFusedTrain.backward(p.grad_fn, _nchw(w), None, None)
    assert grads[0] is None and grads[1].shape == weight.shape and grads[4:] == (None, None)


def test_eval_forward_runs_with_grad_enabled_and_refuses_a_backward():
    """As differentiating the JAX eval kernel raises: no silent zero gradient
    for conv1 and bn1 of a model fine-tuned with bn1 in eval mode."""
    model = build_model(_fused_cfg("always"))
    out = model(torch.zeros(1, 3, 32, 32))
    assert out.requires_grad and torch.isfinite(out).all()
    with pytest.raises(RuntimeError, match="eval forward has no backward"):
        out.sum().backward()


def test_wrappers_run_plain_for_cpu_tensors_without_counting():
    image, kernel, gamma, beta, w = _inputs(8, b=1)
    before = (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums, fs.launches_bwd_wgrad)
    weight = _oihw(kernel).requires_grad_()
    p, _, _ = fs.stem_fused_train(_nchw(image), weight, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), EPS)
    p.sum().backward()
    assert before == (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums,
                      fs.launches_bwd_wgrad)
    with pytest.raises(ValueError, match="S even"):
        fs.stem_stats(torch.zeros(1, 64, 5, 5))
    with pytest.raises(ValueError, match="does not match"):
        fs.stem_bwd_sums(torch.zeros(1, 64, 8, 8), torch.zeros(1, 64, 3, 3),
                         *(torch.ones(64),) * 4)


# ------------------------------------------------------------------ the model
def _fused_cfg(mode, backbone="resnet18"):
    cfg = ModelConfig(backbone=backbone, compute_dtype="float32")
    cfg.fused_stem = mode
    return cfg


@pytest.fixture(scope="module")
def crossed_fused(tmp_path_factory):
    """(JAX fused model, JAX variables, port fused model, port unfused model)
    sharing one perturbed .pth, resnet18 with ``fused_stem="interpret"``."""
    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.models import build_model as build_jax_model
    from iswm_tpu_torch.compat import load_checkpoint

    from .test_torch_models import crossed_models

    _, variables, unfused, ckpt = crossed_models(tmp_path_factory.mktemp("ckpt"), "resnet18", 16)
    jcfg = JaxModelConfig(backbone="resnet18", compute_dtype="float32")
    jcfg.fused_stem = "interpret"
    fused = build_model(_fused_cfg("interpret"))
    fused.load_state_dict(load_checkpoint(ckpt), strict=True)
    return build_jax_model(jcfg), variables, fused, unfused


def test_fused_model_keeps_the_keys_and_matches_jax_in_eval(crossed_fused):
    jmodel, variables, fused, unfused = crossed_fused
    assert list(fused.state_dict()) == list(unfused.state_dict())
    assert {k for k in fused.state_dict() if k.startswith(("backbone.conv1", "backbone.bn1"))} == {
        "backbone.conv1.weight", "backbone.bn1.weight", "backbone.bn1.bias",
        "backbone.bn1.running_mean", "backbone.bn1.running_var",
        "backbone.bn1.num_batches_tracked"}
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(F32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = _nhwc(fused(_nchw(x)))
        plain = _nhwc(unfused(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


def test_fused_model_updates_running_statistics_as_jax(crossed_fused):
    import copy

    import jax

    from iswm_tpu_torch.compat import state_dict_from_jax

    jmodel, variables, fused, _ = crossed_fused
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(F32)
    _, mutated = jmodel.apply(variables, x, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(1)})
    want = state_dict_from_jax(variables["params"], mutated["batch_stats"], backbone="resnet18")
    model = copy.deepcopy(fused).train()
    with torch.no_grad():
        model(_nchw(x))
    bn = model.backbone.bn1
    np.testing.assert_allclose(bn.running_mean.numpy(), want["backbone.bn1.running_mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want["backbone.bn1.running_var"],
                               rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == int(fused.backbone.bn1.num_batches_tracked) + 1
    assert not torch.equal(bn.running_var, fused.backbone.bn1.running_var)


def test_checkpoints_interchange_between_fused_and_unfused(crossed_fused):
    _, _, fused, unfused = crossed_fused
    build_model(_fused_cfg("never")).load_state_dict(fused.state_dict(), strict=True)
    build_model(_fused_cfg("always")).load_state_dict(unfused.state_dict(), strict=True)


def _stem_calls(model):
    calls = []
    handle = model.backbone.fused_stem_pool.register_forward_hook(lambda *a: calls.append(1))
    return calls, handle


def test_ineligible_input_takes_the_unfused_stem(crossed_fused):
    _, _, fused, unfused = crossed_fused
    calls, handle = _stem_calls(fused)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 3, 30, 34)).astype(F32))
    with torch.no_grad():
        assert torch.equal(fused(x), unfused(x)) and not calls
        fused(torch.zeros(1, 3, 32, 32))
    handle.remove()
    assert len(calls) == 1


def test_auto_fuses_on_a_cuda_tensor_only():
    model = build_model(_fused_cfg("auto"))
    calls, handle = _stem_calls(model)
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32))
    handle.remove()
    assert not calls and not model.backbone.fuses_stem_on(torch.device("cpu"))
    assert model.backbone.fuses_stem_on(torch.device("cuda"))


@pytest.mark.parametrize("value", ["never", "auto", "always", "interpret", "sometimes"])
def test_resolve_fused_mode(value):
    if value == "sometimes":
        with pytest.raises(ValueError, match="unknown fused_stem setting 'sometimes'"):
            _resolve_fused_mode(value, "fused_stem")
        with pytest.raises(ValueError, match="unknown fused_stem setting"):
            build_model(_fused_cfg(value))
        return
    assert _resolve_fused_mode(value, "fused_stem") == value
    assert build_model(_fused_cfg(value)).backbone.fused_stem == value
    assert ModelConfig().fused_stem == "never"


def test_int8_act_sites_drop_the_stem_when_fused_as_in_jax():
    import jax.numpy as jnp

    from iswm_tpu.config import ModelConfig as JaxModelConfig
    from iswm_tpu.infer import quantization as jq
    from iswm_tpu.models import build_model as build_jax_model

    from .test_torch_models import jax_init

    _, _, params, stats = jax_init("resnet18", 16)
    jcfg = JaxModelConfig(backbone="resnet18", compute_dtype="float32")
    jcfg.fused_stem = "interpret"
    x = np.zeros((1, 32, 32, 3), F32)
    keys = jq.calibrate_activations(build_jax_model(jcfg), params, stats, [jnp.asarray(x)])
    assert "backbone/stem" not in keys
    fused, unfused = build_model(_fused_cfg("interpret")), build_model(_fused_cfg("never"))
    sites = pq.activation_sites(fused)
    assert {pq.port_act_site_key(k) for k in keys} == set(sites)
    assert set(pq.activation_sites(unfused)) - set(sites) == {"backbone.conv1"}
    scales = pq.calibrate_activations(fused, [torch.zeros(1, 3, 32, 32)])
    assert set(scales) == set(sites) and len(sites) == 27
    out = pq.make_variant_fn(fused, "int8_act", act_scales=scales)(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 2) and torch.isfinite(out).all()


# ---------------------------------------------------------------- on the card
def _cuda_case(s, dtype, channels_last, b=2, seed=5):
    image, _, gamma, beta, w = _inputs(s, b=b, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = torch.from_numpy((rng.normal(size=(b, 64, s, s)) * 1.5).astype(F32)).cuda().to(dtype)
    x, dp = _nchw(image).cuda().to(dtype), _nchw(w).cuda().to(dtype)
    if channels_last:
        z, x, dp = (t.contiguous(memory_format=torch.channels_last) for t in (z, x, dp))
    return z, x, dp, torch.from_numpy(gamma).cuda(), torch.from_numpy(beta).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype,channels_last,b", [
    (32, torch.bfloat16, True, 2), (20, torch.float32, True, 2), (44, torch.bfloat16, False, 2),
    (8, torch.float32, False, 2),
    # the bf16 body's 8 x 32 tiles: ragged in rows and columns, in columns alone,
    # and 16 tiles an image
    (36, torch.bfloat16, True, 2), (40, torch.bfloat16, False, 2), (64, torch.bfloat16, True, 3),
])
def test_cuda_kernels_match_plain(s, dtype, channels_last, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    z, x, dp, gamma, beta = _cuda_case(s, dtype, channels_last, b=b)
    n = z.numel() // 64
    before = (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums, fs.launches_bwd_wgrad)

    def close(got, want):  # float32 sums in another order than the float64 ones
        return (got.double() - want).abs().max() <= 1e-5 * want.abs().max()

    total, total_sq = fs.stem_stats(z)
    want = fs.stem_stats_plain(z, dtype=torch.float64)
    assert close(total, want[0]) and close(total_sq, want[1])
    mean = total / n
    sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + EPS)
    scale, bias = fs.fold_affine(gamma, beta, mean, sigma_inv)
    pooled = fs.stem_norm_relu_pool(z, scale, bias)
    assert pooled.dtype == dtype
    assert torch.equal(pooled, fs.stem_norm_relu_pool_plain(z, scale, bias))
    args = (z, dp, scale, bias, mean, sigma_inv)
    s1, s2 = fs.stem_bwd_sums(*args)
    want = fs.stem_bwd_sums_plain(*args, dtype=torch.float64)
    assert close(s1, want[0]) and close(s2, want[1])
    assert all(torch.equal(a, b) for a, b in zip((s1, s2), fs.stem_bwd_sums(*args)))
    wargs = (z, dp, x, scale, bias, mean, sigma_inv, s1 / n, s2 / n)
    dw = fs.stem_bwd_wgrad(*wargs)
    assert close(dw, fs.stem_bwd_wgrad_plain(*wargs, dtype=torch.float64))
    assert torch.equal(dw, fs.stem_bwd_wgrad(*wargs))  # bit-stable
    torch.cuda.synchronize()
    assert (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums,
            fs.launches_bwd_wgrad) == (before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 2)


@pytest.mark.cuda
def test_cuda_fused_train_matches_its_plain_version_and_runs_in_the_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    image, kernel, gamma, beta, w = _inputs(32, seed=7)
    x = _nchw(image).cuda().contiguous(memory_format=torch.channels_last)
    leaves = [t.cuda().requires_grad_() for t in (_oihw(kernel), torch.from_numpy(gamma),
                                                  torch.from_numpy(beta))]
    dp = _nchw(w).cuda()
    before = fs.launches_bwd_wgrad
    p, mean, var = fs.stem_fused_train(x, *leaves, EPS)
    (p * dp).sum().backward()
    assert fs.launches_bwd_wgrad - before == 1
    # the same chain through the plain versions, on the card
    with torch.no_grad():
        z = fs._stem_conv(x, leaves[0])
        n = z.numel() // 64
        total, total_sq = fs.stem_stats_plain(z)
        mean_p = total / n
        var_p = torch.clamp_min(total_sq / n - mean_p * mean_p, 0.0)
        sigma_inv = torch.rsqrt(var_p + EPS)
        scale, bias = fs.fold_affine(leaves[1], leaves[2], mean_p, sigma_inv)
        p_p = fs.stem_norm_relu_pool_plain(z, scale, bias)
        args = (scale, bias, mean_p, sigma_inv)
        s1, s2 = fs.stem_bwd_sums_plain(z, dp, *args)
        dw = fs.stem_bwd_wgrad_plain(z, dp, x, *args, s1 / n, s2 / n, dtype=torch.float64)
    # the two statistics are summed in another order, so scale and bias, and
    # with them every output, differ in the last bits
    for got, want in zip((p.detach(), mean, var, *(t.grad for t in leaves)),
                         (p_p, mean_p, var_p, dw, s2, s1)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()

    model = build_model(_fused_cfg("always")).cuda().to(memory_format=torch.channels_last)
    before = (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums, fs.launches_bwd_wgrad)
    model.train()(torch.randn(2, 3, 64, 64, device="cuda")).square().mean().backward()
    model.eval()(torch.randn(2, 3, 64, 64, device="cuda"))
    assert torch.isfinite(model.backbone.conv1.weight.grad).all()
    assert (fs.launches_stats, fs.launches_pool, fs.launches_bwd_sums,
            fs.launches_bwd_wgrad) == (before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 1)
    with pytest.raises(ValueError, match="64 channels"):
        fs.stem_stats(torch.zeros(1, 32, 8, 8, device="cuda"))
    with pytest.raises(TypeError, match="bf16 or f32"):
        fs.stem_stats(torch.zeros(1, 64, 8, 8, device="cuda", dtype=torch.float16))
