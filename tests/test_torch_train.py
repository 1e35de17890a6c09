"""The port's training pieces against the JAX package's, on the CPU.

- Train-mode BatchNorm: running statistics after one forward equal the
  ``batch_stats`` flax returns (running_var within 1e-5 * max|var| of each
  tensor, running_mean within 1e-5 * max sqrt(var), the channel scale: a
  batch mean near 0 carries the summation-order error of values far from
  0); batch 1 runs and the pooling branch gives its bias.
- Optimizer and schedule against optax over 30 steps, past ``total_itrs``.
- The augmentation resample given JAX's own draws (image atol 1e-5, labels
  equal), and the range and frequency of the port's draws.
- Synthetic scenes, datasets, batches and class weights equal to JAX's.
- Dropout rate and scaling; options the port refuses.
"""

import numpy as np
import pytest
import torch

from iswm_tpu.config import Config, OptimConfig
from iswm_tpu_torch.compat import state_dict_from_jax
from iswm_tpu_torch.data import (
    ArrayDataset,
    AugmentConfig,
    BinarySegmentation,
    augment_resample,
    batch_iterator,
    calculate_class_weights,
    draw_augment_params,
    generate_scene,
    write_dataset,
)
from iswm_tpu_torch.data.loader import device_prefetch_iterator
from iswm_tpu_torch.data.synthetic import generate_sequence
from iswm_tpu_torch.models import build_model_by_name
from iswm_tpu_torch.models.layers import BatchNorm2d
from iswm_tpu_torch.train import Trainer, make_optimizer, refuse_unported

from ._torch_threads import few_torch_threads  # noqa: F401  (an autouse fixture)
from .test_torch_models import crossed_models


def assert_bn_stats_close(port_sd, jax_sd, tol=1e-5):
    """running_var within tol * max|var|, running_mean within tol * max
    sqrt(var), per BatchNorm; returns the number of BatchNorms compared."""
    n = 0
    for k, var_j in jax_sd.items():
        if not k.endswith("running_var"):
            continue
        mk = k.replace("running_var", "running_mean")
        var_j, mean_j = np.asarray(var_j), np.asarray(jax_sd[mk])
        var_p, mean_p = port_sd[k].numpy(), port_sd[mk].numpy()
        assert np.abs(var_p - var_j).max() <= tol * np.abs(var_j).max(), k
        assert np.abs(mean_p - mean_j).max() <= tol * np.sqrt(var_j).max(), mk
        n += 1
    return n


def dropout_off(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def _no_dropout(monkeypatch, model):
    """Dropout off on both sides: flax's ``Dropout`` as the identity, the
    port's ``p = 0`` (the two cannot share a random stream)."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    dropout_off(model)


def _train_forward(tmp_path, monkeypatch, batch):
    import jax

    jmodel, variables, model, _ = crossed_models(tmp_path, "resnet18", 16)
    _no_dropout(monkeypatch, model)
    x = np.random.default_rng(1).normal(size=(batch, 32, 32, 3)).astype(np.float32)
    _, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    want = state_dict_from_jax(variables["params"], mutated["batch_stats"],
                               backbone="resnet18")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return model, before, want, out


def test_train_mode_batchnorm_matches_flax(tmp_path, monkeypatch):
    """One train-mode forward updates the running statistics as flax does:
    momentum 0.9 and the BIASED batch variance (``nn.BatchNorm2d`` takes the
    unbiased one, off by a factor n / (n - 1))."""
    model, before, want, out = _train_forward(tmp_path, monkeypatch, batch=2)
    assert tuple(out.shape) == (2, 2, 32, 32) and torch.isfinite(out).all()
    sd = model.state_dict()
    assert assert_bn_stats_close(sd, want) == sum(
        isinstance(m, BatchNorm2d) for m in model.modules())
    # the statistics moved: this is not the identity
    assert not torch.equal(sd["backbone.bn1.running_var"], before["backbone.bn1.running_var"])
    bn = model.backbone.bn1
    assert bn.momentum == pytest.approx(0.1) and bn.eps == 1e-5


def test_train_mode_batchnorm_at_batch_one(tmp_path, monkeypatch):
    """Batch 1: the ASPP pooling branch's BatchNorm sees one value per
    channel; flax gives variance 0 and the output ``bias`` (nn.BatchNorm2d
    raises).  Running statistics equal flax's within 1e-4: the ASPP's
    BatchNorms see 4 values per channel here, and normalizing by the
    variance of so few values magnifies the summation-order differences
    (up to 3.7e-5 measured)."""
    model, _, want, out = _train_forward(tmp_path, monkeypatch, batch=1)
    assert tuple(out.shape) == (1, 2, 32, 32) and torch.isfinite(out).all()
    assert_bn_stats_close(model.state_dict(), want, tol=1e-4)
    bn = model.classifier.aspp.convs[4][2]
    seen = []
    hook = bn.register_forward_hook(lambda m, i, o: seen.append(o.clone()))
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32))
    hook.remove()
    assert torch.equal(seen[0].reshape(-1), bn.bias.detach())


def test_batchnorm_gradient_matches_nn_batchnorm():
    """The repaired train-mode BN back-propagates as ``nn.BatchNorm2d`` does
    (the output uses the biased variance in both)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, 6, generator=gen)
    ours, ref = BatchNorm2d(5), torch.nn.BatchNorm2d(5)
    for m in (ours, ref):
        with torch.no_grad():
            m.weight.copy_(torch.linspace(0.5, 1.5, 5))
            m.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya, yb = ours.train()(xa), ref.train()(xb)
    w = torch.randn(ya.shape, generator=gen)
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    torch.testing.assert_close(ya, yb, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ours.weight.grad, ref.weight.grad, rtol=1e-5, atol=1e-6)
    n = 3 * 4 * 6  # biased vs unbiased running variance
    torch.testing.assert_close(ours.running_var - 0.9, (ref.running_var - 0.9) * (n - 1) / n)


# ----------------------------------------------------- optimizer + schedule
STEPS, TOTAL, LR, WD = 30, 20, 0.05, 1e-4


def _problem():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal((3, 16)).astype(np.float32),
            rng.standard_normal((4, 16)).astype(np.float32))


def _optim_cfg(opt_name, schedule):
    return OptimConfig(optimizer=opt_name, lr=LR, weight_decay=WD, schedule=schedule,
                       momentum=0.9, nesterov=True, cosine_min_factor=0.01,
                       poly_power=0.9, poly_min_lr=1e-3)


@pytest.mark.parametrize("schedule", ["cosine", "poly"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam", "adamw"])
def test_optimizer_and_schedule_match_optax(opt_name, schedule):
    """30 steps with ``total_itrs`` 20: parameters within rtol 2e-4 / atol
    2e-5 of optax's (float32 round-off over 30 steps), each step's LR within
    rtol 1e-5 of optax's schedule (float32 there, float64 here)."""
    import jax
    import jax.numpy as jnp
    import optax

    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer

    cfg = _optim_cfg(opt_name, schedule)
    w0, x, y = _problem()
    tx, jax_schedule = jax_make_optimizer(cfg, TOTAL)
    w = jnp.asarray(w0)
    opt_state = tx.init(w)
    grad_fn = jax.jit(jax.grad(lambda w: 0.5 * jnp.sum((w @ x - y) ** 2)))
    want = []
    for _ in range(STEPS):
        updates, opt_state = tx.update(grad_fn(w), opt_state, w)
        w = optax.apply_updates(w, updates)
        want.append(np.asarray(w))

    factory, schedule_fn = make_optimizer(cfg, TOTAL)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = factory([p])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = []
    for step in range(STEPS):
        lr = opt.param_groups[0]["lr"]
        assert lr == pytest.approx(schedule_fn(step), rel=1e-12)
        assert lr == pytest.approx(float(jax_schedule(step)), rel=1e-5), step
        opt.zero_grad()
        (0.5 * ((p @ xt - yt) ** 2).sum()).backward()
        opt.step()
        sched.step()
        got.append(p.detach().numpy().copy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=2e-4, atol=2e-5)
    # past total_itrs the schedule holds its floor
    floor = LR * 0.01 if schedule == "cosine" else cfg.poly_min_lr
    assert schedule_fn(STEPS) == pytest.approx(floor) == schedule_fn(TOTAL + 1)


# ------------------------------------------------------------- augmentation
AUG = AugmentConfig(crop_size=32, scale_min=0.5, scale_max=2.0, hflip_prob=0.5)


def _jax_draws(key, h, w, cfg):
    """The four values ``augment_sample`` draws from ``key``
    (iswm_tpu/data/transforms.py:104-131), replayed."""
    import jax
    import jax.numpy as jnp

    k_scale, k_top, k_left, k_flip = jax.random.split(key, 4)
    scale = jax.random.uniform(k_scale, (), minval=cfg.scale_min, maxval=cfg.scale_max)
    sh = jnp.floor(h * scale).astype(jnp.int32)
    sw = jnp.floor(w * scale).astype(jnp.int32)

    def offset(k, scaled, target):
        big = jax.random.randint(k, (), 0, jnp.maximum(scaled - target, 0) + 1)
        return jnp.where(scaled >= target, big, (scaled - target) // 2).astype(jnp.float32)

    flip = jax.random.uniform(k_flip) < cfg.hflip_prob
    return (np.float32(scale), np.float32(offset(k_top, sh, cfg.crop_size)),
            np.float32(offset(k_left, sw, cfg.crop_size)), bool(flip))


def test_augment_resample_matches_jax_given_its_draws():
    """The port's resample from JAX's four draws equals ``augment_sample``:
    image within atol 1e-5, labels equal.  24 keys cover crop and pad,
    flip and no flip."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.data.transforms import AugmentConfig as JaxAug
    from iswm_tpu.data.transforms import augment_sample

    jcfg = JaxAug(*AUG)
    h, w = 40, 48
    rng = np.random.default_rng(5)
    image = rng.random((h, w, 3)).astype(np.float32)
    label = rng.integers(0, 2, (h, w)).astype(np.uint8)
    label[rng.random((h, w)) < 0.05] = 255
    sample = jax.jit(lambda k: augment_sample(k, jnp.asarray(image), jnp.asarray(label), jcfg))
    kinds = set()
    for seed in range(24):
        key = jax.random.key(seed)
        scale, top, left, flip = _jax_draws(key, h, w, AUG)
        kinds.add((np.floor(h * scale) >= AUG.crop_size, flip))
        want_img, want_lbl = map(np.asarray, sample(key))
        got_img, got_lbl = augment_resample(
            torch.from_numpy(image)[None], torch.from_numpy(label)[None],
            torch.tensor([scale]), torch.tensor([top]), torch.tensor([left]),
            torch.tensor([flip]), AUG)
        assert got_img.shape == (1, 32, 32, 3) and got_lbl.dtype == torch.uint8
        np.testing.assert_allclose(got_img[0].numpy(), want_img, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_lbl[0].numpy(), want_lbl)
    assert len(kinds) == 4  # crop/pad x flip/no flip


def test_augment_draws_range_and_frequency():
    """scale ~ U(0.5, 2); offsets uniform over {0 .. scaled - crop} when the
    scaled side covers the crop, centred otherwise; flip with p 0.5."""
    n, h, w = 20000, 40, 48
    scale, top, left, flip = draw_augment_params(
        n, h, w, AUG, torch.Generator().manual_seed(0))
    assert scale.min() >= 0.5 and scale.max() < 2.0
    assert abs(float(scale.mean()) - 1.25) < 0.01
    assert abs(float(flip.float().mean()) - 0.5) < 0.015
    for side, off in ((h, top), (w, left)):
        span = torch.floor(side * scale).long() - AUG.crop_size
        big = span >= 0
        assert torch.equal(off[~big], torch.div(span[~big], 2, rounding_mode="floor").float())
        assert (off[big] >= 0).all() and (off[big] <= span[big]).all()
        assert torch.equal(off, off.floor())
        frac = off[big & (span > 0)] / span[big & (span > 0)]
        assert abs(float(frac.mean()) - 0.5) < 0.02
    # the same generator state gives the same draws
    again = draw_augment_params(n, h, w, AUG, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip((scale, top, left, flip), again))


# ---------------------------------------------------------------- data
def test_synthetic_scenes_equal_jax():
    from iswm_tpu.data import synthetic as js

    for seed in (0, 3):
        for size in ((64, 48), (200, 200)):
            got = generate_scene(np.random.default_rng(seed), size=size)
            want = js.generate_scene(np.random.default_rng(seed), size=size)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got = generate_sequence(np.random.default_rng(1), length=3, size=(40, 40))
    want = js.generate_sequence(np.random.default_rng(1), length=3, size=(40, 40))
    assert all(np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


def test_datasets_and_batches_equal_jax(tmp_path):
    from iswm_tpu.data import datasets as jd

    write_dataset(str(tmp_path), n_train=5, n_val=2, size=(24, 32), seed=4)
    ours, theirs = BinarySegmentation(str(tmp_path)), jd.BinarySegmentation(str(tmp_path))
    assert ours.images == theirs.images and len(ours) == 5
    for a, b in zip(batch_iterator(ours, 2, shuffle=True, seed=9, epochs=2),
                    jd.batch_iterator(theirs, 2, shuffle=True, seed=9, epochs=2)):
        assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    images, masks = zip(*(ours[i] for i in range(len(ours))))
    mem = ArrayDataset(np.stack(images), np.stack(masks))
    assert len(mem) == 5 and mem.images == sorted(mem.images)
    img, mask = mem[3]
    assert img.dtype == mask.dtype == np.uint8 and img.shape == (24, 32, 3)
    assert np.array_equal(img, ours[3][0]) and set(np.unique(mask)) <= {0, 1}
    with pytest.raises(ValueError):
        ArrayDataset(np.stack(images), np.stack(masks)[:2])


def test_class_weights_equal_jax():
    from iswm_tpu.data.class_weights import calculate_class_weights as jax_cw

    rng = np.random.default_rng(2)
    batches = [(rng.random((2, 16, 16)) < 0.1).astype(np.uint8) for _ in range(3)]
    batches[1][0, :2] = 255
    want = jax_cw(batches)
    np.testing.assert_array_equal(calculate_class_weights(batches), want)
    np.testing.assert_array_equal(
        calculate_class_weights(torch.from_numpy(b) for b in batches), want)
    np.testing.assert_array_equal(calculate_class_weights([np.zeros((2, 4), np.uint8)]),
                                  [1.0, 1.0])


def test_prefetch_iterator_yields_the_batches_in_order():
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (6, 8, 8, 3), dtype=np.uint8),
                      rng.integers(0, 2, (6, 8, 8), dtype=np.uint8))
    want = list(batch_iterator(ds, 2, shuffle=True, seed=1, epochs=2))
    got = list(device_prefetch_iterator(
        batch_iterator(ds, 2, shuffle=True, seed=1, epochs=2), device="cpu", depth=2))
    assert len(got) == len(want) == 6
    for (gi, gl), (wi, wl) in zip(got, want):
        assert isinstance(gi, torch.Tensor) and np.array_equal(gi.numpy(), wi)
        assert np.array_equal(gl.numpy(), wl)

    def broken():
        yield want[0]
        raise OSError("unreadable file")

    with pytest.raises(OSError, match="unreadable"):
        list(device_prefetch_iterator(broken(), device="cpu"))


# --------------------------------------------------------- model + options
def test_dropout_rate_and_scaling():
    """The ASPP projection's dropout: flax's rate (0.1), and in train mode
    the kept values are scaled by 1 / (1 - p)."""
    from iswm_tpu.models.deeplab import ASPP as JaxASPP
    from iswm_tpu_torch.models import build_model_by_name

    model = build_model_by_name("deeplabv3plus_resnet18", compute_dtype="float32")
    (drop,) = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert drop.p == JaxASPP.dropout_rate == 0.1
    torch.manual_seed(0)
    out = drop.train()(torch.ones(200_000))
    kept = out[out != 0]
    assert abs(1 - kept.numel() / out.numel() - 0.1) < 0.005
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))


# the options once refused under parallel.model_axis = 2, and the Config
# fields they set (the fused modes: ported to the split, where each fused
# kernel runs on the model group's whole map); "devices" is the model axis
# alone.  One process refuses each only as the JAX package's make_mesh
# refuses a model axis that does not divide the devices
REFUSED = {
    "devices": (),
    "fused_stem": (("model", "fused_stem", "always"),),
    "fused_blocks": (("model", "fused_blocks", "interpret"),),
}
# the options refused there before they were ported to the split (a 2-rank
# Trainer takes each: tests/test_torch_parallel.py)
SPATIAL_OPTIONS = {
    "mobilenetv2": (("model", "backbone", "mobilenetv2"),),
    "xception": (("model", "backbone", "xception"),),
    "int8_training": (("model", "int8_training", 64),),
    "int8_training_bwd": (("model", "int8_training", 64), ("model", "int8_training_bwd", True)),
    "remat": (("parallel", "remat", True),),
}


@pytest.mark.parametrize("name", sorted(SPATIAL_OPTIONS))
def test_spatial_options_pass_refuse_unported(name):
    cfg = Config()
    cfg.parallel.model_axis = 2
    for section, key, value in SPATIAL_OPTIONS[name]:
        setattr(getattr(cfg, section), key, value)
    refuse_unported(cfg)
    cfg.model.fused_stem = cfg.model.fused_blocks = "always"  # and with the fused modes
    refuse_unported(cfg)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_options_are_refused(name):
    """Under a model axis of 2 nothing is refused as unported (the 2-rank
    Trainers of tests/test_torch_parallel.py take a step with the fused
    modes): one process builds no Trainer only because the model axis does
    not divide its one device."""
    cfg = Config()
    refuse_unported(cfg)  # the defaults pass
    cfg.parallel.model_axis = 2
    refuse_unported(cfg)  # and the spatial model axis with them
    for section, key, value in REFUSED[name]:
        setattr(getattr(cfg, section), key, value)
    refuse_unported(cfg)
    with pytest.raises(ValueError, match=r"^model_axis 2 must divide device count 1$"):
        Trainer(cfg, device="cpu")


# the training options these tests refused before they were ported, and which
# Config fields they set (after resnet18 in float32); the last two combine
# them with the fused stem and blocks, and with QAT switched off after step 1
TRAIN_OPTIONS = {
    "remat": (("parallel", "remat", True),),
    "param_dtype": (("model", "param_dtype", "bfloat16"),),
    "remat_fused_bf16": (("parallel", "remat", True), ("model", "param_dtype", "bfloat16"),
                         ("model", "backbone", "resnet50"), ("model", "fused_stem", "always"),
                         ("model", "fused_blocks", "always")),
    "remat_qat_switch": (("parallel", "remat", True), ("model", "param_dtype", "float16"),
                         ("model", "int8_training", 64), ("model", "int8_scale_mode", "delayed"),
                         ("model", "int8_training_bwd", True), ("train", "int8_switch_iter", 1)),
}


@pytest.mark.parametrize("name", sorted(TRAIN_OPTIONS))
def test_training_options_are_accepted(name, tmp_path):
    """``parallel.remat`` and ``model.param_dtype`` pass ``refuse_unported``
    and build a Trainer whose step trains: two steps from uint8 images (with
    ``int8_switch_iter``, QAT switched off between them, as ``fit`` does),
    finite losses, the parameters in ``param_dtype`` and the running
    statistics float32 and updated once a step."""
    from iswm_tpu_torch.data import ArrayDataset

    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = "resnet18", "float32"
    for section, key, value in TRAIN_OPTIONS[name]:
        setattr(getattr(cfg, section), key, value)
    refuse_unported(cfg)
    for key in ("checkpoints_dir", "log_dir", "val_results_dir", "metrics_plots_dir"):
        setattr(cfg.train, key, str(tmp_path / key))
    cfg.data.crop_size, cfg.data.batch_size = 32, 4
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (4, 32, 32), dtype=np.uint8))
    ds = ArrayDataset(images.numpy(), masks.numpy())
    trainer = Trainer(cfg, device="cpu", train_ds=ds, val_ds=ds)
    model = trainer.state.model
    for step in range(2):
        if trainer._switch_iter and step >= trainer._switch_iter:
            trainer._switch_to_plain()
        loss = trainer.train_step(trainer.state, images, masks)
        assert np.isfinite(float(loss)) and trainer.state.step == step + 1
    assert trainer._switch_iter == 0 and not model.quant.int8
    assert {p.dtype for p in model.parameters()} == {getattr(torch, cfg.model.param_dtype)}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            assert v.dtype == torch.float32
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 2, k


# the QAT options these tests refused before QAT was ported, and which
# ModelConfig fields they set
ACCEPTED = {
    "int8_training": (("model", "int8_training", 64),),
    "int8_bwd": (("model", "int8_training", 64), ("model", "int8_training_bwd", True)),
    "int8_switch": (("model", "int8_training", 64), ("train", "int8_switch_iter", 10)),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_qat_options_are_accepted(name, tmp_path):
    """QAT, its int8 backward and its int8 -> plain switch pass
    ``refuse_unported`` and build a Trainer whose model routes convs (with
    ``int8_training_bwd``, each with an int8 backward); ``int8_switch_iter``
    alone, without ``int8_training``, switches nothing, as in the JAX
    package."""
    from iswm_tpu_torch.data import ArrayDataset
    from iswm_tpu_torch.models.layers import routed_sites

    cfg = Config()
    for section, key, value in ACCEPTED[name]:
        setattr(getattr(cfg, section), key, value)
    refuse_unported(cfg)
    for key in ("checkpoints_dir", "log_dir", "val_results_dir", "metrics_plots_dir"):
        setattr(cfg.train, key, str(tmp_path / key))
    cfg.model.backbone = "resnet18"
    ds = ArrayDataset(np.zeros((2, 8, 8, 3), np.uint8), np.zeros((2, 8, 8), np.uint8))
    trainer = Trainer(cfg, device="cpu", train_ds=ds, val_ds=ds)
    assert routed_sites(trainer.state.model, True)
    assert trainer.state.model.quant.int8_bwd == cfg.model.int8_training_bwd
    assert trainer._switch_iter == cfg.train.int8_switch_iter
    cfg.model.int8_training = 0
    assert Trainer(cfg, device="cpu", train_ds=ds, val_ds=ds)._switch_iter == 0


def imagenet_file(path, backbone, seed=0):
    """A random ImageNet state dict in the file layout of ``backbone``
    (the port's backbone keys, which are torchvision's, plus the ImageNet
    head the importers skip), written to ``path``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in build_model_by_name(f"deeplabv3plus_{backbone}").backbone.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy((0.5 + rng.random(t.shape)).astype(np.float32))
        else:
            sd[key] = torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
    head = ({"fc.weight": (1000, 512), "fc.bias": (1000,)} if backbone == "resnet18"
            else {"features.18.0.weight": (1280, 320, 1, 1), "classifier.1.weight": (1000, 1280)})
    for key, shape in head.items():
        sd[key] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    torch.save(sd, str(path))
    return sd


def test_trainer_loads_a_cached_pretrained_backbone(tmp_path, monkeypatch):
    """``pretrained_backbone`` is refused no longer: the Trainer overlays a
    cached torchvision-layout file on the backbone after the seeded init and
    keeps the seeded head, and the optimizer holds the loaded tensors."""
    from iswm_tpu_torch.models import build_model

    sd = imagenet_file(tmp_path / "resnet18-f37072fd.pth", "resnet18")
    monkeypatch.setenv("ISWM_PRETRAINED_DIR", str(tmp_path))
    cfg = Config()
    cfg.model.backbone, cfg.model.pretrained_backbone = "resnet18", True
    cfg.data.crop_size, cfg.data.batch_size = 32, 2
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(tmp_path / name))
    rng = np.random.default_rng(0)
    dataset = ArrayDataset(*map(np.stack, zip(*(generate_scene(rng, size=(40, 40))
                                                 for _ in range(2)))))
    trainer = Trainer(cfg, device="cpu", train_ds=dataset, val_ds=dataset)
    model = trainer.state.model
    for key, value in model.backbone.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, sd[key]), key
    seeded = build_model(cfg.model, seed=cfg.train.random_seed).classifier.state_dict()
    assert all(torch.equal(v, seeded[k]) for k, v in model.classifier.state_dict().items())
    held = {id(p) for group in trainer.state.optimizer.param_groups for p in group["params"]}
    assert id(model.backbone.conv1.weight) in held


def test_trainer_takes_steps_with_the_fused_stem(tmp_path):
    """``fused_stem`` is refused no longer: two steps on resnet18 through the
    fused stem's plain versions, finite losses, ``bn1``'s statistics moving."""
    rng = np.random.default_rng(0)
    images, masks = zip(*(generate_scene(rng, size=(40, 40)) for _ in range(6)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    cfg = Config()
    cfg.model.backbone, cfg.model.compute_dtype = "resnet18", "float32"
    cfg.model.fused_stem = "interpret"
    cfg.data.crop_size, cfg.data.batch_size = 32, 2
    cfg.train.total_itrs, cfg.train.val_interval, cfg.train.print_interval = 2, 2, 1
    cfg.train.save_val_results = False
    cfg.metrics.sequence_length = 3
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(tmp_path / name))
    trainer = Trainer(cfg, device="cpu", train_ds=dataset, val_ds=dataset)
    stem = trainer.state.model.backbone
    calls = []
    stem.fused_stem_pool.register_forward_hook(lambda *a: calls.append(stem.training))
    before = stem.bn1.running_mean.clone(), stem.conv1.weight.detach().clone()
    trainer.fit()
    assert trainer.state.step == 2 and int(stem.bn1.num_batches_tracked) == 2
    assert len(trainer.logger.history["train_loss"]) == 2
    assert all(np.isfinite(trainer.logger.history["train_loss"]))
    assert calls[:2] == [True, True] and calls[2:] and not any(calls[2:])  # validation too
    assert not torch.equal(stem.bn1.running_mean, before[0])
    assert not torch.equal(stem.conv1.weight, before[1])
    assert trainer.best_path is not None


def test_trainer_takes_steps_with_the_fused_blocks(tmp_path):
    """``fused_blocks`` is refused no longer: two steps on resnet50 through the
    fused blocks' plain versions (layer1 and layer2.{1,2,3} at crop 32; the
    4x4 and smaller maps of layer3 and layer4 are below the gate), finite
    losses, statistics and weights moving, and a validation that runs the
    unfused modules."""
    from iswm_tpu_torch.models import fused_block as mfb

    rng = np.random.default_rng(0)
    images, masks = zip(*(generate_scene(rng, size=(40, 40)) for _ in range(6)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.model.fused_blocks = "interpret"
    cfg.data.crop_size, cfg.data.batch_size = 32, 2
    cfg.train.total_itrs, cfg.train.val_interval, cfg.train.print_interval = 2, 2, 1
    cfg.train.save_val_results = False
    cfg.metrics.sequence_length = 3
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(tmp_path / name))
    trainer = Trainer(cfg, device="cpu", train_ds=dataset, val_ds=dataset)
    backbone = trainer.state.model.backbone
    block = backbone.layer1[0]
    calls, real = [], mfb.fused_bottleneck_apply
    before = block.bn2.running_var.clone(), block.conv2.weight.detach().clone()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mfb, "fused_bottleneck_apply",
                   lambda b, x: (calls.append(b.training), real(b, x))[1])
        trainer.fit()
    assert trainer.state.step == 2 and int(block.bn2.num_batches_tracked) == 2
    assert len(calls) == 2 * 6 and all(calls)  # six blocks a step, none in validation
    assert all(np.isfinite(trainer.logger.history["train_loss"]))
    assert not torch.equal(block.bn2.running_var, before[0])
    assert not torch.equal(block.conv2.weight, before[1])
    assert trainer.best_path is not None
    unfused = Config().model
    unfused.compute_dtype = "float32"
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    from iswm_tpu_torch.models import build_model

    build_model(unfused).load_state_dict(payload["model_state"], strict=True)


def test_cuda_is_not_silently_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(Config(), device="cuda")
