"""One and two train steps of the port against the JAX package's, on the CPU.

Crossed weights (resnet18, OS 16, float32, one reference-format .pth with
BatchNorm perturbed), batches of 8 synthetic scenes at 32x32, no
augmentation, the default ``ce_loss`` through the fused CE (the port's
plain version; JAX's Pallas kernel in interpret mode), SGD with nesterov
momentum, coupled weight decay and cosine decay.  Dropout is off on both
sides: the two frameworks cannot share its random stream.

Step 1 starts both from the crossed weights.  Step 2 starts the port from
JAX's state after step 1, its momentum buffers carried over by
``compat.momentum_from_optax``, so it checks the bridge and the momentum
update.  Tolerances: loss within 1e-5 relative; running statistics as in
``test_torch_train.assert_bn_stats_close`` (1e-5); each parameter's update
(new - old) within 1e-3 * max|update| of that tensor plus one float32 ulp
of the parameter (the resolution of new - old); measured 1.6e-5 and
2.3e-5 beyond the ulp.

A float32 train step of this model is chaotic: in some batches a ReLU or
max-pool decision that lies within rounding of its threshold goes the
other way in one framework, and 0.1-6% of the update's elements move by
up to 15% of their tensor's max (measured over eight batch seeds at 2 and
8 torch threads; a float64 gradient of the port's model confirms neither
side is wrong).  The two batches here have no such flip at the 2 torch
threads these tests pin.  Batch 8, not 2: at batch 2 the ASPP pooling
branch's BatchNorm normalizes two values per channel, which makes every
batch ill-conditioned.

With ``fused_stem="interpret"`` on both sides (JAX's Pallas kernels in
interpret mode, the port's plain versions) step 1 is compared once more, on
``FUSED_BATCH``: the batch seeds were tried in order and the first without
such a flip was kept.
"""

import warnings

import numpy as np
import pytest
import torch

from iswm_tpu.config import ModelConfig, OptimConfig
from iswm_tpu_torch.compat import load_momentum, momentum_from_optax, state_dict_from_jax
from iswm_tpu_torch.data import generate_scene, normalize
from iswm_tpu_torch.models import build_model
from iswm_tpu_torch.ops.losses import make_loss_fn
from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

from .test_torch_models import crossed_models
from .test_torch_train import (  # noqa: F401  (an autouse fixture)
    _no_dropout,
    assert_bn_stats_close,
    dropout_off,
    few_torch_threads,
)

TOTAL = 50
OPTIM = OptimConfig()  # sgd, lr 0.01, momentum 0.9, nesterov, wd 1e-4, cosine


SIZE, BATCH = 32, 8


def _batch(seed):
    """Normalized synthetic scenes, their masks with 5% ignored."""
    rng = np.random.default_rng(seed)
    images, labels = zip(*(generate_scene(rng, size=(SIZE, SIZE)) for _ in range(BATCH)))
    images = normalize(torch.from_numpy(np.stack(images)).float() / 255.0).numpy()
    labels = np.stack(labels).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255
    return images, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's two steps and the port's step 1 (from the crossed weights) and
    step 2 (from JAX's state after step 1)."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.ops.pallas.fused_ce import fused_binary_ce
    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer
    from iswm_tpu.train.step import TrainState as JaxState
    from iswm_tpu.train.step import make_train_step as jax_make_train_step

    jmodel, variables, model, _ = crossed_models(tmp_path_factory.mktemp("ckpt"),
                                                 "resnet18", 16)
    tx, _ = jax_make_optimizer(OPTIM, TOTAL)
    ones = jnp.ones(2, jnp.float32)
    jstep = jax_make_train_step(
        jmodel, tx, lambda lg, lb: fused_binary_ce(lg, lb, ones, 255, True),
        augment=None, donate=False)
    batches = [_batch(1), _batch(3)]
    states = [JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))]
    jax_losses = []
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp, model)
        for images, labels in batches:
            state, metrics = jstep(states[-1], jnp.asarray(images), jnp.asarray(labels),
                                   jax.random.key(0))
            states.append(jax.device_get(state))
            jax_losses.append(float(metrics["loss"]))

    def jax_sd(state):
        return state_dict_from_jax(state.params, state.batch_stats, backbone="resnet18")

    loss_fn = make_loss_fn("ce_loss", fused="interpret")
    step = make_train_step(loss_fn)
    factory, _ = make_optimizer(OPTIM, TOTAL)
    port = []
    for i, (images, labels) in enumerate(batches):
        if i == 1:  # continue from JAX's state after step 1
            model = build_model(ModelConfig(backbone="resnet18", compute_dtype="float32"))
            model.load_state_dict(jax_sd(states[1]), strict=True)
            dropout_off(model)
        optimizer, scheduler = factory(model.parameters())
        if i == 1:
            buffers, count = momentum_from_optax(states[1].opt_state, states[1].batch_stats,
                                                 backbone="resnet18")
            load_momentum(optimizer, model, buffers)
            with warnings.catch_warnings():  # stepped before any optimizer.step()
                warnings.simplefilter("ignore")
                for _ in range(count):
                    scheduler.step()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state = TrainState(model, optimizer, scheduler, i)
        loss = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        port.append((float(loss), before, {k: v.clone() for k, v in model.state_dict().items()},
                     state.step))
    return jax_losses, [jax_sd(s) for s in states], port


FUSED_BATCH = 1


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    """Step 1 of both packages with the fused stem, from the crossed weights,
    in the layout of ``runs``."""
    import jax
    import jax.numpy as jnp

    from iswm_tpu.models import build_model as build_jax_model
    from iswm_tpu.ops.pallas.fused_ce import fused_binary_ce
    from iswm_tpu.train.optim import make_optimizer as jax_make_optimizer
    from iswm_tpu.train.step import TrainState as JaxState
    from iswm_tpu.train.step import make_train_step as jax_make_train_step

    _, variables, unfused, _ = crossed_models(tmp_path_factory.mktemp("ckpt"), "resnet18", 16)
    cfg = ModelConfig(backbone="resnet18", compute_dtype="float32")
    cfg.fused_stem = "interpret"
    jmodel, model = build_jax_model(cfg), build_model(cfg)
    model.load_state_dict(unfused.state_dict(), strict=True)
    tx, _ = jax_make_optimizer(OPTIM, TOTAL)
    ones = jnp.ones(2, jnp.float32)
    jstep = jax_make_train_step(
        jmodel, tx, lambda lg, lb: fused_binary_ce(lg, lb, ones, 255, True),
        augment=None, donate=False)
    images, labels = _batch(FUSED_BATCH)
    first = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]))
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp, model)
        state, metrics = jstep(first, jnp.asarray(images), jnp.asarray(labels),
                               jax.random.key(0))
    states = [first, jax.device_get(state)]
    calls = []
    model.backbone.fused_stem_pool.register_forward_hook(lambda *a: calls.append(1))
    factory, _ = make_optimizer(OPTIM, TOTAL)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    train_state = TrainState(model, *factory(model.parameters()), 0)
    loss = make_train_step(make_loss_fn("ce_loss", fused="interpret"))(
        train_state, torch.from_numpy(images), torch.from_numpy(labels))
    assert calls == [1]
    port = [(float(loss), before, {k: v.clone() for k, v in model.state_dict().items()},
             train_state.step)]
    sds = [state_dict_from_jax(s.params, s.batch_stats, backbone="resnet18") for s in states]
    return [float(metrics["loss"])], sds, port


def _check_step(runs, i):
    jax_losses, jax_sds, port = runs
    loss, before, after, count = port[i]
    assert count == i + 1
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jax_losses[i], rtol=1e-5)
    assert_bn_stats_close(after, jax_sds[i + 1])
    params = [k for k in after if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert len(params) > 80
    for k in params:
        want = np.asarray(jax_sds[i + 1][k]) - np.asarray(jax_sds[i][k])
        got = (after[k] - before[k]).numpy()
        assert np.abs(want).max() > 0, k
        # new - old is quantized at one float32 ulp of the parameter
        ulp = np.spacing(np.abs(np.asarray(jax_sds[i + 1][k])))
        assert (np.abs(got - want) <= 1e-3 * np.abs(want).max() + ulp).all(), k


def test_first_train_step_matches_jax(runs):
    _check_step(runs, 0)


def test_second_train_step_from_bridged_state_matches_jax(runs):
    _check_step(runs, 1)



def test_first_train_step_with_the_fused_stem_matches_jax(fused_runs):
    _check_step(fused_runs, 0)
