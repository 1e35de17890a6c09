"""The port's models against the JAX package's, on the CPU in float32.

Weights cross through a reference-format .pth (BatchNorm scales and
running statistics perturbed first, so that BN is not the identity) that
both packages load.  Logits may differ only by summation order: max abs
difference <= 1e-4 * max |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iswm_tpu.compat.torch_import import (
    load_reference_checkpoint,
    save_reference_checkpoint,
)
from iswm_tpu.config import ModelConfig
from iswm_tpu.models import build_model as build_jax_model
from iswm_tpu_torch.compat import load_checkpoint, state_dict_from_jax
from iswm_tpu_torch.models import build_model, build_model_by_name


def jax_init(backbone, output_stride, seed=0, **model):
    """A JAX model and its (params, batch_stats) at init, float32; ``model``
    sets further ``ModelConfig`` fields (``name``, ``separable_conv``)."""
    cfg = ModelConfig(backbone=backbone, output_stride=output_stride,
                      compute_dtype="float32", **model)
    model = build_jax_model(cfg)
    v = jax.jit(lambda: model.init({"params": jax.random.key(seed)},
                                   jnp.zeros((1, 32, 32, 3)), train=False))()
    return cfg, model, v["params"], v["batch_stats"]


def port_init(backbone, output_stride, **model):
    """:func:`jax_init`'s (config, JAX model, params, batch_stats), the trees
    made from the port's seeded init by the JAX package's importer: no JAX
    compile, for a test that needs the JAX side's structure and not its
    initializer's numbers."""
    from iswm_tpu.compat.torch_import import import_torch_state_dict

    cfg = ModelConfig(backbone=backbone, output_stride=output_stride,
                      compute_dtype="float32", **model)
    params, stats = import_torch_state_dict(build_model(cfg).state_dict(), backbone=backbone,
                                            head=cfg.name)
    return cfg, build_jax_model(cfg), params, stats


def perturbed_checkpoint(path, params, batch_stats, backbone, seed=0):
    """Write a .pth of the JAX trees with BN scale/bias/mean/var perturbed."""
    params, batch_stats = perturbed_trees(params, batch_stats, seed)
    save_reference_checkpoint(str(path), params, batch_stats, backbone=backbone)
    return str(path)


def perturbed_trees(params, batch_stats, seed=0):
    """The JAX trees (numpy leaves) with BN scale/bias/mean/var perturbed."""
    rng = np.random.default_rng(seed)

    def perturb(tree, leaf_fn):
        return jax.tree_util.tree_map_with_path(
            lambda p, x: leaf_fn(p[-1].key, np.asarray(x)), tree
        )

    def bn_param(name, x):
        if name == "scale":
            return (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "bias" and x.ndim == 1:
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    def bn_stat(name, x):
        if name == "mean":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (0.5 + rng.random(size=x.shape)).astype(np.float32)

    return perturb(params, bn_param), perturb(batch_stats, bn_stat)


def crossed_models(tmp_path, backbone, output_stride):
    """(JAX model, JAX variables, port model) sharing one perturbed .pth."""
    cfg, jmodel, params, stats = jax_init(backbone, output_stride)
    ckpt = perturbed_checkpoint(tmp_path / f"{backbone}.pth", params, stats, backbone)
    params, stats, _ = load_reference_checkpoint(ckpt, backbone=backbone)
    model = build_model(cfg)
    model.load_state_dict(load_checkpoint(ckpt), strict=True)
    return jmodel, {"params": params, "batch_stats": stats}, model, ckpt


def test_strict_load_from_jax_init():
    cfg, _, params, stats = jax_init("resnet18", 16)
    model = build_model(cfg)
    sd = state_dict_from_jax(jax.device_get(params), jax.device_get(stats),
                             backbone="resnet18")
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    assert set(got) == set(sd)
    np.testing.assert_array_equal(
        got["backbone.layer2.0.conv1.weight"].numpy(),
        np.transpose(np.asarray(params["backbone"]["layer2_0"]["conv1"]["conv"]["kernel"]),
                     (3, 2, 0, 1)),
    )


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
@pytest.mark.parametrize("output_stride", [16, 8])
def test_logits_match_jax(tmp_path, backbone, output_stride):
    jmodel, variables, model, _ = crossed_models(tmp_path, backbone, output_stride)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_unported_backbone_and_head_are_refused():
    """Every backbone and head builds, QAT ones too; what stays refused names
    its ROADMAP item, and unknown names are errors as in the JAX package."""
    from iswm_tpu_torch.models.layers import routed_sites

    assert routed_sites(build_model_by_name("deeplabv3plus_mobilenet", int8_training=64), True)
    assert routed_sites(build_model_by_name("deeplabv3plus_mobilenet", int8_training=64,
                                            int8_training_bwd=True), True)
    # refused no longer: bf16 parameters, float32 BatchNorm statistics
    low = build_model_by_name("deeplabv3_resnet50", param_dtype="bfloat16")
    assert {p.dtype for p in low.parameters()} == {torch.bfloat16}
    assert {b.dtype for n, b in low.named_buffers() if "running" in n} == {torch.float32}
    with pytest.raises(ValueError, match="unknown param_dtype"):
        build_model_by_name("deeplabv3_resnet50", param_dtype="int8")
    with pytest.raises(ValueError, match="unknown backbone"):
        build_model_by_name("deeplabv3plus_vgg16")
    with pytest.raises(ValueError, match="unknown model name"):
        build_model_by_name("fcn_resnet50")


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="iswm_tpu.cli.export_torch"):
        load_checkpoint(str(tmp_path))
