"""The port's tensor metrics (``metrics/device.py``), the confusion kernel's
plain version and ``int8_matmul_prequant``'s plain version against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through both packages.  The Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerances: confusion matrices and front positions exact (integers);
metrics from a CM 1e-6 absolute (float32 divisions); the symmetric front
error 1e-5 relative (two float32 reductions in another order).  The
``cuda`` cases hold the kernels against their plain versions on a card and
skip where there is none; on the card's machine, which has no jax, they are
the only ones run:
``python -m pytest --noconftest tests/test_torch_device_metrics.py -m cuda``.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from iswm_tpu.metrics import device as jdev
    from iswm_tpu.ops.pallas.confusion import binary_confusion_matrix as jax_binary_cm
    from iswm_tpu.ops.pallas.int8_matmul import int8_matmul_prequant as jax_prequant
except ImportError:  # the card's machine has no jax: only the ``cuda`` cases run there
    jnp = None

from iswm_tpu_torch.data.synthetic import generate_scene
from iswm_tpu_torch.metrics import device as pdev
from iswm_tpu_torch.ops.kernels import confusion as pcm
from iswm_tpu_torch.ops.kernels import int8_matmul as k8


def _labels(seed, shape, n_classes=2, ignore=0.05, dtype=np.int64):
    rng = np.random.default_rng(seed)
    gts = rng.integers(0, n_classes, shape)
    gts[rng.random(shape) < ignore] = 255
    preds = rng.integers(0, n_classes, shape)
    return gts.astype(dtype), preds.astype(dtype)


# ----------------------------------------------------------- confusion matrix
@pytest.mark.parametrize("n_classes", [2, 3, 5])
def test_confusion_matrix_matches_jax(n_classes):
    gts, preds = _labels(n_classes, (3, 37, 41), n_classes)
    want = np.asarray(jdev.confusion_matrix(jnp.asarray(gts), jnp.asarray(preds), n_classes))
    got = pdev.confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds), n_classes)
    assert got.dtype == torch.float32 and got.shape == (n_classes, n_classes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == (gts != 255).sum()


def test_confusion_matrix_drops_out_of_range_predictions_as_jax():
    gts = np.array([0, 1, 1, 0, 255, 1])
    preds = np.array([0, 1, 7, -1, 1, 0])
    want = np.asarray(jdev.confusion_matrix(jnp.asarray(gts), jnp.asarray(preds), 2))
    got = pdev.confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[1, 0], [1, 1]])


CM_CASES = {
    "batch": ((4, 30, 40), np.int64, np.int64),
    "ragged": ((3, 77, 91), np.uint8, np.int64),
    "one_pixel": ((1,), np.int32, np.int32),
    "wide_row": ((2, 70000), np.int32, np.uint8),  # more than one 65536-pixel block
}


@pytest.mark.parametrize("name", sorted(CM_CASES))
def test_binary_confusion_plain_matches_pallas(name):
    shape, gt_dtype, pred_dtype = CM_CASES[name]
    gts, preds = _labels(len(name), shape, dtype=gt_dtype)
    preds = preds.astype(pred_dtype)
    want = np.asarray(jax_binary_cm(jnp.asarray(gts), jnp.asarray(preds), interpret=True))
    got = pcm.binary_confusion_matrix_plain(torch.from_numpy(gts), torch.from_numpy(preds))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = pcm.launches
    again = pcm.binary_confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds))
    assert torch.equal(again, got) and pcm.launches == before
    np.testing.assert_array_equal(
        got.numpy(),
        pdev.confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds), 2).numpy())


def test_binary_confusion_all_ignored_and_odd_values():
    gts = np.full((5, 9), 255, np.uint8)
    preds = np.ones((5, 9), np.int64)
    got = pcm.binary_confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds))
    assert not got.any()
    # labels outside [0, 2) are excluded; a prediction is class 1 only when == 1
    gts = np.array([0, 1, 2, -1, 1, 0], np.int64)
    preds = np.array([3, 1, 1, 1, 0, 1], np.int64)
    want = np.asarray(jax_binary_cm(jnp.asarray(gts), jnp.asarray(preds), interpret=True))
    got = pcm.binary_confusion_matrix(torch.from_numpy(gts), torch.from_numpy(preds))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[1, 1], [1, 1]])


def test_binary_confusion_refuses_bad_inputs():
    a = torch.zeros(6, dtype=torch.int64)
    with pytest.raises(ValueError, match="differ in size"):
        pcm.binary_confusion_matrix(a, a[:5])
    with pytest.raises(TypeError, match="integers"):
        pcm.binary_confusion_matrix(a.float(), a)
    with pytest.raises(TypeError, match="integers"):
        pcm.binary_confusion_matrix(a, a.bool())


# -------------------------------------------------------- metrics from a CM
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_foreground_metrics_match_jax(seed):
    gts, preds = _labels(seed, (2000,), ignore=0.0)
    cm = np.array(jdev.confusion_matrix(jnp.asarray(gts), jnp.asarray(preds), 2))
    if seed == 2:
        cm[1] = 0  # no foreground at all: every ratio is 0 / EPS
    want = jdev.foreground_metrics_from_cm(jnp.asarray(cm))
    got = pdev.foreground_metrics_from_cm(torch.from_numpy(cm))
    # (jit hands JAX's dict back with its keys sorted)
    assert sorted(got) == sorted(want) == sorted(["miou", "fiou", "precision", "recall", "f1"])
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key
    assert pdev.EPS == jdev.EPS == 1e-7


def test_accumulator_matches_jax():
    jacc, pacc = jdev.DeviceEvalAccumulator(2), pdev.DeviceEvalAccumulator(2)
    assert pacc.results() == jacc.results()  # nothing seen yet: all zeros
    for seed in range(3):
        gts, preds = _labels(seed, (2, 24, 31), dtype=np.int32)
        jacc.update(jnp.asarray(gts), jnp.asarray(preds))
        pacc.update(torch.from_numpy(gts), torch.from_numpy(preds))
    np.testing.assert_array_equal(pacc.cm.numpy(), np.asarray(jacc.cm))
    want, got = jacc.results(), pacc.results()
    assert sorted(got) == sorted(want)
    for key in want:
        assert isinstance(got[key], float) and abs(got[key] - want[key]) <= 1e-6, key
    pacc.reset()
    assert pacc.cm is None and not any(pacc.results().values())
    # three classes take the one-hot route
    gts, preds = _labels(7, (2, 24, 31), 3)
    j3, p3 = jdev.DeviceEvalAccumulator(3), pdev.DeviceEvalAccumulator(3)
    j3.update(jnp.asarray(gts), jnp.asarray(preds))
    p3.update(torch.from_numpy(gts), torch.from_numpy(preds))
    np.testing.assert_array_equal(p3.cm.numpy(), np.asarray(j3.cm))


# ------------------------------------------------------------- fronts, waves
def test_wave_presence_matches_jax():
    masks = np.zeros((3, 100, 100), np.int32)
    masks[1, :5, :11] = 1  # 0.55% > 0.5%
    masks[2, :5, :10] = 3  # exactly 0.5%, any positive value counts
    for threshold in (0.005, 0.0051):
        want = np.asarray(jdev.wave_presence(jnp.asarray(masks), threshold))
        got = pdev.wave_presence(torch.from_numpy(masks), threshold)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def _wave_masks(seed, n, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    return np.stack([generate_scene(rng, size=hw)[1] for _ in range(n)]).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "waves", "empty_rows"])
def test_front_positions_match_jax(kind):
    if kind == "random":
        masks = (np.random.default_rng(0).random((3, 20, 33)) < 0.1).astype(np.int32)
    elif kind == "waves":
        masks = _wave_masks(1, 3)
    else:
        masks = np.zeros((2, 6, 8), np.int32)
        masks[0, 2, 3] = masks[0, 2, 5] = masks[0, 4, 0] = masks[1, 5, 7] = 1
    want_cols, want_has = jdev.front_positions_batch(jnp.asarray(masks))
    cols, has = pdev.front_positions_batch(torch.from_numpy(masks))
    np.testing.assert_array_equal(has.numpy(), np.asarray(want_has))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_cols))  # 0 on empty rows
    assert (~has).any() and not cols[~has].any()


def _frame_pairs():
    waves = _wave_masks(2, 4, hw=(50, 100))
    empty = np.zeros((50, 100), np.int32)
    block = empty.copy()
    block[10:40, 30:60] = 1
    far = empty.copy()
    far[10:40, 80:95] = 1  # every nearest point is beyond tau: the 2 * tau branch
    noisy = (np.random.default_rng(3).random((50, 100)) < 0.02).astype(np.int32)
    return {
        "miss": (empty, block), "false_alarm": (block, empty), "both_empty": (empty, empty),
        "identical": (block, block), "shifted": (np.roll(block, 3, axis=1), block),
        "out_of_reach": (far, block), "random": (noisy, np.roll(noisy, 1, axis=0)),
        "waves01": (waves[0], waves[1]), "waves23": (waves[2], waves[3]),
        "ties": (np.roll(block, 5, axis=0), block),
    }


@pytest.mark.parametrize("name", sorted(_frame_pairs()))
def test_symmetric_front_error_matches_jax(name):
    pred, gt = _frame_pairs()[name]
    want = float(jdev.symmetric_front_error(jnp.asarray(pred), jnp.asarray(gt)))
    got = pdev.symmetric_front_error(torch.from_numpy(pred), torch.from_numpy(gt))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1e-30), (float(got), want)
    tau = 10.0
    expected = {"miss": 2 * tau, "false_alarm": 1.5 * tau, "both_empty": 0.0,
                "out_of_reach": 2 * tau}
    if name in expected:
        assert float(got) == pytest.approx(expected[name])


# ------------------------------------------------------- int8_matmul_prequant
@pytest.mark.parametrize("mkn", [(300, 128, 128), (256, 256, 384), (7, 384, 128)])
def test_prequant_plain_matches_pallas(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w_scale = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    x_scale = 0.0371
    want = np.asarray(jax_prequant(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(w_scale),
                                   x_scale, interpret=True))
    args = (torch.from_numpy(x_q), torch.from_numpy(w_q), torch.from_numpy(w_scale), x_scale)
    got = k8.int8_matmul_prequant_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    before = k8.launches_prequant
    assert torch.equal(k8.int8_matmul_prequant(*args), got)  # CPU: the plain version
    assert k8.launches_prequant == before
    # the same codes through int8_matmul's quantize: x = codes * x_scale
    xs = torch.tensor(x_scale, dtype=torch.float32)
    x = torch.from_numpy(x_q).float() * xs
    assert torch.equal(torch.clamp(torch.round(x / xs), -127, 127), torch.from_numpy(x_q).float())
    assert torch.equal(k8.int8_matmul_plain(x, *args[1:]), got)


def test_prequant_refuses_bad_inputs():
    w = torch.zeros((128, 128), dtype=torch.int8)
    ws = torch.ones(128)
    with pytest.raises(TypeError, match="int8"):
        k8.int8_matmul_prequant(torch.zeros((4, 128)), w, ws, 1.0)
    with pytest.raises(ValueError, match="multiples of 128"):
        k8.int8_matmul_prequant(torch.zeros((4, 64), dtype=torch.int8),
                                torch.zeros((64, 128), dtype=torch.int8), ws, 1.0)
    with pytest.raises(ValueError, match="K mismatch"):
        k8.int8_matmul_prequant(torch.zeros((4, 256), dtype=torch.int8), w, ws, 1.0)


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with --noconftest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CM_CASES))
def test_confusion_kernel_equals_plain_on_the_card(card, name):
    shape, gt_dtype, pred_dtype = CM_CASES[name]
    gts, preds = _labels(len(name), shape, dtype=gt_dtype)
    gts, preds = torch.from_numpy(gts).to(card), torch.from_numpy(preds.astype(pred_dtype)).to(card)
    before = pcm.launches
    got = pcm.binary_confusion_matrix(gts, preds)
    assert pcm.launches == before + 1
    assert torch.equal(got, pcm.binary_confusion_matrix_plain(gts, preds))
    assert torch.equal(got, pdev.confusion_matrix(gts, preds, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(300, 128, 128), (8192, 1024, 256)])
def test_prequant_kernel_equals_plain_on_the_card(card, mkn):
    m, k, n = mkn
    gen = torch.Generator(device="cuda").manual_seed(m)
    x_q = torch.randint(-127, 128, (m, k), generator=gen, device=card).to(torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=card).to(torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=card) * 0.01 + 1e-4
    before = k8.launches_prequant
    got = k8.int8_matmul_prequant(x_q, w_q, w_scale, 0.0371)
    assert k8.launches_prequant == before + 1
    assert torch.equal(got, k8.int8_matmul_prequant_plain(x_q, w_q, w_scale, 0.0371))
    xs = torch.tensor(0.0371, dtype=torch.float32, device=card)
    assert torch.equal(got, k8.int8_matmul(x_q.float() * xs, w_q, w_scale, 0.0371))
