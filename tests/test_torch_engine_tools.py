"""The port's serving engine, profiling helpers, data doctor and manifest, and
``utils.misc`` against the JAX package's originals, on the CPU.

- ``infer/engine.py``: ``build_engine`` on a CPU device (eager) gives the
  JAX engine's outputs on ``tests/test_engine_profiling.py``'s model fn and
  its shape check, word for word; its ``flops`` count a matmul as the JAX
  engine's cost analysis does; ``serialize`` / ``deserialize`` round-trip
  through ``torch.export`` (the JAX round trip's check, and a closed-over
  weight baked in); a fn that calls a hand kernel's operator (#1) exports
  with it as one node, the trace running no plain version, and a fn that
  reaches a training wrapper that launches through ctypes is refused at its
  entry.  On the card (``-m cuda``): a captured graph replays a fn that runs
  the int8 kernel bit for bit as the eager fn, and a fn that reads a value
  back to the host is refused; the bf16, ``int8_exec`` and ``int8_exec_xla``
  serving fns of ResNet-50 round-trip through ``serialize`` bit for bit,
  launching the eager fn's kernels.
- ``train/profiling.py``: ``StepTimer`` as the JAX one; ``trace`` writes a
  trace file.
- ``data/manifest.py`` and ``data/doctor.py``: the same manifests, reports,
  printed output and exit codes as the JAX package's on the same trees
  (``tests/test_manifest_utils.py``'s), and both run as modules.
- ``utils/misc.py``: equal to ``iswm_tpu/utils/misc.py``.

The module imports jax lazily, so that its ``cuda`` cases collect on the
card's machine (``python -m pytest --noconftest
tests/test_torch_engine_tools.py -m cuda``).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from iswm_tpu_torch.data import doctor, manifest
from iswm_tpu_torch.infer.engine import (
    CaptureRefused,
    build_engine,
    deserialize,
    serialize,
)
from iswm_tpu_torch.train.profiling import StepTimer, trace
from iswm_tpu_torch.utils import Denormalize, denormalize, mkdir, safe_process, timing_debug

REPO = Path(__file__).resolve().parents[1]


def _model_fn(x):
    """``tests/test_engine_profiling.py``'s model fn in torch."""
    return torch.stack([x[..., 0], -x[..., 0]], dim=-1)


# ------------------------------------------------------------------ engine
def test_engine_outputs_and_shape_check_match_jax():
    import jax.numpy as jnp

    from iswm_tpu.infer import engine as jax_engine

    from .test_engine_profiling import _model_fn as jax_model_fn

    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    want = jax_engine.build_engine(jax_model_fn, (2, 16, 16, 3), jnp.float32)
    got = build_engine(_model_fn, (2, 16, 16, 3), torch.float32, device="cpu")
    out = got(torch.from_numpy(x))
    assert out.shape == (2, 16, 16, 2) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(want(jnp.asarray(x))))
    with pytest.raises(ValueError) as want_error:
        want(jnp.ones((1, 16, 16, 3)))
    with pytest.raises(ValueError) as got_error:
        got(torch.ones(1, 16, 16, 3))
    assert str(got_error.value) == str(want_error.value)
    assert got.memory_analysis is None  # an eager engine has no graph pool


def test_engine_flops_count_a_matmul_as_jax():
    import jax.numpy as jnp

    from iswm_tpu.infer import engine as jax_engine

    w = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    want = jax_engine.build_engine(lambda x: x @ jnp.asarray(w), (4, 3), jnp.float32)
    wt = torch.from_numpy(w)
    got = build_engine(lambda x: x @ wt, (4, 3), torch.float32, device="cpu")
    assert got.flops == want.flops == 2 * 4 * 3 * 5


def test_engine_needs_the_card_it_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        build_engine(_model_fn, (1, 8, 8, 3), torch.float32)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        build_engine(_model_fn, (1, 8, 8, 3), torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):  # serialize too
        serialize(_model_fn, (1, 8, 8, 3), torch.float32)


def test_serialize_roundtrip_as_jax():
    import jax.numpy as jnp

    from iswm_tpu.infer import engine as jax_engine

    from .test_engine_profiling import _model_fn as jax_model_fn

    x = np.random.default_rng(2).normal(size=(1, 8, 8, 3)).astype(np.float32)
    want = jax_engine.deserialize(jax_engine.serialize(jax_model_fn, (1, 8, 8, 3),
                                                       jnp.float32))(jnp.asarray(x))
    blob = serialize(_model_fn, (1, 8, 8, 3), torch.float32, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 0
    fn = deserialize(blob)
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), np.asarray(want))
    np.testing.assert_allclose(fn(torch.ones(1, 8, 8, 3)).numpy()[..., 0], 1.0)


def test_serialize_bakes_the_closed_over_weights_in():
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(3))
    blob = serialize(lambda x: torch.relu(x @ w), (2, 3), torch.float32, device="cpu")
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(4))
    want = torch.relu(x @ w)
    w.zero_()  # the artifact serves alone
    torch.testing.assert_close(deserialize(blob)(x), want, rtol=0, atol=0)


def test_serialize_refuses_a_fn_that_reaches_a_hand_kernel(monkeypatch):
    """A training wrapper that launches through ctypes (the confusion matrix,
    #6) is refused at its entry: its body (here its plain version) does not
    run on the trace's tensors, and the message names it."""
    from iswm_tpu_torch.ops.kernels import confusion as cm

    def fn(x):
        return cm.binary_confusion_matrix((x > 0).to(torch.uint8), (x > 0.5).to(torch.uint8))

    assert fn(torch.ones(2, 8, 8)).shape == (2, 2)  # its plain version, on the CPU
    ran = []
    monkeypatch.setattr(cm, "binary_confusion_matrix_plain", lambda *args: ran.append(args))
    with pytest.raises(NotImplementedError) as error:
        serialize(fn, (2, 8, 8), torch.float32, device="cpu")
    assert "confusion.binary_confusion_matrix" in str(error.value)
    assert "ROADMAP" not in str(error.value) and ran == []


def test_serialize_traces_a_hand_kernel_as_its_op(monkeypatch):
    """A fn that calls #1's wrapper exports with ``iswm.int8_matmul`` as one
    node: the trace runs its fake alone (no plain version), and the loaded
    artifact gives the eager fn's bits through the operator's CPU
    implementation."""
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    rng = np.random.default_rng(5)
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(128, 128)).astype(np.int8))
    w_scale = torch.full((128,), 0.01)

    def fn(x):
        return k8.int8_matmul(x, w_q, w_scale, 0.05)

    ran, plain = [], k8.int8_matmul_plain
    monkeypatch.setattr(k8, "int8_matmul_plain", lambda *args: (ran.append(1), plain(*args))[1])
    blob = serialize(fn, (8, 128), torch.float32, device="cpu")
    assert ran == []
    served = deserialize(blob)
    assert [str(n.target) for n in served.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("iswm.")] == ["iswm.int8_matmul.default"]
    x = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    torch.testing.assert_close(served(x), fn(x), rtol=0, atol=0)
    assert len(ran) == 2


@pytest.mark.cuda
def test_cuda_engine_replays_the_int8_kernel_bit_for_bit():
    """A graph of a fn with the int8 1x1 kernel (#1) and library ops replays
    bit-equal to the eager fn on fresh inputs; the kernel's launch is
    captured (the counter moves at capture, not at replay); a fn that reads
    a value back to the host is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    rng = np.random.default_rng(6)
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(256, 128)).astype(np.int8)).cuda()
    w_scale = torch.from_numpy(rng.random(128).astype(np.float32) * 0.01).cuda()

    def fn(x):
        return torch.relu(k8.int8_matmul(x.reshape(-1, 256), w_q, w_scale, 0.05)).reshape(
            x.shape[0], -1, 128)

    engine = build_engine(fn, (4, 64, 256), torch.bfloat16)
    assert engine.memory_analysis["graph_pool_bytes"] >= 0
    launches = k8.launches
    for seed in (7, 8):
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(4, 64, 256))).to(
            "cuda", torch.bfloat16)
        assert torch.equal(engine(x), fn(x))
    assert k8.launches == launches + 2  # the two eager calls; the replays launch no wrapper
    with pytest.raises(ValueError, match="engine built for"):
        engine(torch.zeros(2, 64, 256, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(CaptureRefused, match="synchronizes with the host"):
        build_engine(lambda x: x * x.sum().item(), (8,), torch.float32)


@pytest.mark.cuda
def test_cuda_serialize_roundtrips_the_bf16_serving_fn():
    """The bf16, ``int8_exec`` and ``int8_exec_xla`` serving fns of
    deeplabv3plus_resnet50 (OS 16, seeded weights, on the card) at a chunk
    of 8 x 512^2 tiles: ``serialize`` traces each on the card by default
    without a launch, and the artifact, loaded back, gives the eager fn's
    logits bit for bit on two chunks (deterministic cuDNN), launching the
    hand kernels the eager fn launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the serving fn's weights lie on it)")
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.infer import Predictor
    from iswm_tpu_torch.ops.kernels import int8_conv as kc
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    def launches():
        return k8.launches, kc.launches_quantize, kc.launches_igemm

    flags = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        rng = np.random.default_rng(9)
        chunks = [val_transform_batch(torch.from_numpy(
            rng.integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)).cuda()) for _ in range(2)]
        for variant in ("bf16", "int8_exec", "int8_exec_xla"):
            cfg = Config()  # bf16 compute by default
            cfg.predict.serving_variant = variant
            predictor = Predictor(cfg, device="cuda")
            predictor.predict_image(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
            fn = predictor.engine.model_fn
            before = launches()
            served = deserialize(serialize(fn, tuple(chunks[0].shape), chunks[0].dtype))
            assert launches() == before, variant  # the trace ran the fakes alone
            with torch.inference_mode():
                for chunk in chunks:
                    a = launches()
                    got = served(chunk)
                    b = launches()
                    want = fn(chunk)
                    assert [y - x for x, y in zip(a, b)] == [
                        y - x for x, y in zip(b, launches())], variant
                    assert torch.equal(got, want), variant
            if variant != "bf16":
                assert launches()[0] > before[0], variant  # #1 serves both int8 fns
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = flags


# --------------------------------------------------------------- profiling
def test_step_timer_as_jax():
    from iswm_tpu.train.profiling import StepTimer as JaxStepTimer

    timers = [StepTimer(skip=1), JaxStepTimer(skip=1)]
    for _ in range(3):
        for t in timers:
            with t:
                time.sleep(0.01)
    for t in timers:
        assert 0.005 < t.mean_seconds < 0.1
        assert t._count == 2 and t._seen == 3
        assert t.throughput(8) == pytest.approx(8 / t.mean_seconds)
    assert StepTimer().mean_seconds == 0.0 and StepTimer().throughput(8) == 0.0


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "t"), enabled=True):
        torch.zeros(4).add_(1)
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# ---------------------------------------------------------- data tools
def _manifest_tree(d: Path) -> None:
    (d / "train").mkdir(parents=True)
    (d / "train" / "a.png").write_bytes(b"abc")
    (d / "b.txt").write_text("hello")
    (d / ".hidden").write_text("skipped")


def test_manifest_roundtrip_as_jax(tmp_path):
    from iswm_tpu.data import manifest as jax_manifest

    d = tmp_path / "data"
    _manifest_tree(d)
    m = manifest.build_manifest(str(d))
    assert m == jax_manifest.build_manifest(str(d))
    assert m["nfiles"] == 2 and m["size"] == 8
    for change in (lambda: None,
                   lambda: ((d / "train" / "a.png").write_bytes(b"abcd"),
                            (d / "c.txt").write_text("x")),
                   lambda: (d / "train" / "a.png").unlink()):
        change()
        report = manifest.verify_manifest(str(d), m)
        assert report == jax_manifest.verify_manifest(str(d), m)
    assert report["missing"] == ["train/a.png"] and report["extra"] == ["c.txt"]


def test_manifest_cli_as_jax(tmp_path, capsys):
    from iswm_tpu.data import manifest as jax_manifest

    d = tmp_path / "data"
    d.mkdir()
    (d / "f").write_text("1")
    seen = {}
    for name, main in (("port", manifest.main), ("jax", jax_manifest.main)):
        out = tmp_path / f"{name}.json"
        codes = [main(["build", str(d), str(out)]), main(["verify", str(d), str(out)])]
        (d / "f").write_text("2")
        codes.append(main(["verify", str(d), str(out)]))
        (d / "f").write_text("1")
        printed = capsys.readouterr().out.replace(str(out), "<out>")
        codes.append(main(["nonsense", str(d)]))  # the usage: each module's docstring
        capsys.readouterr()
        seen[name] = (codes, printed, json.loads(out.read_text()))
    assert seen["port"][0] == seen["jax"][0] == [0, 0, 1, 2]
    assert seen["port"][1:] == seen["jax"][1:]


def _doctor_tree(root: Path) -> None:
    """A train split with paired, timestamped, uniform PNGs; a val split with
    a missing mask, an unstamped name and a second image size."""
    from PIL import Image

    for split, names in (("train", ["H09_20250101_0400", "H09_20250101_0410"]),
                         ("val", ["H09_20250101_0500", "scene_b"])):
        (root / split / "imgs").mkdir(parents=True)
        (root / split / "masks").mkdir()
        for i, name in enumerate(names):
            size = (16, 16) if split == "train" or i == 0 else (16, 24)
            Image.fromarray(np.zeros(size[::-1] + (3,), np.uint8)).save(
                root / split / "imgs" / f"{name}.png")
            if split == "train" or i == 0:
                Image.fromarray(np.zeros(size[::-1], np.uint8)).save(
                    root / split / "masks" / f"{name}_mask.png")


def test_doctor_report_as_jax(tmp_path, capsys):
    from iswm_tpu.data import doctor as jax_doctor

    _doctor_tree(tmp_path / "ok")
    (tmp_path / "empty" / "train" / "imgs").mkdir(parents=True)
    codes = {}
    for root in ("ok", "ok/train", "empty", "missing"):
        path = str(tmp_path / root)
        report = doctor.check_data_root(path)
        assert report == jax_doctor.check_data_root(path), root
        assert doctor.format_report(report) == jax_doctor.format_report(report), root
        codes[root] = doctor.main([path])
        printed = capsys.readouterr().out
        assert jax_doctor.main([path]) == codes[root], root
        assert capsys.readouterr().out == printed, root
    # the val split's missing mask, unstamped name and second size are reported
    # without failing it; a split without images or a missing root fail
    assert "1 filenames lack a sortable timestamp" in doctor.format_report(
        doctor.check_data_root(str(tmp_path / "ok")))
    assert codes == {"ok": 0, "ok/train": 0, "empty": 1, "missing": 1}
    assert doctor.main([]) == jax_doctor.main([]) == 2


def test_data_tools_run_as_modules(tmp_path):
    _doctor_tree(tmp_path / "d")
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                              text=True, timeout=120, env=env)

    proc = run("iswm_tpu_torch.data.doctor", str(tmp_path / "d" / "train"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("READY to train"), proc.stderr
    out = tmp_path / "m.json"
    proc = run("iswm_tpu_torch.data.manifest", "build", str(tmp_path / "d"), str(out))
    assert proc.returncode == 0 and proc.stdout.startswith("7 files"), proc.stderr
    assert json.loads(out.read_text())["nfiles"] == 7  # 4 images and 3 masks


# ------------------------------------------------------------------- misc
def test_misc_as_jax(tmp_path, capsys):
    from iswm_tpu.utils import misc as jax_misc

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rng = np.random.default_rng(9)
    for shape in ((3, 4, 5), (4, 5, 3), (2, 4, 5, 3)):
        a = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(denormalize(a, mean, std),
                                      jax_misc.denormalize(a, mean, std))
        np.testing.assert_array_equal(Denormalize(mean, std)(a),
                                      jax_misc.Denormalize(mean, std)(a))

    def boom():
        raise RuntimeError("nope")

    def fast():
        return 42

    for module in (sys.modules[safe_process.__module__], jax_misc):
        assert module.safe_process(error_value=-1)(boom)() == -1
        assert module.safe_process()(fast)() == 42
        out = capsys.readouterr().out
        assert "Error in boom: nope" in out and "RuntimeError: nope" in out
        assert module.timing_debug(fast)() == 42
        assert capsys.readouterr().out.startswith("fast took ")
    mkdir(str(tmp_path / "a" / "b"))
    mkdir(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    assert timing_debug(fast).__name__ == "fast"
    assert not hasattr(sys.modules[safe_process.__module__], "enable_compilation_cache")
