"""The port imports, and its CLIs run, with jax, flax, optax and the JAX
package ``iswm_tpu`` itself blocked: the machine with the card has none of
the first three, and the port keeps its own copy of whatever it needs from
the last."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

BLOCKER = textwrap.dedent("""
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "iswm_tpu"):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, _Block())
    BLOCKED = ("jax", "flax", "optax", "iswm_tpu")
""")


def _run_blocked(body: str) -> subprocess.CompletedProcess:
    # two threads: the suite's workers share the cores
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", BLOCKER + textwrap.dedent(body)],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def test_every_module_imports_without_jax():
    proc = _run_blocked("""
        import importlib, pkgutil
        import iswm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            iswm_tpu_torch.__path__, "iswm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print(len(names), "modules")
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 45


def test_the_parallel_package_imports_without_jax():
    """``iswm_tpu_torch.parallel`` alone, as the data-parallel ranks import it."""
    proc = _run_blocked("""
        import iswm_tpu_torch.parallel
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print(iswm_tpu_torch.parallel.world_size())
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1"]


def test_the_blocker_blocks_the_jax_package_only():
    proc = _run_blocked("""
        import importlib
        for name in ("iswm_tpu", "iswm_tpu.config", "jax"):
            try:
                importlib.import_module(name)
            except ImportError:
                continue
            raise SystemExit(f"{name} imported")
        import iswm_tpu_torch.config
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_cli_on_synthetic_data(tmp_path):
    proc = _run_blocked(f"""
        from iswm_tpu_torch.cli.train import main
        flags = ["--synthetic", "--device", "cpu", "--model", "deeplabv3plus_resnet18",
                 "--compute_dtype", "float32", "--crop_size", "32", "--batch_size", "2",
                 "--total_itrs", "4", "--val_interval", "2", "--print_interval", "2",
                 "--sequence_length", "3", "--val_dump_limit", "1"]
        for name in ("data_root", "checkpoints_dir", "val_results_dir",
                     "metrics_plots_dir", "log_dir"):
            flags += ["--" + name, {str(tmp_path)!r} + "/" + name]
        code = main(flags)
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        sys.exit(code)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "it 4/4 loss" in proc.stdout and "done: best weighted score" in proc.stdout
    assert len(list((tmp_path / "checkpoints_dir").glob("best_*.pth"))) == 1


def test_predict_cli_on_png_directory(tmp_path):
    from PIL import Image

    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for path in (src / "a.png", src / "sub" / "b.png"):
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(path)
    out = tmp_path / "out"
    proc = _run_blocked(f"""
        from iswm_tpu_torch.cli.predict import main
        code = main([
            "--input_dir", {str(src)!r}, "--output_dir", {str(out)!r},
            "--device", "cpu", "--model", "deeplabv3plus_resnet18",
            "--compute_dtype", "float32", "--serving_variant", "int8_exec",
            "--tile_size", "64", "--tile_overlap", "16", "--tile_batch", "2",
            "--save_confidence", "--save_binary",
        ])
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        sys.exit(code)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "processed 2 images" in proc.stdout
    for stem, d in (("a", out), ("b", out / "sub")):
        for suffix in ("predict", "confidence", "binary_mask"):
            with Image.open(d / f"{stem}_{suffix}.png") as im:
                assert im.size == (90, 70)


def test_evaluate_quantization_cli_on_png_tree(tmp_path):
    """All five ported variants over a flat imgs/ + masks/ tree of PNGs."""
    from iswm_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path), n_train=4, n_val=0, size=(48, 48), seed=3)
    panels = tmp_path / "panels"
    proc = _run_blocked(f"""
        from iswm_tpu_torch.cli.evaluate_quantization import main
        code = main([
            "--data_dir", {str(tmp_path / "train")!r}, "--device", "cpu",
            "--model", "deeplabv3plus_resnet18", "--compute_dtype", "float32",
            "--variants", "f32,bf16,int8,int8_act,int8_exec",
            "--sequence_length", "3", "--comparison_dir", {str(panels)!r},
        ])
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        sys.exit(code)
    """)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].split() == ["variant", "lat", "ms", "size", "MB", "MIoU", "FIoU", "FF1",
                                "dMIoU", "speedup", "agree", "verdict"]
    assert [ln.split()[0] for ln in lines[1:6]] == [
        "f32", "bf16", "int8", "int8_act", "int8_exec"]
    assert "reference variant" in lines[1] and lines[6].startswith("note:")
    assert (panels / "variant_comparison.png").exists()
