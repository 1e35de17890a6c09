"""The port imports, and its predict CLI runs, with jax, flax and optax
blocked: the machine with the card has none of them."""

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
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, _Block())
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
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")]
        print(len(names), "modules")
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


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
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")]
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
        sys.exit(main([
            "--input_dir", {str(src)!r}, "--output_dir", {str(out)!r},
            "--device", "cpu", "--model", "deeplabv3plus_resnet18",
            "--compute_dtype", "float32", "--serving_variant", "int8_exec",
            "--tile_size", "64", "--tile_overlap", "16", "--tile_batch", "2",
            "--save_confidence", "--save_binary",
        ]))
    """)
    assert proc.returncode == 0, proc.stderr
    assert "processed 2 images" in proc.stdout
    for stem, d in (("a", out), ("b", out / "sub")):
        for suffix in ("predict", "confidence", "binary_mask"):
            with Image.open(d / f"{stem}_{suffix}.png") as im:
                assert im.size == (90, 70)
