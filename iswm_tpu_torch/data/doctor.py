"""Real-data readiness checker, the port's copy of ``iswm_tpu/data/doctor.py``
(same report, same exit codes).

The reference trains on a DVC-versioned tree of 11,712 files / 244 MB
(reference data.dvc:1-6) whose dataset class did not survive the snapshot
(SURVEY §0.1.1), so the layout this framework reads is the one surviving
in-repo convention (reference evaluate_quantization.py:34-79):

    <data_root>/
      train/imgs/{name}.png        train/masks/{name}_mask.png
      val/imgs/{name}.png          val/masks/{name}_mask.png

with filenames that sort chronologically (the validation loop sorts by
filename as a timestamp proxy, reference train.py:673).

``check_data_root`` audits a tree against that contract and returns a
machine-readable report; the CLI prints it:

    python -m iswm_tpu_torch.data.doctor <data_root>

Exit status 0 = ready to train; 1 = problems found.  See docs/REAL_DATA.md
for the dvc-pull -> doctor -> train runbook.
"""

from __future__ import annotations

import os
import re
import sys
from pathlib import Path
from typing import Dict, List

from .datasets import IMG_EXTENSIONS

# Himawari-style sortable timestamp somewhere in the stem, e.g.
# H09_20250101_0400 or 202007210400; any run of >= 8 digits qualifies.
_TIMESTAMP_RE = re.compile(r"\d{8,}")


def _split_report(base: Path) -> Dict:
    report: Dict = {"path": str(base), "ok": True, "problems": []}
    img_dir, mask_dir = base / "imgs", base / "masks"
    if not img_dir.is_dir():
        report["ok"] = False
        report["problems"].append(f"missing directory: {img_dir}")
        return report
    images = sorted(
        f for f in os.listdir(img_dir) if f.lower().endswith(IMG_EXTENSIONS)
    )
    report["n_images"] = len(images)
    if not images:
        report["ok"] = False
        report["problems"].append(f"no images in {img_dir}")
        return report

    # mask pairing ({name}_mask{ext}; a missing mask is a no-wave frame, so
    # only *systematic* absence is flagged)
    n_masks = 0
    if mask_dir.is_dir():
        mask_names = set(os.listdir(mask_dir))
        for f in images:
            stem, ext = os.path.splitext(f)
            if any(
                f"{stem}_mask{e}" in mask_names
                for e in (ext,) + tuple(x for x in IMG_EXTENSIONS if x != ext)
            ):
                n_masks += 1
    report["n_masks"] = n_masks
    if n_masks == 0:
        report["problems"].append(
            f"no {{name}}_mask.* files under {mask_dir} — every label would "
            f"be the empty-mask fallback (training would learn nothing)"
        )
        report["ok"] = False

    # timestamp sortability: filename sort must equal time sort
    n_stamped = sum(1 for f in images if _TIMESTAMP_RE.search(f))
    report["n_timestamped"] = n_stamped
    if n_stamped < len(images):
        report["problems"].append(
            f"{len(images) - n_stamped} filenames lack a sortable timestamp "
            f"(validation's 7-frame windows assume filename sort == time "
            f"sort, reference train.py:673)"
        )

    # uniform image sizes within the split (the batch iterator stacks)
    try:
        from PIL import Image

        sizes = set()
        for f in images[:: max(1, len(images) // 16)]:  # sample <= 17 files
            with Image.open(img_dir / f) as im:
                sizes.add(im.size)
        report["image_sizes"] = sorted(sizes)
        if len(sizes) > 1:
            report["problems"].append(
                f"mixed image sizes {sorted(sizes)} — batches require uniform "
                f"sizes (crop/resize first, or batch_size=1)"
            )
    except Exception as e:  # pragma: no cover - PIL always present in image
        report["problems"].append(f"could not probe image sizes: {e}")
    return report


def check_data_root(data_root: str) -> Dict:
    """Audit ``data_root`` for train-readiness; see module docstring."""
    root = Path(data_root)
    report: Dict = {"data_root": str(root), "ok": True, "splits": {}}
    if not root.is_dir():
        return {"data_root": str(root), "ok": False,
                "problems": [f"not a directory: {root}"], "splits": {}}
    for split in ("train", "val"):
        base = root / split
        if not base.is_dir() and (root / "imgs").is_dir():
            base = root  # flat split-less tree (BinarySegmentation accepts it)
        sub = _split_report(base)
        report["splits"][split] = sub
        report["ok"] = report["ok"] and sub["ok"]
    return report


def format_report(report: Dict) -> str:
    lines: List[str] = [f"data_root: {report['data_root']}"]
    for split, sub in report.get("splits", {}).items():
        status = "ok" if sub.get("ok") else "PROBLEM"
        lines.append(
            f"  {split:5s} [{status}] images={sub.get('n_images', 0)} "
            f"masks={sub.get('n_masks', 0)} "
            f"timestamped={sub.get('n_timestamped', 0)} "
            f"sizes={sub.get('image_sizes', '?')}"
        )
        for p in sub.get("problems", []):
            lines.append(f"         - {p}")
    for p in report.get("problems", []):
        lines.append(f"  - {p}")
    lines.append("READY to train" if report.get("ok") else "NOT ready")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print(__doc__)
        return 2
    report = check_data_root(argv[0])
    print(format_report(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
