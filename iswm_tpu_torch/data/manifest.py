"""Dataset versioning manifests, the port's copy of ``iswm_tpu/data/manifest.py``
(same manifest format, report and exit codes).

The reference versions its 244MB dataset through DVC + S3 with a CI rule
gating .dvc changes (reference data.dvc:1-6, .dvc/config:1-5,
.github/workflows/dvc_data_check.yml:9-45).  This is the storage-agnostic
equivalent: a content manifest (per-file MD5 + byte counts, like DVC's
.dir objects) that is committed next to the code, plus a verifier CI can
run against a pulled dataset tree.

    python -m iswm_tpu_torch.data.manifest build  <data_root> [manifest.json]
    python -m iswm_tpu_torch.data.manifest verify <data_root> <manifest.json>
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path
from typing import Dict


def _file_md5(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def build_manifest(data_root: str) -> Dict:
    root = Path(data_root)
    files = sorted(
        p for p in root.rglob("*") if p.is_file() and not p.name.startswith(".")
    )
    entries = {
        str(p.relative_to(root)): {"md5": _file_md5(p), "size": p.stat().st_size}
        for p in files
    }
    total = sum(e["size"] for e in entries.values())
    return {"nfiles": len(entries), "size": total, "files": entries}


def verify_manifest(data_root: str, manifest: Dict) -> Dict:
    """Returns {'ok': bool, 'missing': [...], 'changed': [...], 'extra': [...]}."""
    root = Path(data_root)
    missing, changed = [], []
    for rel, meta in manifest["files"].items():
        p = root / rel
        if not p.is_file():
            missing.append(rel)
        elif p.stat().st_size != meta["size"] or _file_md5(p) != meta["md5"]:
            changed.append(rel)
    present = {
        str(p.relative_to(root))
        for p in root.rglob("*")
        if p.is_file() and not p.name.startswith(".")
    }
    extra = sorted(present - set(manifest["files"]))
    return {
        "ok": not missing and not changed,
        "missing": missing,
        "changed": changed,
        "extra": extra,
    }


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[0] not in ("build", "verify"):
        print(__doc__)
        return 2
    cmd, data_root = argv[0], argv[1]
    if cmd == "build":
        out = argv[2] if len(argv) > 2 else "manifest.json"
        manifest = build_manifest(data_root)
        with open(out, "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"{manifest['nfiles']} files, {manifest['size']} bytes -> {out}")
        return 0
    with open(argv[2]) as f:
        manifest = json.load(f)
    report = verify_manifest(data_root, manifest)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
