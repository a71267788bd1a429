"""Write or refresh ``manifest.json`` in prediction-cache directories (port
of ``scripts/cache_manifest.py``).

The stacked protocol's family-prediction caches are the inputs of its
quality rows, so each cache directory can carry a manifest of what a
COMPLETE cache holds: the family names, the fold indices, each file's
shape, dtype and bytes, and the storage policy. It lets a reader audit a
cache without loading its arrays.

    python -m mri_interpolation_tpu_torch.experiments.cache_manifest [cache_dir ...]

With no argument it writes one into every ``runs/stacked*cache*``
directory; it writes nothing else, and nowhere else.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from ..train.stacking import cached_family_names

__all__ = ["write_manifest", "main"]


def _entry(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            a = z["pred"]
            return {"format": "npz-f16", "shape": list(a.shape), "dtype": str(a.dtype),
                    "bytes": os.path.getsize(path)}
    a = np.load(path, mmap_mode="r")
    return {"format": "npy", "shape": list(a.shape), "dtype": str(a.dtype), "bytes": os.path.getsize(path)}


def write_manifest(cache: str) -> dict:
    names = cached_family_names(cache)
    files = {}
    for p in sorted(glob.glob(os.path.join(cache, "*.np[yz]"))):
        base = os.path.basename(p)
        if base.endswith(".tmp.npy") or base.endswith(".npz.tmp"):
            continue
        files[base] = _entry(p)
    folds = sorted({int(f.split("_", 1)[0][len("fold"):]) for f in files if f.startswith("fold")})
    manifest = {
        "cache": cache,
        "families": names,
        "n_families": len(names),
        "fold_indices": folds,
        "complete": all(any(f"fold{k}_{n}.{ext}" in files for ext in ("npy", "npz")) for n in names for k in folds),
        "total_bytes": sum(e["bytes"] for e in files.values()),
        "files": files,
        "policy": ("legacy fp32 .npy entries are committed history; every "
                   "NEW entry is fp16 .npz (train/stacking.py:_cached_call)"),
    }
    out = os.path.join(cache, "manifest.json")
    with open(out, "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{out}: {len(names)} families, {len(files)} files, "
          f"{manifest['total_bytes'] / 2**20:.0f} MiB, complete={manifest['complete']}")
    return manifest


def main(argv: Optional[Sequence[str]] = None) -> list:
    dirs = list(sys.argv[1:] if argv is None else argv) or sorted(
        d for d in glob.glob("runs/stacked*cache*") if os.path.isdir(d))
    return [write_manifest(d) for d in dirs]


if __name__ == "__main__":
    main()
