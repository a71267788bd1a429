"""End-to-end rates of the launcher's single-volume paths, on the card.

Runs the three paths of ``chip_smoke.py``'s phase 5 that predate the
trainer's options, one epoch each on a synthetic (352, 352, 15) volume,
then the (352, 352, 30) grid: the flagship (``launcher.run`` defaults,
batch 10,000: 185 steps), path A (``--config_preset siren``, batch 4096:
453 steps) and path B (the tcnn flags: 185 steps). For each it prints
steps/s and training voxel-evals/s over the whole fit wall, and grid
voxels/s. The kernels are built before the first path; ``--repeats R``
runs the three paths R times in turn in one process (the first round pays
the process's warm-up, as a single launcher run does). It uses only the
launcher's public calls and the summary keys every version of the port
writes, so the same file times another checkout of the package: copy it
into that checkout's package and run it there, alternating with this one
on the same machine. Run on a machine with a card:

    python -m mri_interpolation_tpu_torch.path_rates [--label NAME] [--repeats R]

The last line is one JSON object {"label", "paths": {path: [{"steps",
"train_wall_s", "steps_per_s", "train_voxel_evals_per_s",
"grid_voxels_per_s"}, one a round]}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["run", "main"]

VOLUME = (352, 352, 15)
GRID = (352, 352, 30)
TCNN_FLAGS = ["--n_levels", "16", "--n_features_per_level", "2", "--log2_hashmap_size", "19",
              "--base_resolution", "16", "--per_level_scale", "1.4", "--dim_hidden", "128", "--n_layers", "2",
              "--decoder", "relu_plain", "--lr", "1e-2", "--optimizer", "adam_tcnn"]


def _rates(summary: dict) -> Dict[str, float]:
    wall = summary["train_wall_s"]
    steps, batch = summary["steps"], summary["batch_size"]
    return {"steps": steps, "train_wall_s": wall, "steps_per_s": steps / wall,
            "train_voxel_evals_per_s": steps * batch / wall,
            "grid_voxels_per_s": float(np.prod(GRID)) / summary["interp_eval_s"][str(GRID)]}


def run(label: str = "", repeats: int = 1) -> dict:
    """The three paths in order, ``repeats`` rounds; returns {"label", "paths"}."""
    from . import launcher
    from .configs import RunConfig
    from .io import nifti, synthetic_volume
    from .ops import build

    for name in build.SOURCES:
        build.load(name)
    paths = {"flagship": [], "A": [], "B": []}
    with tempfile.TemporaryDirectory(prefix="path_rates_") as tmp:
        vol = os.path.join(tmp, "synthetic_352x352x15.nii.gz")
        nifti.save(synthetic_volume(VOLUME, seed=0), vol)
        common = ["--image_path", vol, "--epochs", "1", "--interp_shapes", str(GRID)]

        def cli(argv: Sequence[str]) -> dict:
            with contextlib.redirect_stdout(io.StringIO()):
                return launcher.main(list(argv))

        for _ in range(repeats):
            paths["flagship"].append(_rates(launcher.run(RunConfig(
                image_path=vol, output_root=os.path.join(tmp, "f"), epochs=1, interp_shapes=(GRID,)))))
            paths["A"].append(_rates(cli(["--config_preset", "siren", "--output_root", os.path.join(tmp, "a"),
                                          *common])))
            paths["B"].append(_rates(cli([*TCNN_FLAGS, "--output_root", os.path.join(tmp, "b"), *common])))
    return {"label": label, "paths": paths}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this checkout in the printed lines")
    ap.add_argument("--repeats", type=int, default=1, help="rounds of the three paths in this process")
    args = ap.parse_args(argv)
    out = run(args.label, args.repeats)
    for name, rounds in out["paths"].items():
        for k, r in enumerate(rounds):
            print(f"[{args.label}] {name} round {k}: {r['steps']} steps in {r['train_wall_s']:.3f} s = "
                  f"{r['steps_per_s']:.1f} steps/s, {r['train_voxel_evals_per_s']:,.0f} voxel-evals/s; grid "
                  f"{r['grid_voxels_per_s']:,.0f} voxels/s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
