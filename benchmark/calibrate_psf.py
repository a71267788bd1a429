"""The readings that ``psf_siren.fit``'s limits are set from, on the card at
the cell's own size (the benchmark's runs do not run this):

    python3 -m benchmark.calibrate_psf [--seeds 12] [--controls 3] [--seconds 20] [--out file.json]

- the program: a whole run of the cell (set-up, the window of whole
  epochs, the check) on each of ``--seeds`` seeds, every number it
  compares;
- on the first ``--controls`` of those seeds, over ``checked_steps``
  batches of the cell's size from a permutation of the grid drawn from the
  seed, read against the reference: the control (the reference with its
  products in TF32) and three faults planted in it: the PSF cut to its
  centre point, uniform PSF weights, and half of each batch left out (the
  mean over the rest). A step that leaves its state unchanged reads 1 on
  ``change_gap`` and needs no run.

Prints one JSON line a reading and, last, the lower reading (the largest
that the program gave) and the upper ones (the least that each control or
fault gave) of each number, as ``calibrate.py`` does for the other cells.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as bench_run
from . import spec

CELL = "psf_siren.fit"


def _faults(cell, seed, dev):
    import torch

    from . import data, reference, reference_psf
    from .entries.fit_psf import centred_volume, reference_reading, unit_grid

    cfg, wl = cell.config, cell.workload
    batch, k = int(cfg["train"]["batch_size"]), int(wl["checked_steps"])
    vol = centred_volume(cfg, seed, dev)
    coords = data.training_set(vol)[0] * 2.0 - 1.0
    perm = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    xs = [coords[perm[s * batch:(s + 1) * batch]] for s in range(k)]
    offsets, weights = reference_psf.psf_points(reference_psf.half_extents(cfg), int(cfg["psf"]["n_sample"]), dev)
    centre = len(weights) // 2
    planted = {"control_tf32": dict(precision="tf32"),
               "fault_psf_centre_only": dict(psf=(offsets[centre:centre + 1], torch.ones(1, device=dev))),
               "fault_psf_uniform_weights": dict(psf=(offsets, torch.full_like(weights, 1.0 / len(weights))))}
    ref = reference_reading(cfg, seed, dev, vol, xs)
    out = {kind: reference.fit_gaps(reference_reading(cfg, seed, dev, vol, xs, **kw), ref)
           for kind, kw in planted.items()}
    halves = [x[: batch // 2] for x in xs]
    out["fault_half_batch"] = {**reference.fit_gaps(reference_reading(cfg, seed, dev, vol, halves), ref),
                               "rows_short": data.rows_short(cfg["volume"], [unit_grid(x) for x in halves], k, batch)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=3_000_000_019)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench_run.set_cache_dirs()
    cell = spec.load_cell(CELL)
    dev = bench_run.require_chips(cell.chips)
    from .common import free

    entry = spec.entry(cell)
    records = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        out = entry.run(cell, seed, args.seconds, False, dev, time.perf_counter())
        records.append({"seed": seed, "kind": "program", "readings": {k: v for k, (v, _) in out.checks.items()},
                        "metrics": out.metrics, "memory_peak_bytes": out.memory_peak_bytes, "notes": out.notes})
        print(json.dumps(records[-1]), flush=True)
        del out
        free(dev)
        if i < args.controls:
            for kind, readings in _faults(cell, seed, dev).items():
                records.append({"seed": seed, "kind": kind, "readings": readings})
                print(json.dumps(records[-1]), flush=True)
            free(dev)
    kinds = sorted({r["kind"] for r in records if r["kind"] != "program"})
    summary = {"workload": cell.name, "lower": {}, "upper": {}}
    for name in cell.workload["limits"]:
        summary["lower"][name] = max(r["readings"][name] for r in records if r["kind"] == "program")
        summary["upper"][name] = {kind: min(r["readings"][name] for r in records if r["kind"] == kind)
                                  for kind in kinds
                                  if all(name in r["readings"] for r in records if r["kind"] == kind)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": records, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
