"""The readings that a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs do not run this):

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 --controls 3 [--seconds 2] [--out file.json]

- the program: a whole run of the cell (set-up, a short window at the
  cell's load, the check) on each of ``--seeds`` seeds, every number it
  compares;
- the control, on the first ``--controls`` of those seeds: the reference
  put in the program's place, computed one precision below the config's
  (TF32 for float32 with TF32 off), read against the reference;
- for a fit, the fault that needs a run, on the same seeds: half of each
  batch left out, the mean taken over the rest, planted in the reference.
  (A step that leaves its state unchanged reads 1 on ``change_gap`` and
  needs none.) The fit's control and fault run over ``checked_steps``
  batches of the cell's size, a permutation of the grid's rows drawn from
  the seed.

Prints one JSON line a reading and, last, the lower reading (the largest
that the program gave) and the upper one (the least that the control or a
fault gave) of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as bench_run
from . import spec


def _fit_faults(cell, seed, dev):
    import torch

    from . import data, reference
    from .entries.fit import reference_reading

    wl, cfg = cell.workload, cell.config
    batch, k = int(cfg["train"]["batch_size"]), int(wl["checked_steps"])
    vol = data.make_volume(cfg["volume"], seed, dev)
    coords, _ = data.training_set(vol)
    perm = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    xs = [coords[perm[s * batch:(s + 1) * batch]] for s in range(k)]
    halves = [x[: batch // 2] for x in xs]
    ref = reference_reading(cfg, wl, seed, dev, vol, xs)
    ctrl = reference_reading(cfg, wl, seed, dev, vol, xs, precision="tf32")
    half = reference_reading(cfg, wl, seed, dev, vol, halves)
    return {"control_tf32": reference.fit_gaps(ctrl, ref),
            "fault_half_batch": {**reference.fit_gaps(half, ref),
                                 "rows_short": data.rows_short(cfg["volume"], halves, k, batch)}}


def _interp_faults(cell, seed, dev):
    from . import data, reference
    from .common import strict_fp32

    cfg, wl = cell.config, cell.workload
    with strict_fp32():
        params = data.draw_weights(cfg, seed, dev, wl["weights"])
        ref = reference.grid_volume(cfg, params, wl["grid"])
        ctrl = reference.grid_volume(cfg, params, wl["grid"], precision="tf32")
    return {"control_tf32": {"volume_gap": reference.volume_gap(ctrl, ref)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=3_000_000_019)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench_run.set_cache_dirs()
    cell = spec.load_cell(args.workload)
    dev = bench_run.require_chips(cell.chips)
    from .common import free

    entry = spec.entry(cell)
    records = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        out = entry.run(cell, seed, args.seconds, False, dev, t0)
        rec = {"seed": seed, "kind": "program", "readings": {k: v for k, (v, _) in out.checks.items()},
               "metrics": out.metrics}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if i < args.controls:
            faults = _fit_faults(cell, seed, dev) if cell.workload["entry"] == "fit" else \
                _interp_faults(cell, seed, dev)
            for kind, readings in faults.items():
                rec = {"seed": seed, "kind": kind, "readings": readings}
                records.append(rec)
                print(json.dumps(rec), flush=True)
        del out
        free(dev)
    names = list(cell.workload["limits"])
    summary = {"workload": cell.name, "lower": {}, "upper": {}}
    kinds = sorted({r["kind"] for r in records if r["kind"] != "program"})
    for name in names:
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
