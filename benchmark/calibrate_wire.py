"""The readings that the limits of ``wire.fit`` and ``psf_siren.interp`` are
set from, on the card at the cells' own sizes (the benchmark's runs do not
run this):

    python3 -m benchmark.calibrate_wire [--workload wire.fit] [--seeds 12] [--controls 3] [--seconds 2]
        [--out file.json]

- the program: a whole run of the cell (set-up, a short window, the check)
  on each of ``--seeds`` seeds, every number it compares;
- on the first ``--controls`` of those seeds, the reference in the
  program's place, read as the cell reads the program: the control, the
  reference with its products in TF32; for ``wire.fit`` also three faults
  planted in it, over ``checked_steps`` full batches in permutations of
  the grid drawn from the seed: the Gaussian envelope dropped (s0 = 0; a
  reading that is not finite reads infinite), Adam fed the conjugate
  gradient, and half of each batch left out (the mean over the rest). A
  step that leaves its state unchanged reads 1 on ``change_gap`` and needs
  no run.

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


def _wire_faults(cell, seed, dev):
    import torch

    from . import data
    from .entries.fit_wire import check, reference_reading, rows_short

    cfg, wl = cell.config, cell.workload
    batch, k = int(cfg["train"]["batch_size"]), int(wl["checked_steps"])
    vol = data.make_volume(cfg["volume"], seed, dev)
    coords = data.training_set(vol)[0] * 2.0 - 1.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [coords[torch.randperm(len(coords), generator=gen, device=dev)[:batch]] for _ in range(k)]
    planted = {"control_tf32": dict(precision="tf32"), "fault_envelope_dropped": dict(s0=0.0),
               "fault_conjugate_grad": dict(conjugate=True)}
    out = {kind: check(cfg, vol, reference_reading(cfg, seed, dev, vol, xs, **kw), xs) for kind, kw in planted.items()}
    halves = [x[: batch // 2] for x in xs]
    out["fault_half_batch"] = {**check(cfg, vol, reference_reading(cfg, seed, dev, vol, halves), halves),
                               "rows_short": rows_short(cfg, halves, k, batch)}
    return out


def _interp_faults(cell, seed, dev):
    from . import reference, reference_psf
    from .common import strict_fp32
    from .entries.interp_siren import reference_volume

    cfg, wl = cell.config, cell.workload
    with strict_fp32():
        params = reference_psf.init_params(cfg, seed, dev)
        ref = reference_volume(cfg, params, wl["grid"], float(wl["lo"]))
        ctrl = reference_volume(cfg, params, wl["grid"], float(wl["lo"]), precision="tf32")
    return {"control_tf32": {"volume_gap": reference.volume_gap(ctrl, ref)}}


FAULTS = {"wire.fit": _wire_faults, "psf_siren.interp": _interp_faults}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="wire.fit", choices=sorted(FAULTS))
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
        out = entry.run(cell, seed, args.seconds, False, dev, time.perf_counter())
        records.append({"seed": seed, "kind": "program", "readings": {k: v for k, (v, _) in out.checks.items()},
                        "metrics": out.metrics, "memory_peak_bytes": out.memory_peak_bytes, "notes": out.notes})
        print(json.dumps(records[-1]), flush=True)
        del out
        free(dev)
        if i < args.controls:
            for kind, readings in FAULTS[cell.name](cell, seed, dev).items():
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
