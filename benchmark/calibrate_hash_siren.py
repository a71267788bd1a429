"""The readings that the limits of ``hash_siren.fit`` are set from, on the
card at the cell's own size (the benchmark's runs do not run this):

    python3 -m benchmark.calibrate_hash_siren [--seeds 12] [--controls 3] [--seconds 2] [--out file.json]

- the program: a whole run of the cell (set-up, a short window, the check)
  on each of ``--seeds`` seeds, every number it compares;
- on the first ``--controls`` of those seeds, the reference in the
  program's place, read as the cell reads the program, over
  ``checked_steps`` batches of a permutation of the grid drawn from the
  seed: the control, the reference with its products in TF32; and three
  faults planted in it: the gates set to 1 (each sine layer's output left
  unmultiplied), the latent zeroed (the modulator fed zeros in place of the
  encoding), and half of each batch left out (the mean over the rest). A
  step that leaves its state unchanged reads 1 on ``change_gap`` and needs
  no run.

It runs ``calibrate_wire.py``'s loop over the seeds with these faults, and
prints as it does: one JSON line a reading and, last, the lower reading
(the largest that the program gave) and the upper ones (the least that
each control or fault gave) of each number.
"""

from __future__ import annotations

import sys

from . import calibrate_wire

CELL = "hash_siren.fit"


def faults(cell, seed, dev):
    """Each control's and fault's readings at ``seed``."""
    import torch

    from . import data
    from .entries.fit_hash_siren import check, reference_reading

    cfg, wl = cell.config, cell.workload
    batch, k = int(cfg["train"]["batch_size"]), int(wl["checked_steps"])
    vol = data.make_volume(cfg["volume"], seed, dev)
    coords = data.training_set(vol)[0]
    perm = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    xs = [coords[perm[i * batch:(i + 1) * batch]] for i in range(k)]
    planted = {"control_tf32": dict(precision="tf32"), "fault_gates_one": dict(fault="gates_one"),
               "fault_latent_zero": dict(fault="latent_zero")}
    out = {kind: check(cfg, vol, reference_reading(cfg, seed, dev, vol, xs, **kw), xs) for kind, kw in planted.items()}
    halves = [x[: batch // 2] for x in xs]
    out["fault_half_batch"] = {**check(cfg, vol, reference_reading(cfg, seed, dev, vol, halves), halves),
                               "rows_short": data.rows_short(cfg["volume"], halves, k, batch)}
    return out


def main(argv=None) -> int:
    """``calibrate_wire``'s loop over the seeds, with this cell's faults."""
    calibrate_wire.FAULTS[CELL] = faults
    return calibrate_wire.main(["--workload", CELL, *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
