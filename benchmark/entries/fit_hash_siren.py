"""Entry ``"fit_hash_siren"``: ``Trainer.fit`` of the hash SIREN on the whole
resident volume, one job.

It is the entry ``"fit"`` (``fit.py``: set-up, one warm-up call, the seed's
weights loaded again, a window of whole epochs timed whole, one traced
epoch cycle under ``--trace 1``, the first ``checked_steps`` steps of the
window's call judged by the reference) with what the hash SIREN changes:

- coordinates in [0, 1] (the hash encoding's domain, the launcher's
  default for hash models), values as the volume gives them;
- the weights from ``reference_hash_siren.init_params`` (the port
  factory's draws for the seed);
- each checked step is held to the reference from the state the fit
  reached (``reference_hash_siren.step_gaps``, read through
  ``fit_wire._StepCapture`` as ``wire.fit`` reads WIRE): kernel 2 sums the
  table gradient with float atomics in no fixed order, so two fits from
  one state part within a few steps;
- the least times are ``roofline_hash_siren``'s, at the table rows the
  checked steps' inputs touch;
- the traced epoch cycle opens behind a drained card (``fit_wire._DrainedTrace``).

Standard error also gives ``MODULATOR_ROWS``, the rows x layers the
modulator took over the window's call (its layers x the steps x the
batch), and ``sine_layer.LAUNCHES`` over it (one forward and one backward
a sine layer and step); a tree without the counter gives None.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import data, reference, reference_hash_siren, reference_wire, roofline_hash_siren
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer
from .fit import _train_config
from .fit_psf import PRODUCT_WORKS
from .fit_wire import _DrainedTrace, _StepCapture

HASH_WORKS = ["hash_forward", "hash_table_grad"]


def step_work(config: Dict, touched_rows: float) -> Dict:
    """Least seconds of one step, whole and by the parts the readers take."""
    grid = reference_hash_siren.make_grid(config)
    pieces = roofline_hash_siren.fit_step(int(config["train"]["batch_size"]), config, int(round(touched_rows)),
                                          grid.rows)
    return {
        "hash": {"least_s": pieces["hash"], "works": HASH_WORKS},
        "mlp": {"least_s": pieces["products"], "works": PRODUCT_WORKS},
        "gate": {"not_works": PRODUCT_WORKS + HASH_WORKS + ["optimizer"]},
        "optimizer": {"least_s": pieces["adam"], "works": ["optimizer"]},
        "whole_least_s": pieces["whole"],
    }


def batches(volume: torch.Tensor, xs: List[torch.Tensor]):
    """(x, y) of each input ``xs``, its values looked up in ``volume``."""
    return [(x, data.targets(volume, x)) for x in xs]


def check(config: Dict, volume: torch.Tensor, reading: Optional[reference_wire.StepReading],
          xs: List[torch.Tensor]) -> Dict[str, float]:
    """``reference_hash_siren.step_gaps`` of the fit's reading in float32,
    TF32 off; each gap infinite where the reading is incomplete."""
    if reading is None:
        return {name: math.inf for name in ("loss_gap", "grad_gap", "change_gap")}
    with strict_fp32():
        return reference_hash_siren.step_gaps(config, reading, batches(volume, xs))


def reference_reading(config: Dict, seed: int, dev: torch.device, volume: torch.Tensor, xs: List[torch.Tensor],
                      precision: str = "fp32", fault: Optional[str] = None) -> reference_wire.StepReading:
    """The reference's own steps from the seed's weights over the rows
    ``xs``, as a fit with the reference in the program's place would read;
    ``fault``: ``"gates_one"`` or ``"latent_zero"``
    (``reference_hash_siren.forward``)."""
    with strict_fp32():
        params = reference_hash_siren.init_params(config, seed, dev)
        return reference_hash_siren.fit_steps(config, params, batches(volume, xs), precision, fault)


def modulator_rows() -> Optional[int]:
    """The port's ``MODULATOR_ROWS`` count of the hash SIREN, or None where
    the port has none."""
    from mri_interpolation_tpu_torch.models import siren

    rows = getattr(siren, "MODULATOR_ROWS", None)
    return None if rows is None else rows["hash_siren"]


def reset_counters() -> None:
    from mri_interpolation_tpu_torch.models import siren
    from mri_interpolation_tpu_torch.ops import sine_layer

    sine_layer.reset_launches()
    if hasattr(siren, "reset_modulator_rows"):
        siren.reset_modulator_rows()


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
    from mri_interpolation_tpu_torch.ops import sine_layer
    from mri_interpolation_tpu_torch.train import Trainer

    config, wl = cell.config, cell.workload
    k = int(wl["checked_steps"])
    marks = [("start", time.perf_counter())]
    volume = data.make_volume(config["volume"], seed, dev)
    coords, values = data.training_set(volume)
    coords_np, values_np = coords.cpu().numpy(), values.cpu().numpy()
    del coords, values
    n = len(coords_np)
    batch = int(config["train"]["batch_size"])
    spe = n // batch
    if spe < k:
        raise ValueError(f"{spe} steps an epoch: fewer than the {k} checked steps")
    marks.append(("data", time.perf_counter()))
    weights = reference_hash_siren.init_params(config, seed, dev)
    model = model_builder(config)(config, dev)
    model.load_state_dict(weights)
    marks.append(("model", time.perf_counter()))

    Trainer(_train_config(config, seed, int(wl["warmup_epochs"]))).fit(model, coords_np, values_np, device=dev)
    model.load_state_dict(weights)
    capture = _StepCapture(model, k)
    del weights
    epochs = max(2, round(seconds * float(wl["epochs_per_s"])))
    tracer = hook = None
    if trace:
        tracer = Tracer()
        tracer.warm()
        hook = _DrainedTrace(tracer, spe, 2 * spe, dev)
    trainer = Trainer(_train_config(config, seed, epochs))
    reset_counters()
    sync(dev)
    reset_peak(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    host = HostMeter()
    t0 = time.perf_counter()
    try:
        result = trainer.fit(model, coords_np, values_np, device=dev)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        capture.close()
        if hook is not None:
            hook.close()

    memory = peak_bytes(dev)
    steps = epochs * spe
    layers = int(config["siren"]["n_layers"])
    failed = int((~np.isfinite(result.losses)).sum())
    notes = [f"fit_hash_siren: {epochs} epochs of {spe} steps at batch {batch} in {wall:.4f} s; "
             f"{steps * batch / wall:.1f} voxels/s; peak {memory} B",
             f"modulator rows over the window: {modulator_rows()} (modulator layers x steps x batch = "
             f"{layers * steps * batch})",
             f"sine-layer launches over the window: {dict(sine_layer.LAUNCHES)} (on the card: {layers * steps} each)",
             set_up_note(t_start, marks), host.note()]
    out = Outcome(metrics={"fit_voxels_per_s": steps * batch / wall, "setup_s": setup_s},
                  checks={}, attempted=steps, failed=failed, memory_peak_bytes=memory, notes=notes)
    if tracer is not None:
        if hook.steps < 2 * spe:
            raise RuntimeError("the traced epoch did not close inside the window")
        out.trace, out.units = tracer.read(), spe
        grid = reference_hash_siren.make_grid(config)
        touched = float(np.mean([reference.touched_rows(grid, x) for x in capture.xs]))
        out.work = step_work(config, touched)
        out.notes.append(f"trace: {spe} steps, {touched:.0f} table rows touched a step (mean of {k})")
    losses = [float(v) for v in result.losses[:k]]
    del model, result, trainer
    free(dev)

    gaps = check(config, volume, capture.reading(losses), capture.xs)
    gaps["rows_short"] = data.rows_short(config["volume"], capture.xs, k, batch)
    out.checks = {name: (gaps[name], float(limit)) for name, limit in wl["limits"].items()}
    out.notes.append("fit check: program losses " + ", ".join(f"{v:.9g}" for v in losses))
    return out
