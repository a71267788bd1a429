"""Entry ``"fit_psf"``: ``Trainer.fit`` of the PSF SIREN on the whole resident
volume, one job, as the launcher runs ``--model_class psf_siren
--zero_centered true``.

It is the entry ``"fit"`` (``fit.py``: set-up, one warm-up call, the seed's
weights loaded again, a window of whole epochs timed whole, one traced
epoch cycle under ``--trace 1``, the first ``checked_steps`` steps of the
window's call followed by the reference) with what the PSF objective
changes:

- coordinates and values in [-1, 1] (the volume's grid ``2 c - 1`` and
  ``2 v - 1``), the launcher's zero-centred data;
- SIREN's initialisation from the seed (``reference_psf.init_params``);
- the inputs judged are the voxel centres that the objective took, caught
  at the model's ``loss`` hook, not the B x K rows its forward sees;
  ``rows_short`` holds them to whole batches of distinct grid voxels;
- the reference is ``reference_psf.fit_steps`` and the least times are
  ``roofline_psf``'s.

``fit_voxels_per_s`` counts voxel centres (the batch a step), not the PSF's
points.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import data, reference, reference_psf, roofline, roofline_psf
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer
from .fit import _Capture, _TraceEpoch, _train_config

PRODUCT_WORKS = ["mlp_forward", "mlp_backward", "mlp_dense"]


class _CentreCapture(_Capture):
    """``_Capture`` with the inputs taken at the model's ``loss`` hook (the
    voxel centres of each step) in place of its forward pre-hook; the hook
    is given back on :meth:`close`."""

    def __init__(self, model: torch.nn.Module, start: Dict[str, torch.Tensor], k: int):
        super().__init__(model, start, k)
        self.pre.remove()
        self.model, self.hook = model, model.loss
        model.loss = self._loss

    def _loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if len(self.xs) < self.k:
            self.xs.append(x.detach().clone())
        return self.hook(x, y)

    def close(self) -> None:
        super().close()
        self.model.loss = self.hook


def step_work(config: Dict) -> Dict:
    """Least seconds of one step, whole and of the SIREN's products."""
    batch, k = int(config["train"]["batch_size"]), int(config["psf"]["n_sample"]) ** 3
    dims = reference_psf.layer_dims(config)
    return {
        "mlp": {"least_s": roofline_psf.least_s(roofline_psf.siren_train(batch * k, dims)), "works": PRODUCT_WORKS},
        "psf": {"not_works": PRODUCT_WORKS + ["optimizer"]},
        "whole_least_s": roofline_psf.least_s(roofline_psf.fit_step(batch, k, dims, roofline.mlp_params(dims))),
    }


def unit_grid(x: torch.Tensor) -> torch.Tensor:
    """Coordinates in [-1, 1] back on the [0, 1] grid ``data`` reads."""
    return (x + 1.0) * 0.5


def reference_reading(config: Dict, seed: int, dev: torch.device, volume: torch.Tensor, xs: List[torch.Tensor],
                      precision: str = "fp32", psf=None) -> reference.FitReading:
    """The reference's steps from the seed's weights over the voxel centres
    ``xs`` (their values looked up in ``volume``, in [-1, 1])."""
    with strict_fp32():
        params = reference_psf.init_params(config, seed, dev)
        batches = [(x, data.targets(volume, unit_grid(x))) for x in xs]
        return reference_psf.fit_steps(config, params, batches, precision, psf)


def centred_volume(config: Dict, seed: int, dev: torch.device) -> torch.Tensor:
    """The seed's volume with its values in [-1, 1]."""
    return data.make_volume(config["volume"], seed, dev) * 2.0 - 1.0


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
    from mri_interpolation_tpu_torch.train import Trainer

    config, wl = cell.config, cell.workload
    k = int(wl["checked_steps"])
    marks = [("start", time.perf_counter())]
    volume = centred_volume(config, seed, dev)
    coords, values = data.training_set(volume)
    coords_np, values_np = (coords * 2.0 - 1.0).cpu().numpy(), values.cpu().numpy()
    del coords, values
    n = len(coords_np)
    batch = int(config["train"]["batch_size"])
    spe = n // batch
    marks.append(("data", time.perf_counter()))
    weights = reference_psf.init_params(config, seed, dev)
    model = model_builder(config)(config, dev)
    model.load_state_dict(weights)
    marks.append(("model", time.perf_counter()))

    Trainer(_train_config(config, seed, int(wl["warmup_epochs"]))).fit(model, coords_np, values_np, device=dev)
    model.load_state_dict(weights)
    capture = _CentreCapture(model, {name: w.cpu() for name, w in weights.items()}, k)
    del weights
    epochs = max(2, round(seconds * float(wl["epochs_per_s"])))
    tracer = hook = None
    if trace:
        tracer = Tracer()
        tracer.warm()
        hook = _TraceEpoch(tracer, spe, 2 * spe)
    trainer = Trainer(_train_config(config, seed, epochs))
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
    failed = int((~np.isfinite(result.losses)).sum())
    notes = [f"fit_psf: {epochs} epochs of {spe} steps at batch {batch} ({batch * model.offsets.shape[0]} SIREN "
             f"rows a step) in {wall:.4f} s; {steps * batch / wall:.1f} voxels/s; peak {memory} B",
             set_up_note(t_start, marks), host.note()]
    out = Outcome(metrics={"fit_voxels_per_s": steps * batch / wall, "setup_s": setup_s},
                  checks={}, attempted=steps, failed=failed, memory_peak_bytes=memory, notes=notes)
    if tracer is not None:
        if hook.steps < 2 * spe:
            raise RuntimeError("the traced epoch did not close inside the window")
        out.trace, out.units = tracer.read(), spe
        out.work = step_work(config)
        out.notes.append(f"trace: {spe} steps")
    losses = [float(v) for v in result.losses[:k]]
    del model, result, trainer
    free(dev)

    ref = reference_reading(config, seed, dev, volume, capture.xs)
    prog = reference.FitReading(losses, capture.grad_norms, capture.change_norms)
    complete = len(capture.xs) == len(prog.losses) == k and prog.grad_norms and prog.change_norms
    gaps = reference.fit_gaps(prog, ref) if complete else {name: math.inf for name in wl["limits"]}
    gaps["rows_short"] = data.rows_short(config["volume"], [unit_grid(x) for x in capture.xs], k, batch)
    out.checks = {name: (gaps[name], float(limit)) for name, limit in wl["limits"].items()}
    out.notes.append("fit check: program losses " + ", ".join(f"{v:.9g}" for v in prog.losses)
                     + "; reference " + ", ".join(f"{v:.9g}" for v in ref.losses))
    return out
