"""Entry ``"fit_wire"``: ``Trainer.fit`` of WIRE on the whole resident volume,
full batch (every voxel every step), one job.

It is the entry ``"fit"`` (``fit.py``: set-up, one warm-up call, the seed's
weights loaded again, a window of whole epochs timed whole, the first
``checked_steps`` steps of the window's call judged by the reference) with
what WIRE changes:

- coordinates in [-1, 1] (the volume's grid ``2 c - 1``, WIRE's
  ``linspace(-1, 1)``), values as the volume gives them;
- the weights from ``reference_wire.init_params`` (the port factory's
  draws for the seed), loaded into the port's complex parameters;
- each checked step is held to the reference from the state the fit
  reached (``reference_wire.step_gaps``: its loss and gradient there, and
  Adam replayed over the gradients the fit fed it), every complex leaf
  read as its real and imaginary parts through ``torch.view_as_real``,
  Adam's first moment included. Two fits from one state part ways within
  three steps: Adam's first step moves every weight by the rate whatever
  its gradient's size, so the last bits of a near-zero gradient's sign
  move a weight by twice the rate, and WIRE's envelope (s0^2 = 100)
  makes that a loss gap of up to 1.9e-4 by the third step between two
  float32 summation orders, within 3.3x of what TF32 products read;
- the least times are ``roofline_wire``'s;
- an epoch is one step, so ``rows_short`` holds each checked step alone to
  the whole grid, each row once;
- with ``--trace 1`` the profiler covers ``trace_steps`` whole steps from
  the end of the window's first step, the card drained before it starts
  (an epoch's one step is about the card's whole work between two syncs,
  so a window opened behind queued work would read that work as idle).

Standard error also gives ``GABOR_ROWS``, the rows the complex Gabor
activations took over the window's call: the Gabor layers (3) x the steps x
the batch.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook, register_optimizer_step_pre_hook

from .. import data, reference_wire, roofline_psf, roofline_wire
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer
from .fit import _TraceEpoch, _train_config
from .fit_psf import PRODUCT_WORKS, unit_grid


class _StepCapture:
    """The first ``k`` steps of a fit as the port takes them
    (``reference_wire.StepReading``, less the losses, which the fit's
    result holds): each step's input and starting parameters (a forward
    pre-hook, which takes itself off after ``k``), the gradient each step
    fed Adam (an optimizer pre-hook) and, after step ``k``, the parameters
    and Adam's first moment (a post-hook); every complex leaf as its real
    and imaginary parts (``reference_wire.real_parts``). The tensors are
    copied on the device; the optimizer's hooks stay to the end of the fit
    and only count after step ``k``."""

    def __init__(self, model: torch.nn.Module, k: int):
        self.model, self.k = model, k
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.xs: List[torch.Tensor] = []
        self.params: List[Dict[str, torch.Tensor]] = []
        self.grads: List[Dict[str, torch.Tensor]] = []
        self.after: Dict[str, torch.Tensor] = {}
        self.first_moment: Dict[str, torch.Tensor] = {}
        self.steps = 0
        self.pre = model.register_forward_pre_hook(self._forward)
        self.opt_pre = register_optimizer_step_pre_hook(self._before)
        self.opt_post = register_optimizer_step_post_hook(self._after)

    def _parts(self, pairs) -> Dict[str, torch.Tensor]:
        return {key: t.detach().clone() for p, t in pairs for key, t in reference_wire.real_parts(self.names[id(p)], t)}

    def _forward(self, module, args):
        self.xs.append(args[0].detach().clone())
        self.params.append(self._parts((p, p) for p in self.model.parameters()))
        if len(self.xs) == self.k:
            self.pre.remove()  # the module's hooks are read from a copy: safe inside the call

    def _before(self, opt, args, kwargs):
        if self.steps < self.k:
            self.grads.append(self._parts((p, p.grad) for group in opt.param_groups for p in group["params"]))

    def _after(self, opt, args, kwargs):
        self.steps += 1
        if self.steps == self.k:
            params = [p for group in opt.param_groups for p in group["params"]]
            self.after = self._parts((p, p) for p in params)
            self.first_moment = self._parts((p, opt.state[p]["exp_avg"]) for p in params)

    def reading(self, losses: List[float]) -> Optional[reference_wire.StepReading]:
        """The reading, or None where the fit took fewer than ``k`` whole steps."""
        if not (len(self.xs) == len(self.params) == len(self.grads) == len(losses) == self.k and self.after):
            return None
        return reference_wire.StepReading(losses, self.params, self.grads, self.after, self.first_moment)

    def close(self) -> None:
        for handle in (self.pre, self.opt_pre, self.opt_post):
            handle.remove()


class _DrainedTrace(_TraceEpoch):
    """``_TraceEpoch`` that drains the device before it starts the tracer."""

    def __init__(self, tracer: Tracer, first: int, last: int, dev: torch.device):
        super().__init__(tracer, first, last)
        self.dev = dev

    def _post(self, opt, args, kwargs):
        if self.steps + 1 == self.first:
            sync(self.dev)
        super()._post(opt, args, kwargs)


def step_work(config: Dict) -> Dict:
    """Least seconds of one full-batch step, whole and of the products."""
    rows, dims = int(config["train"]["batch_size"]), reference_wire.layer_dims(config)
    return {
        "mlp": {"least_s": roofline_psf.least_s((0.0, roofline_wire.products(rows, dims), 0.0)),
                "works": PRODUCT_WORKS},
        "gabor": {"not_works": PRODUCT_WORKS + ["optimizer"]},
        "whole_least_s": roofline_psf.least_s(roofline_wire.fit_step(rows, dims)),
    }


def batches(volume: torch.Tensor, xs: List[torch.Tensor]):
    """(x, y) of each input ``xs``, its values looked up in ``volume``."""
    return [(x, data.targets(volume, unit_grid(x))) for x in xs]


def check(config: Dict, volume: torch.Tensor, reading: Optional[reference_wire.StepReading],
          xs: List[torch.Tensor]) -> Dict[str, float]:
    """``reference_wire.step_gaps`` of the fit's reading in float32, TF32
    off; each gap infinite where the reading is incomplete."""
    if reading is None:
        return {name: math.inf for name in ("loss_gap", "grad_gap", "change_gap")}
    with strict_fp32():
        return reference_wire.step_gaps(config, reading, batches(volume, xs))


def reference_reading(config: Dict, seed: int, dev: torch.device, volume: torch.Tensor, xs: List[torch.Tensor],
                      precision: str = "fp32", **fault) -> reference_wire.StepReading:
    """The reference's own steps from the seed's weights over the rows
    ``xs``, as a fit with the reference in the program's place would read;
    ``fault``: ``s0`` or ``conjugate`` (``reference_wire.fit_steps``)."""
    with strict_fp32():
        params = reference_wire.init_params(config, seed, dev)
        return reference_wire.fit_steps(config, params, batches(volume, xs), precision, **fault)


def rows_short(config: Dict, xs: List[torch.Tensor], k: int, batch: int) -> int:
    """Rows missing from ``k`` batches that each hold every grid row once."""
    short = (k - len(xs)) * batch
    return short + sum(data.rows_short(config["volume"], [unit_grid(x)], 1, batch) for x in xs[:k])


def gabor_rows():
    """The port's ``GABOR_ROWS`` count, or None where the port has none."""
    from mri_interpolation_tpu_torch.models import gabor

    rows = getattr(gabor, "GABOR_ROWS", None)
    return None if rows is None else sum(rows.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
    from mri_interpolation_tpu_torch.models import gabor
    from mri_interpolation_tpu_torch.train import Trainer

    config, wl = cell.config, cell.workload
    k = int(wl["checked_steps"])
    marks = [("start", time.perf_counter())]
    volume = data.make_volume(config["volume"], seed, dev)
    coords, values = data.training_set(volume)
    coords_np, values_np = (coords * 2.0 - 1.0).cpu().numpy(), values.cpu().numpy()
    del coords, values
    n = len(coords_np)
    batch = int(config["train"]["batch_size"])
    spe = n // batch
    marks.append(("data", time.perf_counter()))
    weights = reference_wire.port_state(reference_wire.init_params(config, seed, dev))
    model = model_builder(config)(config, dev)
    model.load_state_dict(weights)
    marks.append(("model", time.perf_counter()))

    Trainer(_train_config(config, seed, int(wl["warmup_epochs"]))).fit(model, coords_np, values_np, device=dev)
    model.load_state_dict(weights)
    capture = _StepCapture(model, k)
    del weights
    epochs = max(2, k, round(seconds * float(wl["epochs_per_s"])))  # an epoch is one step: k at least
    traced = int(wl["trace_steps"])
    tracer = hook = None
    if trace:
        tracer = Tracer()
        tracer.warm()
        hook = _DrainedTrace(tracer, spe, spe + traced * spe, dev)
        epochs = max(epochs, 1 + traced + 1)
    trainer = Trainer(_train_config(config, seed, epochs))
    gabor.reset_gabor_rows()
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
    layers = 1 + int(config["wire"]["hidden_layers"])
    failed = int((~np.isfinite(result.losses)).sum())
    notes = [f"fit_wire: {epochs} epochs of {spe} steps at batch {batch} in {wall:.4f} s; "
             f"{steps * batch / wall:.1f} voxels/s; peak {memory} B",
             f"gabor rows over the window: {gabor_rows()} (Gabor layers x steps x batch = {layers * steps * batch})",
             set_up_note(t_start, marks), host.note()]
    out = Outcome(metrics={"fit_voxels_per_s": steps * batch / wall, "setup_s": setup_s},
                  checks={}, attempted=steps, failed=failed, memory_peak_bytes=memory, notes=notes)
    if tracer is not None:
        if hook.steps < spe + traced * spe:
            raise RuntimeError("the traced steps did not close inside the window")
        out.trace, out.units = tracer.read(), traced * spe
        out.work = step_work(config)
        out.notes.append(f"trace: {traced * spe} steps")
    losses = [float(v) for v in result.losses[:k]]
    del model, result, trainer
    free(dev)

    gaps = check(config, volume, capture.reading(losses), capture.xs)
    gaps["rows_short"] = rows_short(config, capture.xs, k, batch)
    out.checks = {name: (gaps[name], float(limit)) for name, limit in wl["limits"].items()}
    out.notes.append("fit check: program losses " + ", ".join(f"{v:.9g}" for v in losses))
    return out
