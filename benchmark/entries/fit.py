"""Entry ``"fit"``: ``Trainer.fit`` on the whole resident volume, one job.

Set-up makes the volume and the weights from the seed on the device,
builds the port's model through its factory, loads the weights, and
drives the model through ``warmup_epochs`` whole epochs of ``Trainer.fit``
(the call the window makes, on the same arrays), which builds and warms
every kernel. It then loads the seed's weights into the same model again:
the window's call starts where the warm-up's did.

The window is one ``Trainer.fit`` call of a fixed number of whole epochs,
``--seconds`` times the cell's nominal ``epochs_per_s`` (at least two): the
work does not follow the host's speed at the run, and the window lasts
about ``--seconds`` on a card at that rate. It is timed whole by the host
clock: ``fit_voxels_per_s`` is its steps times the batch over that wall,
the per-epoch syncs and the call's copy of the set to the device included.
With ``--trace 1`` the profiler covers one whole epoch cycle inside it:
from the end of epoch 0's last step (its loss sync, epoch 1's permutation
and steps) to the end of epoch 1's last step.

What is judged is the window's own call: its first ``checked_steps`` steps,
which the reference follows from the seed's weights: the inputs the model
was called with (a forward pre-hook), each step's loss, the first gradient
as Adam holds it after one step (its first moment is (1 - b1) g), and each
leaf's change after the last checked step. ``rows_short`` counts the rows
that those steps' inputs lack of whole batches of distinct grid rows
(limit 0): a batch cut short, or rows repeated, read wrong even where the
reference, fed the same inputs, would agree. A step of the window whose
loss is not finite counts in ``failed``, and fails the run.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from .. import data, reference, roofline
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer


_CHUNK = 1 << 18  # elements a norm reads at a time: its temporaries stay under the step's own peak


def _norm(tensors) -> float:
    """The float64 norm of the concatenation of the pairs' differences
    ``a - b`` (``b`` None reads as zero; ``b`` may sit on the host), read a
    chunk at a time."""
    total = None
    for a, b in tensors:
        a = a.detach().reshape(-1)
        b = None if b is None else b.reshape(-1)
        for i in range(0, a.numel(), _CHUNK):
            d = a[i:i + _CHUNK].double()
            if b is not None:
                d -= b[i:i + _CHUNK].to(a.device, non_blocking=True).double()
            part = torch.linalg.vector_norm(d).square()  # a reduction: torch.dot would bring cuBLAS's workspace
            total = part if total is None else total + part
    return math.sqrt(float(total))


class _Capture:
    """The first ``k`` steps of a fit as the port takes them. ``start``
    holds the weights the fit starts from, on the host; it is let go
    after step ``k``. The forward pre-hook takes itself off once it holds
    ``k`` inputs; the optimizer's hook stays to the end of the fit and,
    after step ``k``, only counts."""

    def __init__(self, model: torch.nn.Module, start: Dict[str, torch.Tensor], k: int):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.start = {n: start[n] for n in self.names.values()}
        self.k = k
        self.xs: List[torch.Tensor] = []
        self.steps = 0
        self.grad_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}
        self.pre = model.register_forward_pre_hook(self._pre)
        self.post = register_optimizer_step_post_hook(self._post)

    def _pre(self, module, args):
        self.xs.append(args[0].detach().clone())
        if len(self.xs) == self.k:
            self.pre.remove()  # the module's hooks are read from a copy: safe inside the call

    def _post(self, opt, args, kwargs):
        self.steps += 1
        if self.steps > self.k:
            return
        params = [p for group in opt.param_groups for p in group["params"]]
        if self.steps == 1:
            b1 = opt.param_groups[0]["betas"][0]
            self.grad_norms = {self.names[id(p)]: _norm([(opt.state[p]["exp_avg"], None)]) / (1.0 - b1)
                               for p in params}
        if self.steps == self.k:
            self.change_norms = {self.names[id(p)]: _norm([(p, self.start[self.names[id(p)]])]) for p in params}
            self.start = {}

    def close(self) -> None:
        self.pre.remove()
        self.post.remove()


class _TraceEpoch:
    """Starts ``tracer`` after optimizer step ``first`` and stops it after
    step ``last``; counts the steps after that (the optimizer's hooks may
    not be taken off inside one)."""

    def __init__(self, tracer: Tracer, first: int, last: int):
        self.tracer, self.first, self.last, self.steps = tracer, first, last, 0
        self.handle = register_optimizer_step_post_hook(self._post)

    def _post(self, opt, args, kwargs):
        self.steps += 1
        if self.steps == self.first:
            self.tracer.start()
        elif self.steps == self.last:
            self.tracer.stop()

    def close(self) -> None:
        self.handle.remove()


def _train_config(config: Dict, seed: int, epochs: int):
    from mri_interpolation_tpu_torch.train import TrainConfig

    tr = config["train"]
    return TrainConfig(batch_size=int(tr["batch_size"]), epochs=epochs, lr=float(tr["lr"]),
                       optimizer=tr["optimizer"], lr_schedule=tr.get("lr_schedule"),
                       cosine_t_max=int(tr.get("cosine_t_max", 10)), seed=seed)


def step_work(config: Dict, touched_rows: float) -> Dict:
    """Least seconds of one step, whole and by the kernels' parts."""
    grid = reference.make_grid(config["encoder"])
    n, d, L, F = int(config["train"]["batch_size"]), grid.dim, grid.n_levels, grid.n_features
    dims, acts = data.decoder_dims(config), data.decoder_acts(config)
    n_params = grid.rows * F + roofline.mlp_params(dims)
    t = int(round(touched_rows))
    return {
        "hash": {"least_s": roofline.least_s(roofline.hash_forward(n, d, L, F, t))
                 + roofline.least_s(roofline.hash_table_grad(n, d, L, F, t)),
                 "works": ["hash_forward", "hash_table_grad"]},
        "mlp": {"least_s": roofline.least_s(roofline.mlp_train(n, dims, acts)),
                "works": ["mlp_forward", "mlp_backward"]},
        "optimizer": {"works": ["optimizer"]},
        "whole_least_s": roofline.least_s(roofline.fit_step(n, d, L, F, t, grid.rows, dims, acts, n_params)),
    }


def reference_reading(config: Dict, wl: Dict, seed: int, dev: torch.device, volume: torch.Tensor,
                      xs: List[torch.Tensor], precision: str = "fp32") -> reference.FitReading:
    """The reference's steps from the seed's weights over the batches ``xs``
    (their targets looked up in ``volume``)."""
    spe = volume.numel() // int(config["train"]["batch_size"])
    with strict_fp32():
        params = data.draw_weights(config, seed, dev, wl["weights"])
        batches = [(x, data.targets(volume, x)) for x in xs]
        return reference.fit_steps(config, params, batches, spe, precision, frozen=data.buffer_names(config))


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
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
    marks.append(("data", time.perf_counter()))
    weights = data.draw_weights(config, seed, dev, wl["weights"])
    model = model_builder(config)(config, dev)
    model.load_state_dict(weights)
    marks.append(("model", time.perf_counter()))

    Trainer(_train_config(config, seed, int(wl["warmup_epochs"]))).fit(model, coords_np, values_np, device=dev)
    model.load_state_dict(weights)
    capture = _Capture(model, {name: w.cpu() for name, w in weights.items()}, k)
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
    notes = [f"fit: {epochs} epochs of {spe} steps at batch {batch} in {wall:.4f} s; "
             f"{steps * batch / wall:.1f} voxels/s; peak {memory} B", set_up_note(t_start, marks), host.note()]
    out = Outcome(metrics={"fit_voxels_per_s": steps * batch / wall, "setup_s": setup_s},
                  checks={}, attempted=steps, failed=failed, memory_peak_bytes=memory, notes=notes)
    if tracer is not None:
        if hook.steps < 2 * spe:
            raise RuntimeError("the traced epoch did not close inside the window")
        out.trace, out.units = tracer.read(), spe
        grid = reference.make_grid(config["encoder"])
        touched = float(np.mean([reference.touched_rows(grid, x) for x in capture.xs]))
        out.work = step_work(config, touched)
        out.notes.append(f"trace: {spe} steps, {touched:.0f} table rows touched a step (mean of {k})")
    losses = [float(v) for v in result.losses[:k]]
    del model, result, trainer
    free(dev)

    ref = reference_reading(config, wl, seed, dev, volume, capture.xs)
    prog = reference.FitReading(losses, capture.grad_norms, capture.change_norms)
    complete = len(capture.xs) == len(prog.losses) == k and prog.grad_norms and prog.change_norms
    gaps = reference.fit_gaps(prog, ref) if complete else {name: math.inf for name in wl["limits"]}
    gaps["rows_short"] = data.rows_short(config["volume"], capture.xs, k, batch)
    out.checks = {name: (gaps[name], float(limit)) for name, limit in wl["limits"].items()}
    out.notes.append("fit check: program losses " + ", ".join(f"{v:.9g}" for v in prog.losses)
                     + "; reference " + ", ".join(f"{v:.9g}" for v in ref.losses))
    return out
