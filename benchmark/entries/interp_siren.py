"""Entry ``"interp_siren"``: ``evaluate_grid`` of a SIREN on one grid shape, a
closed loop of one client.

It is the entry ``"interp"`` (``interp.py``: set-up, ``warmup_requests``
requests, a window of a fixed number of requests back to back, each as soon
as the last one's volume is in host memory, a reservoir sample of the
answers and the last one judged whole after the window, ``trace_requests``
requests traced from the window's third) for a SIREN config (the PSF
SIREN's: its forward is the SIREN, cuBLAS's products and the sine-layer
forward):

- the weights are SIREN's initialisation from the seed
  (``reference_psf.init_params``), what a fit starts from;
- the grid is zero-centred: ``lo`` of the workload to 1, the launcher's
  ``linspace(-1, 1)`` for a zero-centred model;
- the reference is ``reference_psf.siren`` on the same grid coordinates, a
  block of rows at a time, and the least times are ``roofline_psf``'s
  (the products at the 3xTF32 rate).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import reference, reference_psf, roofline, roofline_psf
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer
from .fit_psf import PRODUCT_WORKS
from .fit_wire import gabor_rows
from .interp import _TRACE_FROM


def request_work(config: Dict, n: int) -> Dict:
    """Least seconds of one request of ``n`` voxels, whole and of the
    products: each layer's forward product; each hidden element's bias add,
    w0 scaling and sine (``roofline_psf.SINE_FLOPS``) and the output's bias
    add; the weights read once and the volume written once."""
    dims = reference_psf.layer_dims(config)
    products = 2.0 * n * roofline.mlp_macs(dims)
    other = float(n * (roofline_psf.SINE_FLOPS * sum(dims[1:-1]) + dims[-1]))
    nbytes = 4.0 * (n * dims[-1] + roofline.mlp_params(dims))
    return {"mlp": {"least_s": roofline_psf.least_s((0.0, products, 0.0)), "works": PRODUCT_WORKS},
            "whole_least_s": roofline_psf.least_s((nbytes, products, other))}


def grid_coords(shape, lo: float, start: int, stop: int, dev) -> torch.Tensor:
    """Rows start..stop-1 of the grid of ``shape`` on [lo, 1]."""
    return lo + (1.0 - lo) * reference.grid_coords(shape, start, stop, dev)


@torch.no_grad()
def reference_volume(config: Dict, params: Dict[str, torch.Tensor], shape, lo: float, precision: str = "fp32",
                     block: int = 1 << 17) -> torch.Tensor:
    """The SIREN on every point of the grid, (prod(shape),), ``block``
    points at a time."""
    n = int(np.prod(shape))
    dev = next(iter(params.values())).device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = reference_psf.siren(config, params, grid_coords(shape, lo, start, stop, dev),
                                              precision)[:, 0]
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
    from mri_interpolation_tpu_torch.infer import evaluate_grid

    config, wl = cell.config, cell.workload
    shape = tuple(int(s) for s in wl["grid"])
    chunk, transport, lo = int(wl["chunk_size"]), wl["transport"], float(wl["lo"])
    marks = [("start", time.perf_counter())]
    model = model_builder(config)(config, dev)
    model.load_state_dict(reference_psf.init_params(config, seed, dev))
    marks.append(("model", time.perf_counter()))

    def request() -> np.ndarray:
        return evaluate_grid(model, shape, lo=lo, chunk_size=chunk, device=dev, transport=transport)

    for _ in range(int(wl["warmup_requests"])):
        request()
    tracer, traced = None, int(wl["trace_requests"])
    if trace:
        tracer = Tracer()
        tracer.warm()
    rng = random.Random(seed)
    k = int(wl["sample"])
    sample: List[np.ndarray] = []
    latencies: List[float] = []
    rows_before = gabor_rows()
    sync(dev)
    reset_peak(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    n_requests = max(_TRACE_FROM + traced + 1, round(seconds * float(wl["requests_per_s"])))
    host = HostMeter()
    t0 = time.perf_counter()
    for i in range(n_requests):
        if tracer is not None and i == _TRACE_FROM:
            tracer.start()
        ts = time.perf_counter()
        vol = request()
        end = time.perf_counter()
        latencies.append(end - ts)
        if tracer is not None and i == _TRACE_FROM + traced - 1:
            tracer.stop()
        if i < k:
            sample.append(vol)
        else:
            j = rng.randrange(i + 1)
            if j < k:
                sample[j] = vol
    wall = end - t0

    memory = peak_bytes(dev)
    n = int(np.prod(shape))
    count = len(latencies)
    lat_ms = np.asarray(latencies) * 1e3
    rows_after = gabor_rows()
    out = Outcome(metrics={"interp_voxels_per_s": count * n / wall, "setup_s": setup_s},
                  checks={}, attempted=count, failed=0, memory_peak_bytes=memory,
                  notes=[f"interp_siren: {count} requests of {shape} in {wall:.4f} s; latency median "
                         f"{float(np.median(lat_ms)):.4f} ms, p95 {float(np.percentile(lat_ms, 95)):.4f} ms over "
                         f"{count} samples; peak {memory} B",
                         f"gabor rows over the window: {None if rows_after is None else rows_after - rows_before}",
                         set_up_note(t_start, marks), host.note()])
    if tracer is not None:
        out.trace, out.units = tracer.read(), traced
        out.work = request_work(config, n)
        out.notes.append(f"trace: {traced} requests")
    answers = sample + [vol]
    del model, vol
    free(dev)

    with strict_fp32():
        ref = reference_volume(config, reference_psf.init_params(config, seed, dev), shape, lo)
        gap = max(reference.volume_gap(torch.from_numpy(np.ascontiguousarray(a)).to(dev), ref) for a in answers)
    out.checks = {"volume_gap": (gap, float(wl["limits"]["volume_gap"]))}
    return out
