"""Entry ``"interp"``: ``evaluate_grid`` on one grid shape, a closed loop of
one client.

Set-up makes the weights from the seed on the device, builds the port's
model through its factory, loads them, and serves ``warmup_requests``
requests. The window sends a fixed number of requests, ``--seconds`` times
the cell's nominal ``requests_per_s``, each as soon as the last one's
volume is in host memory: the work does not follow the host's speed at the
run, and the window lasts about ``--seconds`` at that rate.
``interp_voxels_per_s`` is the voxels delivered over the window's wall. A request's latency is the call's wall,
from the call to the volume in host memory; their median and 95th
percentile (numpy's linear interpolation) and their count go to standard
error.

What is judged: a sample of the window's answers, ``sample`` requests by
reservoir sampling seeded from ``--seed`` and the last one, each compared
whole with the reference's volume, worked out once the window has closed
from the same seed's weights. With ``--trace 1`` the profiler covers
``trace_requests`` requests, from the start of the window's third.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import data, reference, roofline
from ..common import HostMeter, Outcome, free, peak_bytes, reset_peak, set_up_note, strict_fp32, sync
from ..spec import Cell, model_builder
from ..trace import Tracer

_TRACE_FROM = 2  # requests served in the window before the traced ones


def request_work(config: Dict, shape, chunk: int, dev: torch.device) -> Dict:
    """Least seconds of one request, whole and by the kernels' parts: the
    encoder's forward over each chunk the port evaluates (each chunk's own
    touched rows) and the fused decoder's forward over it; the whole
    request reads each table row it touches once."""
    grid = reference.make_grid(config["encoder"])
    d, L, F = grid.dim, grid.n_levels, grid.n_features
    dims, acts = data.decoder_dims(config), data.decoder_acts(config)
    n = int(np.prod(shape))
    seen = torch.zeros(grid.rows, dtype=torch.bool, device=dev)
    hash_s = mlp_s = 0.0
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        ids, _ = reference.corners(grid, reference.grid_coords(shape, start, stop, dev))
        seen[ids.reshape(-1)] = True
        hash_s += roofline.least_s(roofline.hash_forward(stop - start, d, L, F, int(torch.unique(ids).numel())))
        mlp_s += roofline.least_s(roofline.mlp_forward(stop - start, dims, acts))
        del ids
    rows = int(seen.sum())
    return {"hash": {"least_s": hash_s, "works": ["hash_forward"]},
            "mlp": {"least_s": mlp_s, "works": ["mlp_forward"]},
            "whole_least_s": roofline.least_s(roofline.grid_request(n, d, L, F, rows, dims, acts)),
            "rows_read": rows}


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float) -> Outcome:
    from mri_interpolation_tpu_torch.infer import evaluate_grid

    config, wl = cell.config, cell.workload
    shape = tuple(int(s) for s in wl["grid"])
    chunk, transport = int(wl["chunk_size"]), wl["transport"]
    marks = [("start", time.perf_counter())]
    model = model_builder(config)(config, dev)
    model.load_state_dict(data.draw_weights(config, seed, dev, wl["weights"]))
    marks.append(("model", time.perf_counter()))

    def request() -> np.ndarray:
        return evaluate_grid(model, shape, chunk_size=chunk, device=dev, transport=transport)

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
    out = Outcome(metrics={"interp_voxels_per_s": count * n / wall, "setup_s": setup_s},
                  checks={}, attempted=count, failed=0, memory_peak_bytes=memory,
                  notes=[f"interp: {count} requests of {shape} in {wall:.4f} s; latency median "
                         f"{float(np.median(lat_ms)):.4f} ms, p95 {float(np.percentile(lat_ms, 95)):.4f} ms over "
                         f"{count} samples; peak {memory} B", set_up_note(t_start, marks), host.note()])
    if tracer is not None:
        out.trace, out.units = tracer.read(), traced
        out.work = request_work(config, shape, chunk, dev)
        out.notes.append(f"trace: {traced} requests, {out.work['rows_read']} table rows read a request")
    answers = sample + [vol]
    del model, vol
    free(dev)

    with strict_fp32():
        params = data.draw_weights(config, seed, dev, wl["weights"])
        ref = reference.grid_volume(config, params, shape)
        gap = max(reference.volume_gap(torch.from_numpy(np.ascontiguousarray(a)).to(dev), ref) for a in answers)
    out.checks = {"volume_gap": (gap, float(wl["limits"]["volume_gap"]))}
    return out
