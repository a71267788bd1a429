#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mri_interpolation_tpu_torch``) on one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printed with its time as it ends:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``mri_interpolation_tpu_torch/ops/csrc`` with
   nvcc (one process per source, all at once), then the probe kernel held
   exactly to ``2 * x`` and timed against ``torch.mul`` as medians of 200
   launches each;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (and, for the hash kernels, a hashed geometry; for the
   fused MLP, the ``siren 352x5`` shape, a small gelu stack and the
   multi-frame models' three stacks at one frame; for the coarse-level pair,
   the kernel bench's geometry, the JAX tests' geometry and the multi-frame
   HashMLP's levels 0-3 at one 352 x 352 frame, with kernels 1 and 2 beside
   them on the same levels, on the whole multi-frame encoder and on it in
   raster order), with times, bounds (for kernels 5-6 also the 3xTF32
   tensor-core bound) and ``index_add_``'s time beside kernels 2 and 4;
4. small fit: ``Trainer.fit`` on the card against the same fit on the CPU, for
   the flagship HashMLP, a small SIREN and a small ``relu_plain`` HashMLP
   with ``adam_tcnn``; ``Trainer.fit_frames`` likewise for a small
   MultiHashMLP and MultiSiren;
5. main paths, each with the launch counters set to 0 just before it and
   read just after:
   - flagship: ``launcher.run`` with the defaults on a synthetic
     (352, 352, 15) volume (1 epoch = 185 steps at batch 10,000, then the
     (352, 352, 30) interpolation grid);
   - path A: ``launcher.main`` with ``--config_preset siren`` (SIREN
     3 -> 128 x 6 -> 1, batch 4096: 453 steps, then the grids);
   - path B: ``launcher.main`` with the tcnn flags (16 levels x 2 features,
     2^19 rows, per_level_scale 1.4, relu_plain 32 -> 128 -> 1,
     ``adam_tcnn``: 185 steps, then the grids);
   - kernel bench: ``bench_kernels.run`` (sections 0-2: the probe, the fused
     SIREN and its gradients, the coarse hash encode and its table
     gradient), each record held to its tolerance;
   - multi_hash_mlp and multi_siren: ``Trainer.fit_frames`` for 2 epochs
     (30 steps) on a synthetic (352, 352, 15) 2-D+t volume split into 15
     frames of 123,904 voxels, then ``evaluate_grid((352, 352),
     frame_idx=t)`` for every frame, PSNR and SSIM;
6. profile: device time by kernel over 20 training steps of each path (one
   epoch of 15 frames for the multi-frame models) and one flagship grid
   evaluation (torch.profiler).

The last two lines are the kernels' JSON line and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
them. With no CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores, H100 SXM data sheet

FWD_ATOL = 2e-6  # fp32 sum of 8 products of magnitude <= 1, taken in another order
GRAD_ATOL = 1e-5  # fp32 atomics in run-dependent order, a few terms of |g*w| <= 4 per row
FIT_RTOL = 1e-4  # 10 Adam steps, card GEMMs and atomics vs CPU summation order (as the CPU parity)
# fused MLP, kernel vs plain version, as a share of the largest reference value:
# fp32 sums of up to 352 products in another order (and slices added by
# atomics for dW, db); a sine layer at w0 = 30 multiplies an ulp-level
# difference of its argument by 30 at every layer
MLP_SHARE = 1e-5
MLP_SINE_SHARE = 1e-4

CSRC = "mri_interpolation_tpu_torch/ops/csrc/"
SOURCES = {
    "hash_encode_forward": CSRC + "hash_encode.cu",
    "hash_encode_table_grad": CSRC + "hash_encode.cu",
    "hash_encode_coarse_forward": CSRC + "hash_encode.cu",
    "hash_encode_coarse_table_grad": CSRC + "hash_encode.cu",
    "fused_mlp_forward": CSRC + "fused_mlp.cu",
    "fused_mlp_backward": CSRC + "fused_mlp.cu",
    "probe": CSRC + "probe.cu",
}
REPLACES = {
    "hash_encode_forward": "mri_interpolation_tpu/ops/pallas/hash_encode.py:175",
    "hash_encode_table_grad": "mri_interpolation_tpu/ops/pallas/hash_encode.py:198",
    "hash_encode_coarse_forward": "mri_interpolation_tpu/ops/pallas/hash_encode.py:350",
    "hash_encode_coarse_table_grad": "mri_interpolation_tpu/ops/pallas/hash_encode.py:372",
    "fused_mlp_forward": "mri_interpolation_tpu/ops/pallas/fused_mlp.py:185",
    "fused_mlp_backward": "mri_interpolation_tpu/ops/pallas/fused_mlp.py:205",
    "probe": "scripts/bench_pallas_exec.py:76",
}
VOLUME = (352, 352, 15)
GRID = (352, 352, 30)
CHUNKS = -(-352 * 352 * 15 // (1 << 17)) + -(-352 * 352 * 30 // (1 << 17))  # 15 + 29
FRAME = (352, 352)  # one frame of the multi-frame paths: 123,904 voxels
# the multi-frame HashMLP of scripts/experiments.py:238-243 (RESULTS.md:25)
MULTI_HASH = dict(dim_in=2, n_frames=15, n_levels=10, n_features_per_level=2, log2_hashmap_size=17,
                  base_resolution=16, per_level_scale=1.4, dim_hidden=64, n_layers=2)
MULTI_SIREN = dict(dim_in=2, dim_hidden=128, n_layers=4, n_frames=15)  # experiments.py:233-237
TCNN_FLAGS = ["--n_levels", "16", "--n_features_per_level", "2", "--log2_hashmap_size", "19",
              "--base_resolution", "16", "--per_level_scale", "1.4", "--dim_hidden", "128", "--n_layers", "2",
              "--decoder", "relu_plain", "--lr", "1e-2", "--optimizer", "adam_tcnn"]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, by CUDA
    events: host launch cost included where it exceeds the device's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under torch.profiler; return
    ({kernel name: (device ms total, launches)}, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue  # record_function ranges (e.g. Optimizer.step#Adam.step) span kernels, not one
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (dev_us / 1e3, evt.count)
    return kernels, wall_ms


def kernel_ms(fn, name: str, iters: int = 20):
    """Device milliseconds per launch of the kernels whose name holds
    ``name``, from the profiler; None if it recorded no device time."""
    kernels, _ = profile_device(fn, iters)
    hits = [(ms, n) for key, (ms, n) in kernels.items() if name in key]
    if not hits:
        return None
    return sum(ms for ms, _ in hits) / sum(n for _, n in hits)


def flops_per_point_level(d: int, f: int, grad: bool) -> int:
    """fp32 operations per (point, level): scale and fraction (2d), the 2^d
    corner weights (d-1 products and d complements), then F weighted sums
    (forward: C products and C-1 adds) or F*C products and atomic adds."""
    c = 1 << d
    per_corner = c * (d - 1) + d
    return 2 * d + per_corner + (2 * c * f if grad else f * (2 * c - 1))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(call, name: str, per_call: bool = False) -> dict:
    """The kernel's device time per launch (profiler; the back-to-back
    per-call time by events where the profiler records none) and the
    per-call time of its wrapper. ``per_call``: the device time of all the
    kernels whose name holds ``name`` per call of ``call`` (a wrapper that
    launches several)."""
    call_ms = time_ms(call)
    if per_call:
        kernels, _ = profile_device(call, 20)
        hits = [ms for key, (ms, _) in kernels.items() if name in key]
        ms = sum(hits) / 20 if hits else None
    else:
        ms = kernel_ms(call, name)
    return {"ms": call_ms if ms is None else ms, "ms_source": "events" if ms is None else "profiler",
            "call_ms": call_ms}


def launch_stats(fn, name: str, launches: int = 200) -> dict:
    """Device microseconds of each of ``launches`` launches of the kernel
    whose name holds ``name`` (each profiler event is one launch; by CUDA
    events around each call where the profiler records none): the median,
    quartiles and extremes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = [evt.time_range.elapsed_us() for evt in prof.events()
          if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA and name in evt.name]
    source = "profiler"
    if len(us) < launches:
        source, us = "events", []
        for _ in range(launches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            us.append(start.elapsed_time(end) * 1e3)
    q = np.percentile(np.asarray(us, dtype=np.float64), [0, 25, 50, 75, 100])
    return {"launches": len(us), "median_us": q[2], "p25_us": q[1], "p75_us": q[3], "min_us": q[0],
            "max_us": q[4], "source": source}


def check_kernels(torch, he, enc_flagship, enc_hashed, dev):
    """Each kernel against its plain version; returns per-kernel rows."""
    from mri_interpolation_tpu_torch.infer import flat_index_to_coords

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {"hash_encode_forward": [], "hash_encode_table_grad": []}

    def points(n, d):
        x = torch.rand((n, d), generator=gen)
        x[0], x[1] = 0.0, 1.0  # the boundary: dense levels clamp, hashed do not
        return x.to(dev)

    def table_for(enc):
        t = torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1
        return t.to(dev)

    cases = [
        ("flagship", enc_flagship, points(10_000, 3), "train batch"),
        ("flagship", enc_flagship, points(1 << 17, 3), "grid chunk"),
        ("flagship", enc_flagship,
         flat_index_to_coords(torch.arange(352 * 352 * 30, device=dev), (352, 352, 30)), "whole 352x352x30 grid"),
        ("hashed16", enc_hashed, points(10_000, 3), "train batch"),
    ]
    for geom, enc, x, what in cases:
        n, d, L, F = x.shape[0], enc.input_dim, enc.n_levels, enc.n_features_per_level
        table = table_for(enc)
        ids, _ = enc.corner_ids_and_weights(x)
        touched = int(torch.unique(ids).numel())

        out = he.hash_encode_forward(enc, table, x)
        ref = he.hash_encode_reference(enc, table, x)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not math.isfinite(err) or err > FWD_ATOL:
            fail(f"hash_encode_forward {geom} N={n}: max abs err {err} > {FWD_ATOL}")
        fb, fk = bound_ms(4.0 * (n * d + touched * F + n * L * F),
                          n * L * flops_per_point_level(d, F, grad=False))
        call = lambda: he.hash_encode_forward(enc, table, x)  # noqa: E731
        row = {"geometry": geom, "n": n, "what": what, "max_abs_err": err,
               **kernel_times(call, "hash_encode_forward_kernel"),
               "plain_ms": time_ms(lambda: he.hash_encode_reference(enc, table, x), iters=5),
               "bound_ms": fb, "bound_by": fk, "library_ms": None}
        rows["hash_encode_forward"].append(row)
        log(f"  forward    {geom:8s} N={n:>9,d} ({what}): err {err:.3e}  kernel {row['ms']} ms"
            f"  per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound {fb:.5f} ms ({fk})")

        if what != "train batch":
            continue  # the gradient runs on training batches only
        g = torch.randn((n, L * F), generator=gen).to(dev)
        dt = he.hash_encode_table_grad(enc, x, g)
        dref = he.hash_encode_table_grad_reference(enc, x, g)
        torch.cuda.synchronize()
        err = float((dt - dref).abs().max())
        if not math.isfinite(err) or err > GRAD_ATOL:
            fail(f"hash_encode_table_grad {geom} N={n}: max abs err {err} > {GRAD_ATOL}")
        # index_add_ of the precomputed rows: the scatter alone, as one library call
        ids2, w2 = enc.corner_ids_and_weights(x)
        contrib = (g.reshape(n, L, 1, F) * w2.unsqueeze(-1)).reshape(-1, F)
        flat_ids = ids2.reshape(-1)
        zeros = torch.zeros((enc.total_size, F), device=dev)
        gb, gk = bound_ms(4.0 * (n * d + n * L * F + enc.total_size * F),
                          n * L * flops_per_point_level(d, F, grad=True))
        call = lambda: he.hash_encode_table_grad(enc, x, g)  # noqa: E731
        row = {"geometry": geom, "n": n, "what": what, "max_abs_err": err,
               # every kernel of the call: the private and the global levels' (table_grad_plan)
               **kernel_times(call, "hash_encode_table_grad", per_call=True),
               "plan": he.table_grad_plan(enc, n)._asdict(),
               "plain_ms": time_ms(lambda: he.hash_encode_table_grad_reference(enc, x, g), iters=5),
               "bound_ms": gb, "bound_by": gk,
               # every kernel that the one index_add_ call launches
               "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
        rows["hash_encode_table_grad"].append(row)
        log(f"  table_grad {geom:8s} N={n:>9,d} ({what}): err {err:.3e}  kernel {row['ms']} ms"
            f"  per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
            f"  index_add_ {row['library_ms']} ms  bound {gb:.5f} ms ({gk})")
    return rows


def encoder_rows(torch, he, enc, table, x, g, what: str) -> dict:
    """Kernels 1 and 2 on the multi-frame encoder ``enc`` at one frame,
    against their plain versions (forward: 2e-6 of the largest value; table
    gradient: the per-entry atomic bound), with times, bounds, the plain
    versions' and, for kernel 2, ``index_add_``'s."""
    n, d, L, F = x.shape[0], enc.input_dim, enc.n_levels, enc.n_features_per_level
    out = he.hash_encode_forward(enc, table, x)
    ref = he.hash_encode_reference(enc, table, x)
    dt = he.hash_encode_table_grad(enc, x, g)
    dref = he.hash_encode_table_grad_reference(enc, x, g)
    abs_sum = he.table_grad_abs_sum(enc, x, g)
    torch.cuda.synchronize()
    ferr, tol = float((out - ref).abs().max()), FWD_ATOL * max(1.0, float(ref.abs().max()))
    if not math.isfinite(ferr) or ferr > tol:
        fail(f"hash_encode_forward multi_frame {what}: max abs err {ferr} > {tol}")
    gerr = float((dt - dref).abs().max())
    excess = float(((dt - dref).abs() - he.atomic_sum_bound(abs_sum)).max())
    if not math.isfinite(gerr) or excess > 0.0:
        fail(f"hash_encode_table_grad multi_frame {what}: max abs err {gerr}, {excess} over the per-row bound")
    ids, w = enc.corner_ids_and_weights(x)
    touched = int(torch.unique(ids).numel())
    contrib = (g.reshape(n, L, 1, F) * w.unsqueeze(-1)).reshape(-1, F)
    flat_ids, zeros = ids.reshape(-1), torch.zeros((enc.total_size, F), device=x.device)
    fb, fk = bound_ms(4.0 * (n * d + touched * F + n * L * F), n * L * flops_per_point_level(d, F, grad=False))
    gb, gk = bound_ms(4.0 * (n * d + n * L * F + enc.total_size * F), n * L * flops_per_point_level(d, F, grad=True))
    frow = {"geometry": "multi_frame", "n": n, "what": what, "max_abs_err": ferr, "tolerance": tol,
            **kernel_times(lambda: he.hash_encode_forward(enc, table, x), "hash_encode_forward_kernel"),
            "plain_ms": time_ms(lambda: he.hash_encode_reference(enc, table, x), iters=5),
            "bound_ms": fb, "bound_by": fk, "library_ms": None}
    grow = {"geometry": "multi_frame", "n": n, "what": what, "max_abs_err": gerr,
            "largest_bound": float(he.atomic_sum_bound(abs_sum).max()),
            **kernel_times(lambda: he.hash_encode_table_grad(enc, x, g), "hash_encode_table_grad", per_call=True),
            "plan": he.table_grad_plan(enc, n)._asdict(),
            "plain_ms": time_ms(lambda: he.hash_encode_table_grad_reference(enc, x, g), iters=5),
            "bound_ms": gb, "bound_by": gk,
            "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
    for label, row in (("forward   ", frow), ("table_grad", grow)):
        log(f"  {label} multi_frame N={n:>7,d} ({what}): err {row['max_abs_err']:.3e}  kernel {row['ms']} ms"
            f"  per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
            f"  library {row['library_ms']} ms  bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return {"hash_encode_forward": frow, "hash_encode_table_grad": grow}


def check_coarse_kernels(torch, he, dev):
    """Kernels 3 and 4 against their plain versions on three geometries: the
    multi-frame HashMLP's levels 0-3 at one 352 x 352 frame (the main row),
    the kernel bench's and the JAX tests'; ragged N and x in [-1, 1]. Beside
    the main row, kernels 1 and 2 on the same four levels (the same function:
    held to kernel 3's output) and on the whole 10-level encoder. Returns
    per-kernel rows."""
    from mri_interpolation_tpu_torch.bench_kernels import bench_geometry
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(4)
    geom_multi = dict(dim=2, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                      finest_resolution=None, per_level_scale=1.4)
    multi = HashGridEncoding(n_levels=10, **geom_multi)
    multi4 = HashGridEncoding(n_levels=4, **geom_multi)  # levels 0-3 of `multi`, alone
    paper = HashGridEncoding(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=11,
                             base_resolution=(3, 3, 2), finest_resolution=(11, 11, 6), growth="paper")
    cases = [  # (geometry, encoder, N, x's lower end, what)
        ("multi_frame", multi, FRAME[0] * FRAME[1], 0.0, "one 352x352 frame"),
        ("multi_frame", multi, 517, -1.0, "ragged, x in [-1, 1]"),
        ("bench", bench_geometry(), 65536, 0.0, "bench batch"),
        ("paper", paper, 517, 0.0, "ragged"),
        ("paper", paper, 4099, -1.0, "x in [-1, 1]"),
    ]
    rows = {"hash_encode_coarse_forward": [], "hash_encode_coarse_table_grad": []}
    for geom, enc, n, lo, what in cases:
        levels = he.coarse_onehot_levels(enc)
        d, F, L = enc.input_dim, enc.n_features_per_level, len(levels)
        coarse_rows = sum(int(enc.level_sizes[l]) for l in levels)
        x = torch.rand((n, d), generator=gen) * (1.0 - lo) + lo
        x[0], x[1] = lo, 1.0
        x = x.to(dev)
        table = (torch.rand((enc.total_size, F), generator=gen) * 2 - 1).to(dev)
        g = torch.randn((n, L * F), generator=gen).to(dev)

        out = he.hash_encode_coarse_forward(enc, table, x)
        ref = he.hash_encode_coarse_reference(enc, table, x)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = FWD_ATOL * max(1.0, float(ref.abs().max()))
        if not math.isfinite(err) or err > tol:
            fail(f"hash_encode_coarse_forward {geom} N={n} ({what}): max abs err {err} > {tol}")
        fb, fk = bound_ms(4.0 * (n * d + coarse_rows * F + n * L * F), n * L * flops_per_point_level(d, F, grad=False))
        call = lambda: he.hash_encode_coarse_forward(enc, table, x)  # noqa: E731
        frow = {"geometry": geom, "n": n, "what": what, "levels": levels, "coarse_rows": coarse_rows,
                "max_abs_err": err, "tolerance": tol, **kernel_times(call, "hash_encode_coarse_forward_kernel"),
                "plain_ms": time_ms(lambda: he.hash_encode_coarse_reference(enc, table, x), iters=5),
                "bound_ms": fb, "bound_by": fk, "library_ms": None}
        rows["hash_encode_coarse_forward"].append(frow)
        log(f"  coarse forward    {geom:11s} N={n:>7,d} ({what}): levels {levels} ({coarse_rows:,d} rows), "
            f"err {err:.3e}  kernel {frow['ms']} ms  per call {frow['call_ms']:.4f} ms  plain {frow['plain_ms']:.4f} ms"
            f"  bound {fb:.5f} ms ({fk})")

        dt = he.hash_encode_coarse_table_grad(enc, x, g)
        dref = he.hash_encode_coarse_table_grad_reference(enc, x, g)
        abs_sum = he.table_grad_abs_sum(enc, x, g, levels)
        torch.cuda.synchronize()
        err = float((dt - dref).abs().max())
        excess = float(((dt - dref).abs() - he.atomic_sum_bound(abs_sum)).max())
        if not math.isfinite(err) or excess > 0.0:
            fail(f"hash_encode_coarse_table_grad {geom} N={n} ({what}): max abs err {err}, "
                 f"{excess} over the per-row bound")
        ids, w = enc.corner_ids_and_weights(x, levels)
        contrib = (g.reshape(n, L, 1, F) * w.unsqueeze(-1)).reshape(-1, F)
        flat_ids = ids.reshape(-1)
        zeros = torch.zeros((enc.total_size, F), device=dev)
        gb, gk = bound_ms(4.0 * (n * d + n * L * F + coarse_rows * F), n * L * flops_per_point_level(d, F, grad=True))
        call = lambda: he.hash_encode_coarse_table_grad(enc, x, g)  # noqa: E731
        grow = {"geometry": geom, "n": n, "what": what, "levels": levels, "max_abs_err": err,
                "largest_bound": float(he.atomic_sum_bound(abs_sum).max()),
                **kernel_times(call, "hash_encode_coarse_table_grad_kernel"),
                "plain_ms": time_ms(lambda: he.hash_encode_coarse_table_grad_reference(enc, x, g), iters=5),
                "bound_ms": gb, "bound_by": gk,
                "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
        rows["hash_encode_coarse_table_grad"].append(grow)
        log(f"  coarse table_grad {geom:11s} N={n:>7,d} ({what}): err {err:.3e} (bound >= 1e-5)  kernel {grow['ms']} ms"
            f"  per call {grow['call_ms']:.4f} ms  plain {grow['plain_ms']:.4f} ms  index_add_ {grow['library_ms']} ms"
            f"  bound {gb:.5f} ms ({gk})")

        if geom == "multi_frame" and n == FRAME[0] * FRAME[1]:
            # kernels 1-2 on the same levels (the same function) and on the whole encoder
            t4 = table[:multi4.total_size]
            same = he.hash_encode_forward(multi4, t4, x)
            same_grad = he.hash_encode_table_grad(multi4, x, g)
            torch.cuda.synchronize()
            e1 = float((same - out).abs().max())
            if e1 > FWD_ATOL:
                fail(f"kernel 1 on levels 0-3 differs from kernel 3 by {e1}")
            e2 = float(((same_grad - dt[:multi4.total_size]).abs()
                        - he.atomic_sum_bound(abs_sum[:multi4.total_size])).max())
            if e2 > 0.0:
                fail(f"kernel 2 on levels 0-3 differs from kernel 4 by {e2} over the per-row bound")
            g_all = torch.randn((n, multi.output_dim), generator=gen).to(dev)
            xs = torch.linspace(0, 1, FRAME[0])
            raster = torch.stack(torch.meshgrid(xs, xs, indexing="ij"), dim=-1).reshape(-1, 2).to(dev)
            for what_b, enc_b, t_b, x_b, g_b in (("levels 0-3", multi4, t4, x, g), ("all 10 levels", multi, table, x, g_all),
                                                 ("all 10 levels, raster order", multi, table, raster, g_all)):
                for name, row in encoder_rows(torch, he, enc_b, t_b, x_b, g_b, what_b).items():
                    rows.setdefault(name, []).append(row)
            frow["beside"] = {"kernel1_equals_kernel3": bool(torch.equal(same, out))}
            log(f"  beside, N={n:,d}: kernel 1 on levels 0-3 bitwise equal to kernel 3: "
                f"{frow['beside']['kernel1_equals_kernel3']}")
    return rows


def mlp_macs(dims, batch: int, backward: bool, need_dx: bool) -> int:
    """Multiply-adds of the fused MLP's products: the forward's, or the
    backward's (the recomputed forward, dW for every layer, dz_l W_l^T for
    every layer above the first and for the first when dx is asked for)."""
    macs = [k * n for k, n in zip(dims[:-1], dims[1:])]
    if not backward:
        return batch * sum(macs)
    return batch * (2 * sum(macs) + sum(macs[1:]) + (macs[0] if need_dx else 0))


def tensor_core_bound_ms(dims, batch: int, backward: bool, need_dx: bool) -> float:
    """The least time for fp32-accurate products on the tensor cores: three
    TF32 MMAs per product (3xTF32) at the H100 SXM's dense TF32 rate, or the
    bytes at its memory rate, whichever is larger."""
    nbytes, _ = mlp_work(dims, batch, backward, need_dx)
    return max(nbytes / H100_BYTES_PER_S, 3 * 2.0 * mlp_macs(dims, batch, backward, need_dx) / H100_TF32_FLOPS) * 1e3


def mlp_work(dims, batch: int, backward: bool, need_dx: bool):
    """(bytes, fp32 operations) the fused MLP must move and do: x (and g)
    read once, the weights and biases read once, the output (dW, db and dx)
    written once; two operations per multiply-add and, per output element,
    the bias add and the activation (forward) or act' and its product
    (backward). The backward recomputes the forward, forms dW for every layer
    and dz_l W_l^T for every layer above the first (and for the first when dx
    is asked for)."""
    macs = [k * n for k, n in zip(dims[:-1], dims[1:])]
    params = sum(k * n + n for k, n in zip(dims[:-1], dims[1:]))
    elems = sum(dims[1:])
    if not backward:
        return 4.0 * (batch * dims[0] + params + batch * dims[-1]), 2.0 * batch * (sum(macs) + elems)
    bmacs = 2 * sum(macs) + sum(macs[1:]) + (macs[0] if need_dx else 0)
    nbytes = 4.0 * (batch * dims[0] + batch * dims[-1] + 2 * params + (batch * dims[0] if need_dx else 0))
    return nbytes, 2.0 * batch * bmacs + 4.0 * batch * elems


def check_fused_mlp(torch, fm, dev):
    """Kernels 5 and 6 against their plain versions at the shapes of paths A
    and B, the siren 352x5 shape and a small gelu stack; returns per-kernel
    rows."""
    from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp, make_multi_siren, make_siren

    gen = torch.Generator(device="cpu").manual_seed(1)
    multi_siren = make_multi_siren(**{**MULTI_SIREN, "n_frames": 1}, device=dev)
    multi_hash = make_multi_hash_mlp(**{**MULTI_HASH, "n_frames": 1}, device=dev)
    siren_a = make_siren(3, dim_hidden=128, n_layers=6, device=dev).params
    siren_352 = make_siren(3, dim_hidden=352, n_layers=5, device=dev).params
    tcnn = make_hash_mlp(3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                         per_level_scale=1.4, dim_hidden=128, n_layers=2, decoder="relu_plain", device=dev)
    gelu_layers = [{"w": (torch.rand((k, n), generator=gen) - 0.5).to(dev) / 4,
                    "b": (torch.rand((n,), generator=gen) - 0.5).to(dev) / 4} for k, n in ((16, 64), (64, 64), (64, 2))]

    def siren_stack(params, n_layers):
        layers = params["layers"] + [params["last"]]
        return layers, fm.siren_acts(n_layers, 30.0, 30.0)

    def data(n, k, lo):
        return (torch.rand((n, k), generator=gen) * (1.0 - lo) + lo).to(dev)

    cases = [  # (what, layers, acts, batch, x's lower end, backward, need_dx)
        ("A train step", *siren_stack(siren_a, 6), 4096, -1.0, True, False),
        ("A grid chunk", *siren_stack(siren_a, 6), 1 << 17, -1.0, False, False),
        ("B train step", [l.params for l in tcnn.layers], fm.mlp_acts(1, "relu"), 10_000, -0.5, True, True),
        ("siren 352x5", *siren_stack(siren_352, 5), 20_000, -1.0, True, False),
        ("gelu small", gelu_layers, fm.mlp_acts(2, "gelu"), 1000, -1.0, True, True),
        # the multi-frame paths' stacks at one 352 x 352 frame
        ("multi_siren enc", *siren_stack(multi_siren.encoders.params(0), 4), FRAME[0] * FRAME[1], -1.0, True, False),
        ("multi_siren dec", *siren_stack(multi_siren.decoder.params(), 4), FRAME[0] * FRAME[1], -1.0, True, True),
        ("multi_hash dec", [l.params for l in multi_hash.decoder], fm.mlp_acts(1, "relu"), FRAME[0] * FRAME[1], -1.0,
         True, True),
    ]
    rows = {"fused_mlp_forward": [], "fused_mlp_backward": []}
    with torch.no_grad():
        for what, layers, acts, n, lo, backward, need_dx in cases:
            ws, bs = [l["w"].detach() for l in layers], [l["b"].detach() for l in layers]
            dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
            share = MLP_SINE_SHARE if acts[0][0] == "sine" else MLP_SHARE
            x = data(n, dims[0], lo)
            y = fm.mlp_forward(ws, bs, x, acts)
            ref = fm.mlp_forward_reference(ws, bs, x, acts)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            if not math.isfinite(err) or err > share * float(ref.abs().max()):
                fail(f"fused_mlp_forward {what}: max abs err {err} > {share} x {float(ref.abs().max())}")
            fb, fk = bound_ms(*mlp_work(dims, n, False, False))
            call = lambda: fm.mlp_forward(ws, bs, x, acts)  # noqa: E731
            row = {"what": what, "dims": dims, "n": n, "max_abs_err": err, "tolerance_share": share,
                   **kernel_times(call, "fused_mlp_forward_kernel"),
                   "plain_ms": time_ms(lambda: fm.mlp_forward_reference(ws, bs, x, acts), iters=5),
                   "bound_ms": fb, "bound_by": fk, "bound_tc_ms": tensor_core_bound_ms(dims, n, False, False),
                   "library_ms": None}
            rows["fused_mlp_forward"].append(row)
            log(f"  mlp forward  {what:15s} dims {dims[0]}-{dims[1]}x{len(dims) - 2}-{dims[-1]} N={n:>7,d}: "
                f"err {err:.3e}  kernel {row['ms']} ms  per call {row['call_ms']:.4f} ms  "
                f"plain {row['plain_ms']:.4f} ms  bound {fb:.5f} ms ({fk}), 3xTF32 {row['bound_tc_ms']:.5f} ms")
            if not backward:
                continue
            g = torch.randn((n, dims[-1]), generator=gen).to(dev)
            dws, dbs, dx = fm.mlp_backward(ws, bs, x, g, acts, need_dx)
            if what.startswith("multi_"):
                # 123,904 rows: relu's derivative from the forward kernel's own z, which the backward repeats bit for
                # bit (some of 7.9 M pre-activations lie within rounding of 0, where cuBLAS may give the other sign)
                rdws, rdbs, rdx = fm.mlp_backward_reference_masked(ws, bs, x, g, acts, need_dx,
                                                                   fm.relu_masks(ws, bs, x, acts))
            else:
                rdws, rdbs, rdx = fm.mlp_backward_reference(ws, bs, x, g, acts, need_dx)
            torch.cuda.synchronize()
            pairs = [(f"dW{l}", a, b) for l, (a, b) in enumerate(zip(dws, rdws))]
            pairs += [(f"db{l}", a, b) for l, (a, b) in enumerate(zip(dbs, rdbs))]
            if need_dx:
                if not dx.is_contiguous() or dx.shape != (n, dims[0]):
                    fail(f"fused_mlp_backward {what}: dx {tuple(dx.shape)}, contiguous {dx.is_contiguous()}")
                pairs.append(("dx", dx, rdx))
            err = 0.0
            for key, a, b in pairs:
                e = float((a - b).abs().max())
                if not math.isfinite(e) or e > share * float(b.abs().max()):
                    fail(f"fused_mlp_backward {what} {key}: max abs err {e} > {share} x {float(b.abs().max())}")
                err = max(err, e)
            gb, gk = bound_ms(*mlp_work(dims, n, True, need_dx))
            call = lambda: fm.mlp_backward(ws, bs, x, g, acts, need_dx)  # noqa: E731
            row = {"what": what, "dims": dims, "n": n, "need_dx": need_dx, "max_abs_err": err,
                   "tolerance_share": share,
                   # the tile kernel and the weight-gradient kernel of one call
                   **kernel_times(call, "fused_mlp_", per_call=True),
                   "plain_ms": time_ms(lambda: fm.mlp_backward_reference(ws, bs, x, g, acts, need_dx), iters=5),
                   "bound_ms": gb, "bound_by": gk, "bound_tc_ms": tensor_core_bound_ms(dims, n, True, need_dx),
                   "library_ms": None}
            rows["fused_mlp_backward"].append(row)
            log(f"  mlp backward {what:15s} N={n:>7,d} dx={need_dx!s:5s}: err {err:.3e}  kernel {row['ms']} ms  "
                f"per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound {gb:.5f} ms ({gk}), "
                f"3xTF32 {row['bound_tc_ms']:.5f} ms")
    return rows


def check_probe(torch, pr, dev):
    """Kernel 7 held exactly to 2 * x on a (256, 128) array; its times."""
    x = torch.randn(pr.PROBE_SHAPE, generator=torch.Generator().manual_seed(2)).to(dev)
    y = pr.probe(x)
    if not torch.equal(y, 2 * x):
        fail(f"probe: max abs err {float((y - 2 * x).abs().max())}, expected exactly 2 * x")
    pr.check_build(dev)
    n = x.numel()
    pb, pk = bound_ms(4.0 * 2 * n, float(n))
    # each kernel alone, 200 launches: medians and spread (one profiler reading sits at an empty launch's length)
    probe_stats = launch_stats(lambda: pr.probe(x), "probe_double_kernel")
    mul_stats = launch_stats(lambda: torch.mul(x, 2.0), "")
    return {"what": "build check", "n": n, "max_abs_err": 0.0,
            **kernel_times(lambda: pr.probe(x), "probe_double_kernel"),
            "plain_ms": time_ms(lambda: pr.probe_reference(x)), "bound_ms": pb, "bound_by": pk,
            "library_ms": kernel_ms(lambda: torch.mul(x, 2.0), ""),
            "launch_stats": {"probe": probe_stats, "torch_mul": mul_stats,
                             "probe_slower_beyond_spread": bool(probe_stats["p25_us"] > mul_stats["p75_us"])}}


def small_fit_matches_cpu(torch, name: str, make_model, cfg, zero_centered: bool = False) -> float:
    """Ten steps of Trainer.fit on a (16, 16, 8) volume, card vs CPU, from
    one init; a hash table is redrawn U(-0.5, 0.5): at the factory's 1e-4
    table scale BatchNorm cancels nearly equal numbers and the curves of any
    two summation orders drift apart by ~3e-4 (tests/test_torch_trainer.py).
    Returns the largest relative difference of the loss curves."""
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.train import Trainer

    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=3), zero_centered=zero_centered)
    state = make_model("cpu").state_dict()
    if "encoder.table" in state:
        state["encoder.table"] = torch.empty(state["encoder.table"].shape).uniform_(
            -0.5, 0.5, generator=torch.Generator().manual_seed(6))
    losses = {}
    for dev in ("cuda", "cpu"):
        model = make_model(dev)
        model.load_state_dict(state)
        losses[dev] = Trainer(cfg).fit(model, ds.coords, ds.values, device=dev).losses
    if len(losses["cpu"]) != 10 or not np.all(np.isfinite(losses["cuda"])):
        fail(f"small fit {name}: {len(losses['cpu'])} steps, card losses {losses['cuda']}")
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    if rel > FIT_RTOL:
        fail(f"small fit {name}: card and CPU loss curves differ by {rel} > rtol {FIT_RTOL}")
    return rel


def small_fits(torch) -> dict:
    from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
    from mri_interpolation_tpu_torch.train import TrainConfig

    flagship = dict(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, seed=5)
    tcnn = dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4, per_level_scale=1.5,
                dim_hidden=64, n_layers=2, decoder="relu_plain", seed=5)
    return {
        "flagship": small_fit_matches_cpu(torch, "flagship", lambda d: make_hash_mlp(3, device=d, **flagship),
                                          TrainConfig(batch_size=200, epochs=1, shuffle=False)),
        "siren": small_fit_matches_cpu(torch, "siren",
                                       lambda d: make_siren(3, dim_hidden=64, n_layers=3, device=d, seed=5),
                                       TrainConfig(batch_size=200, epochs=1, lr=1e-4, shuffle=False),
                                       zero_centered=True),
        "relu_plain": small_fit_matches_cpu(torch, "relu_plain", lambda d: make_hash_mlp(3, device=d, **tcnn),
                                            TrainConfig(batch_size=200, epochs=1, lr=1e-2, shuffle=False,
                                                        optimizer="adam_tcnn")),
    }


def small_fit_frames_match_cpu(torch) -> dict:
    """Ten steps of Trainer.fit_frames (2 epochs x 5 frames of a (16, 16, 5)
    volume), card vs CPU, from one init, for a small MultiHashMLP (tables
    redrawn U(-0.5, 0.5), as in small_fit_matches_cpu) and a small MultiSiren
    (coordinates and values in [-1, 1]); returns the largest relative
    difference of the loss curves."""
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_multi_hash_mlp, make_multi_siren
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    img = dataset_from_array(synthetic_volume((16, 16, 5), seed=4)).image()
    coords, values = frames_of(img)
    models = {
        "multi_hash_mlp": (lambda d: make_multi_hash_mlp(dim_in=2, n_frames=5, n_levels=6, log2_hashmap_size=12,
                                                         base_resolution=4, per_level_scale=1.5, dim_hidden=32,
                                                         device=d, seed=5),
                           TrainConfig(epochs=2, lr=5e-3, weight_decay=1e-5), coords, values),
        "multi_siren": (lambda d: make_multi_siren(dim_in=2, dim_hidden=32, n_layers=3, n_frames=5, device=d, seed=5),
                        TrainConfig(epochs=2, lr=1e-4, weight_decay=1e-5), 2 * coords - 1, 2 * values - 1),
    }
    rels = {}
    for name, (make_model, cfg, c, v) in models.items():
        state = make_model("cpu").state_dict()
        if "encoders.table" in state:
            state["encoders.table"] = torch.empty(state["encoders.table"].shape).uniform_(
                -0.5, 0.5, generator=torch.Generator().manual_seed(6))
        losses = {}
        for dev in ("cuda", "cpu"):
            model = make_model(dev)
            model.load_state_dict(state)
            losses[dev] = Trainer(cfg).fit_frames(model, c, v, device=dev).losses
        if len(losses["cpu"]) != 10 or not np.all(np.isfinite(losses["cuda"])):
            fail(f"small fit_frames {name}: {len(losses['cpu'])} steps, card losses {losses['cuda']}")
        rels[name] = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
        if rels[name] > FIT_RTOL:
            fail(f"small fit_frames {name}: card and CPU loss curves differ by {rels[name]} > rtol {FIT_RTOL}")
    return rels


def frames_of(img):
    """(N, 2) coordinates in [0, 1] of one (X, Y) frame, C order, and the
    (T, N, 1) values of the T frames of an (X, Y, T) image, as
    scripts/experiments.py builds them for the multi-frame rows."""
    xs = np.linspace(0, 1, img.shape[0], dtype=np.float32)
    ys = np.linspace(0, 1, img.shape[1], dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    values = np.stack([img[..., t].reshape(-1, 1) for t in range(img.shape[-1])], axis=0)
    return coords, values.astype(np.float32)


def counters():
    from mri_interpolation_tpu_torch.ops import fused_mlp, hash_encode, probe

    return (hash_encode, fused_mlp, probe)


def reset_counts() -> None:
    for mod in counters():
        mod.reset_launches()


def read_counts() -> dict:
    return {k: v for mod in counters() for k, v in mod.LAUNCHES.items()}


def drive_path(name: str, kind: str, fn, steps: int, batch: int, expected: dict) -> dict:
    """Run one main path with the counters at 0 just before and read just
    after; check its artifacts, steps and launches; return its numbers."""
    from mri_interpolation_tpu_torch.io import nifti

    reset_counts()
    t0 = time.perf_counter()
    summary = fn()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    run_dir = summary["run_dir"]
    interp = nifti.load(os.path.join(run_dir, f"interpolation{GRID}.nii.gz")).get_fdata(np.float32)
    pred = nifti.load(os.path.join(run_dir, "pred.nii.gz")).get_fdata(np.float32)
    files = sorted(os.listdir(run_dir))
    if interp.shape != GRID or not np.all(np.isfinite(interp)):
        fail(f"{name}: interpolation volume shape {interp.shape}, finite {np.all(np.isfinite(interp))}")
    if pred.shape != VOLUME or not np.all(np.isfinite(pred)):
        fail(f"{name}: reconstruction shape {pred.shape}, finite {np.all(np.isfinite(pred))}")
    for f in ("metrics.json", "config.txt", "checkpoints"):
        if f not in files:
            fail(f"{name}: run dir lacks {f}: {files}")
    if not (math.isfinite(summary["psnr"]) and math.isfinite(summary["ssim"])):
        fail(f"{name}: PSNR {summary['psnr']} / SSIM {summary['ssim']} not finite")
    if summary["steps"] != steps or summary["batch_size"] != batch or launches != expected:
        fail(f"{name}: {summary['steps']} steps at batch {summary['batch_size']}, launches {launches}; "
             f"expected {steps} steps at {batch}, launches {expected}")
    train_s = summary["train_wall_s"]
    grid_s = summary["interp_eval_s"][str(GRID)]
    out = {"steps": steps, "train_wall_s": train_s, "steps_per_s": steps / train_s,
           "train_voxel_evals_per_s": steps * batch / train_s, "recon_eval_s": summary["recon_eval_s"],
           "grid_eval_s": grid_s, "grid_voxels_per_s": float(np.prod(GRID)) / grid_s, "psnr": summary["psnr"],
           "ssim": summary["ssim"], "final_loss": summary["final_loss"], "wall_s": seconds, "launches": launches}
    log(f"[{name}] {kind}: {steps} steps in {train_s:.3f} s = {out['steps_per_s']:.1f} steps/s, "
        f"{out['train_voxel_evals_per_s']:,.0f} training voxel-evals/s")
    log(f"[{name}] {kind}: {GRID} grid of {int(np.prod(GRID)):,d} voxels in {grid_s:.3f} s = "
        f"{out['grid_voxels_per_s']:,.0f} voxels/s; reconstruction {summary['recon_eval_s']:.3f} s")
    log(f"[{name}] PSNR {summary['psnr']:.3f} dB, SSIM {summary['ssim']:.4f}, final loss "
        f"{summary['final_loss']:.5f}; launches {launches}; {seconds:.1f} s")
    return out


def drive_frames(name: str, make_model, cfg, img, zero_centered: bool, expected: dict) -> dict:
    """One multi-frame path with the counters at 0 just before and read just
    after: fit_frames, then every frame's (352, 352) grid, PSNR and SSIM of
    the stacked reconstruction against the image; checks shapes, steps and
    launches; returns its numbers."""
    import torch
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction
    from mri_interpolation_tpu_torch.train import Trainer

    coords, values = frames_of(img)
    lo = -1.0 if zero_centered else 0.0
    if zero_centered:
        coords, values = 2 * coords - 1, 2 * values - 1
    n_frames = img.shape[-1]
    model = make_model()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = Trainer(cfg).fit_frames(model, coords, values)
    grid_times, vols = [], []
    for t in range(n_frames):
        tg = time.perf_counter()
        vols.append(evaluate_grid(model, FRAME, lo=lo, frame_idx=t))
        grid_times.append(time.perf_counter() - tg)
    recon = np.stack(vols, axis=-1)
    if zero_centered:
        recon = (recon + 1.0) / 2.0
    quality = evaluate_reconstruction(recon, img, data_range=1.0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    steps = cfg.epochs * n_frames
    if recon.shape != img.shape or not np.all(np.isfinite(recon)) or not np.all(np.isfinite(res.losses)):
        fail(f"{name}: reconstruction {recon.shape}, finite {np.all(np.isfinite(recon))}, losses {res.losses}")
    if not (math.isfinite(quality["psnr"]) and math.isfinite(quality["ssim"])):
        fail(f"{name}: PSNR {quality['psnr']} / SSIM {quality['ssim']} not finite")
    if res.steps != steps or launches != expected:
        fail(f"{name}: {res.steps} steps, launches {launches}; expected {steps} steps, launches {expected}")
    voxels = coords.shape[-2]
    out = {"steps": steps, "train_wall_s": res.wall_time_s, "epoch_times_s": res.epoch_times_s.tolist(),
           "steady_steps_per_s": res.steady_steps_per_sec,
           "train_voxel_evals_per_s": res.steady_steps_per_sec * voxels,
           "grid_s_per_frame": float(np.median(grid_times)), "grid_voxels_per_s": voxels / float(np.median(grid_times)),
           "psnr": quality["psnr"], "ssim": quality["ssim"], "final_loss": res.final_loss,
           "param_count": sum(p.numel() for p in model.parameters()), "wall_s": seconds, "launches": launches}
    log(f"[{name}] fit_frames: {steps} steps in {res.wall_time_s:.3f} s (epochs {res.epoch_times_s.round(4).tolist()} "
        f"s), steady {out['steady_steps_per_s']:.1f} steps/s = {out['train_voxel_evals_per_s']:,.0f} training "
        "voxel-evals/s")
    log(f"[{name}] grid {FRAME} per frame (median of {n_frames}): {out['grid_s_per_frame'] * 1e3:.3f} ms = "
        f"{out['grid_voxels_per_s']:,.0f} voxels/s; PSNR {quality['psnr']:.3f} dB, SSIM {quality['ssim']:.4f}, "
        f"final loss {res.final_loss:.5f}; {out['param_count']:,d} parameters; launches {launches}; {seconds:.1f} s")
    return out


def drive_bench(expected: dict) -> dict:
    """The kernel bench (sections 0-2) as a path: counters at 0 just before,
    read just after; every record within its tolerance."""
    from mri_interpolation_tpu_torch import bench_kernels

    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = bench_kernels.run()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    for rec in summary["kernels"]:
        log(f"[bench] {rec['kernel']:26s} batch {rec.get('batch', '-')!s:>6s}: err {rec['max_abs_err']:.3e} "
            f"(tol {rec['tolerance']:.3e})  kernel {rec['kernel_ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms")
        if not rec["ok"]:
            fail(f"bench_kernels {rec['kernel']} batch {rec.get('batch')}: error {rec['max_abs_err']} "
                 f"> {rec['tolerance']}")
    if launches != expected:
        fail(f"bench_kernels: launches {launches}; expected {expected}")
    log(f"[bench] launches {launches}; {seconds:.1f} s")
    return {"records": summary["kernels"], "wall_s": seconds, "launches": launches}


def cli(launcher, argv):
    """``launcher.main(argv)``; its printed summary is checked and kept out of the log."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = launcher.main(argv)
    if json.loads(buf.getvalue()) != json.loads(json.dumps(summary)):
        fail("launcher.main printed another summary than it returned")
    return summary


def profile_main_paths(torch) -> None:
    """Print device time by kernel over 20 training steps of each path (per
    step; one epoch of 15 frames for the multi-frame models), one
    (352, 352, 30) grid evaluation of the flagship and of path A, and the 15
    (352, 352) frame grids of the multi-frame HashMLP (per frame), each under
    torch.profiler (which slows the host, so the busy shares are lower
    bounds)."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp, make_multi_siren, make_siren
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    ds = dataset_from_array(synthetic_volume(VOLUME, seed=0))
    zc = dataset_from_array(synthetic_volume(VOLUME, seed=0), zero_centered=True)
    flagship = make_hash_mlp(3)
    siren = make_siren(3, dim_hidden=128, n_layers=6)
    img = ds.image()
    frame_coords, frame_values = frames_of(img)
    multi_hash = make_multi_hash_mlp(**MULTI_HASH)
    multi_siren = make_multi_siren(**MULTI_SIREN)
    tcnn = make_hash_mlp(3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                         per_level_scale=1.4, dim_hidden=128, n_layers=2, decoder="relu_plain")
    fit = lambda model, d, cfg, n: lambda: Trainer(cfg).fit(model, d.coords[:n], d.values[:n])  # noqa: E731
    phases = (
        ("flagship train_step", fit(flagship, ds, TrainConfig(epochs=1), 200_000), 20),
        ("path A train_step", fit(siren, zc, TrainConfig(batch_size=4096, lr=1e-4), 20 * 4096), 20),
        ("path B train_step", fit(tcnn, ds, TrainConfig(lr=1e-2, optimizer="adam_tcnn"), 200_000), 20),
        ("flagship grid_eval_352x352x30", lambda: evaluate_grid(flagship, GRID), 1),
        ("path A grid_eval_352x352x30", lambda: evaluate_grid(siren, GRID, lo=-1.0), 1),
        ("multi_hash_mlp train_step", lambda: Trainer(TrainConfig(lr=5e-3)).fit_frames(
            multi_hash, frame_coords, frame_values), 15),
        ("multi_siren train_step", lambda: Trainer(TrainConfig(lr=1e-4)).fit_frames(
            multi_siren, 2 * frame_coords - 1, 2 * frame_values - 1), 15),
        ("multi_hash_mlp grid_eval_352x352 x15", lambda: [evaluate_grid(multi_hash, FRAME, frame_idx=t)
                                                          for t in range(15)], 15),
    )
    for phase, fn, per in phases:
        kernels, wall_ms = profile_device(fn)
        busy = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[profile] {phase}: wall {wall_ms / per:.3f} ms, device busy {busy / per:.3f} ms "
            f"({100 * busy / wall_ms:.1f}% busy, profiler on)")
        for k, (ms, n) in top:
            log(f"    {ms / per:9.4f} ms  x{n / per:5.1f}  {k[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from mri_interpolation_tpu_torch import bench_kernels, launcher
    from mri_interpolation_tpu_torch.configs import RunConfig
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding
    from mri_interpolation_tpu_torch.io import dataset_from_array, nifti, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_multi_hash_mlp, make_multi_siren
    from mri_interpolation_tpu_torch.ops import build
    from mri_interpolation_tpu_torch.ops import fused_mlp as fm
    from mri_interpolation_tpu_torch.ops import hash_encode as he
    from mri_interpolation_tpu_torch.ops import probe as pr
    from mri_interpolation_tpu_torch.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 GEMMs, as the CPU reference
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build: every source at once, then the probe kernel
    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    log(f"[build] nvcc {build.NVCC_FLAGS[1]}, {len(build.SOURCES)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, out in build.build_logs().items():
        log(f"[build] {name}:\n{out.strip()}")
    probe_row = check_probe(torch, pr, dev)
    log(f"[build] probe kernel exact against 2 * x on {pr.PROBE_SHAPE}: kernel {probe_row['ms']} ms, "
        f"plain {probe_row['plain_ms']:.4f} ms, torch.mul {probe_row['library_ms']} ms")
    for who, st in probe_row["launch_stats"].items():
        if isinstance(st, dict):
            log(f"[build] {who}: {st['launches']} launches ({st['source']}): median {st['median_us']:.3f} us, "
                f"quartiles {st['p25_us']:.3f}-{st['p75_us']:.3f} us, range {st['min_us']:.3f}-{st['max_us']:.3f} us")
    log(f"[build] probe slower than torch.mul beyond the spread (its p25 > mul's p75): "
        f"{probe_row['launch_stats']['probe_slower_beyond_spread']}")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    flagship = HashGridEncoding(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                                base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
    hashed = HashGridEncoding(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                              base_resolution=16, finest_resolution=None, per_level_scale=1.4)
    log(f"[kernels] flagship: {flagship.total_size:,d} rows, dense {flagship.level_dense.tolist()}; "
        f"hashed16: {hashed.total_size:,d} rows, {int((~hashed.level_dense).sum())} of 16 levels hashed")
    rows = check_kernels(torch, he, flagship, hashed, dev)
    for name, krows in check_coarse_kernels(torch, he, dev).items():
        rows.setdefault(name, []).extend(krows)
    rows.update(check_fused_mlp(torch, fm, dev))
    rows["probe"] = [probe_row]
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    # 4. small fits, card vs CPU
    t0 = time.perf_counter()
    rels = small_fits(torch)
    rels.update(small_fit_frames_match_cpu(torch))
    log(f"[small fit] 10 steps each, card vs CPU loss curves, max rel diff (rtol {FIT_RTOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f" in {time.perf_counter() - t0:.1f} s")

    # 5. main paths
    zero = {name: 0 for name in SOURCES}
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "synthetic_352x352x15.nii.gz")
        nifti.save(synthetic_volume(VOLUME, seed=0), path)
        log(f"[main] volume written in {time.perf_counter() - t0:.1f} s")
        common = ["--image_path", path, "--epochs", "1", "--interp_shapes", str(GRID)]
        paths["flagship"] = drive_path(
            "main", "launcher.run, flagship HashMLP",
            lambda: launcher.run(RunConfig(image_path=path, output_root=os.path.join(tmp, "flagship"), epochs=1,
                                           interp_shapes=(GRID,))),
            185, 10_000, {**zero, "hash_encode_forward": 185 + CHUNKS, "hash_encode_table_grad": 185, "probe": 1})
        paths["A"] = drive_path(
            "path A", "launcher.main --config_preset siren",
            lambda: cli(launcher, ["--config_preset", "siren", "--output_root", os.path.join(tmp, "a"), *common]),
            453, 4096, {**zero, "fused_mlp_forward": 453 + CHUNKS, "fused_mlp_backward": 453, "probe": 1})
        paths["B"] = drive_path(
            "path B", "launcher.main with the tcnn flags",
            lambda: cli(launcher, [*TCNN_FLAGS, "--output_root", os.path.join(tmp, "b"), *common]),
            185, 10_000, {**zero, "hash_encode_forward": 185 + CHUNKS, "hash_encode_table_grad": 185,
                          "fused_mlp_forward": 185 + CHUNKS, "fused_mlp_backward": 185, "probe": 1})

    # the kernel bench: each timed call runs once to check, 3 times to warm up, ITERS times timed
    calls = 1 + 3 + bench_kernels.ITERS
    paths["bench"] = drive_bench({**zero, "probe": calls, "fused_mlp_forward": 3 * calls, "fused_mlp_backward": calls,
                                  "hash_encode_coarse_forward": 3 * calls, "hash_encode_coarse_table_grad": calls})

    # the multi-frame paths: 2 epochs x 15 frames, then one (352, 352) grid chunk per frame
    img = dataset_from_array(synthetic_volume(VOLUME, seed=0)).image()
    paths["multi_hash_mlp"] = drive_frames(
        "multi_hash_mlp", lambda: make_multi_hash_mlp(**MULTI_HASH), TrainConfig(epochs=2, lr=5e-3), img, False,
        {**zero, "hash_encode_forward": 30 + 15, "hash_encode_table_grad": 30, "fused_mlp_forward": 30 + 15,
         "fused_mlp_backward": 30})
    paths["multi_siren"] = drive_frames(
        "multi_siren", lambda: make_multi_siren(**MULTI_SIREN), TrainConfig(epochs=2, lr=1e-4), img, True,
        {**zero, "fused_mlp_forward": 2 * 30 + 2 * 15, "fused_mlp_backward": 2 * 30})

    # 6. where the time goes: device time by kernel over short fits and grid evaluations
    t0 = time.perf_counter()
    profile_main_paths(torch)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, krows in rows.items():
        main_row = krows[0]  # the shape of most main-path launches: a training batch, or one frame
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: p["launches"][name] for k, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in krows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
            **({"bound_tc_ms": main_row["bound_tc_ms"]} if "bound_tc_ms" in main_row else {}),
            "shapes": krows,
        })
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
