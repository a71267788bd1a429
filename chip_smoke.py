#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mri_interpolation_tpu_torch``) on one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printed with its time as it ends:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``mri_interpolation_tpu_torch/ops/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a hashed geometry, with times and byte bounds;
4. small fit: ``Trainer.fit`` on the card against the same fit on the CPU;
5. main path: ``launcher.run`` with the flagship defaults on a synthetic
   (352, 352, 15) volume (1 epoch = 185 steps at batch 10,000, then the
   (352, 352, 30) interpolation grid), with the kernels' launch counts;
6. profile: device time by kernel over 20 training steps and one grid
   evaluation (torch.profiler).

The last two lines are the kernels' JSON line and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
them. With no CUDA device the script exits 1 at once.
"""

from __future__ import annotations

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

FWD_ATOL = 2e-6  # fp32 sum of 8 products of magnitude <= 1, taken in another order
GRAD_ATOL = 1e-5  # fp32 atomics in run-dependent order, a few terms of |g*w| <= 4 per row
FIT_RTOL = 1e-4  # 10 Adam steps, card GEMMs and atomics vs CPU summation order (as the CPU parity)

SOURCE = "mri_interpolation_tpu_torch/ops/csrc/hash_encode.cu"
REPLACES = {
    "hash_encode_forward": "mri_interpolation_tpu/ops/pallas/hash_encode.py:175",
    "hash_encode_table_grad": "mri_interpolation_tpu/ops/pallas/hash_encode.py:198",
}


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


def kernel_times(call, name: str) -> dict:
    """The kernel's device time per launch (profiler; the back-to-back
    per-call time by events where the profiler records none) and the
    per-call time of its wrapper."""
    call_ms = time_ms(call)
    ms = kernel_ms(call, name)
    return {"ms": call_ms if ms is None else ms, "ms_source": "events" if ms is None else "profiler",
            "call_ms": call_ms}


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
               **kernel_times(call, "hash_encode_table_grad_kernel"),
               "plain_ms": time_ms(lambda: he.hash_encode_table_grad_reference(enc, x, g), iters=5),
               "bound_ms": gb, "bound_by": gk,
               # every kernel that the one index_add_ call launches
               "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
        rows["hash_encode_table_grad"].append(row)
        log(f"  table_grad {geom:8s} N={n:>9,d} ({what}): err {err:.3e}  kernel {row['ms']} ms"
            f"  per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
            f"  index_add_ {row['library_ms']} ms  bound {gb:.5f} ms ({gk})")
    return rows


def small_fit_matches_cpu(torch):
    """Ten steps of Trainer.fit on a (16, 16, 8) volume, card vs CPU, from
    one init whose table is redrawn U(-0.5, 0.5): at the factory's 1e-4
    table scale BatchNorm cancels nearly equal numbers and the curves of any
    two summation orders drift apart by ~3e-4 (tests/test_torch_trainer.py)."""
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=3))
    kw = dict(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, seed=5)
    cfg = TrainConfig(batch_size=200, epochs=1, shuffle=False)
    losses = {}
    table = torch.empty(make_hash_mlp(3, device="cpu", **kw).encoder.table.shape).uniform_(
        -0.5, 0.5, generator=torch.Generator().manual_seed(6))
    for dev in ("cuda", "cpu"):
        model = make_hash_mlp(3, device=dev, **kw)
        with torch.no_grad():
            model.encoder.table.copy_(table)
        losses[dev] = Trainer(cfg).fit(model, ds.coords, ds.values, device=dev).losses
    if not np.all(np.isfinite(losses["cuda"])):
        fail("small fit on the card gave non-finite losses")
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    if rel > FIT_RTOL:
        fail(f"small fit: card and CPU loss curves differ by {rel} > rtol {FIT_RTOL}")
    return rel, len(losses["cpu"])


def profile_main_path(torch) -> None:
    """Print device time by kernel over a 20-step flagship fit (batch
    10,000; per step) and one (352, 352, 30) grid evaluation, each under
    torch.profiler (which slows the host, so the busy shares are lower
    bounds)."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    ds = dataset_from_array(synthetic_volume((352, 352, 15), seed=0))
    coords, values = ds.coords[:200_000], ds.values[:200_000]
    model = make_hash_mlp(3)
    trainer = Trainer(TrainConfig(epochs=1))
    for phase, fn, per in (("train_step", lambda: trainer.fit(model, coords, values), 20),
                           ("grid_eval_352x352x30", lambda: evaluate_grid(model, (352, 352, 30)), 1)):
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
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.configs import RunConfig
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.ops import build
    from mri_interpolation_tpu_torch.ops import hash_encode as he

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

    # 2. build
    t0 = time.perf_counter()
    build.load("hash_encode")
    log(f"[build] nvcc {build.NVCC_FLAGS[1]}: {time.perf_counter() - t0:.1f} s")
    for name, out in build.build_logs().items():
        log(f"[build] {name}:\n{out.strip()}")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    flagship = HashGridEncoding(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                                base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
    hashed = HashGridEncoding(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                              base_resolution=16, finest_resolution=None, per_level_scale=1.4)
    log(f"[kernels] flagship: {flagship.total_size:,d} rows, dense {flagship.level_dense.tolist()}; "
        f"hashed16: {hashed.total_size:,d} rows, {int((~hashed.level_dense).sum())} of 16 levels hashed")
    rows = check_kernels(torch, he, flagship, hashed, dev)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    # 4. small fit, card vs CPU
    t0 = time.perf_counter()
    rel, steps = small_fit_matches_cpu(torch)
    log(f"[small fit] {steps} steps, card vs CPU loss curves: max rel diff {rel:.3e} "
        f"(rtol {FIT_RTOL}) in {time.perf_counter() - t0:.1f} s")

    # 5. main path
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "synthetic_352x352x15.nii.gz")
        nifti.save(synthetic_volume((352, 352, 15), seed=0), path)
        cfg = RunConfig(image_path=path, output_root=os.path.join(tmp, "runs"), epochs=1,
                        interp_shapes=((352, 352, 30),))
        log(f"[main] volume written in {time.perf_counter() - t0:.1f} s; launcher.run starts")
        he.reset_launches()
        t_run = time.perf_counter()
        summary = launcher.run(cfg)
        run_s = time.perf_counter() - t_run
        launches = dict(he.LAUNCHES)
        run_dir = summary["run_dir"]
        interp = nifti.load(os.path.join(run_dir, "interpolation(352, 352, 30).nii.gz")).get_fdata(np.float32)
        pred = nifti.load(os.path.join(run_dir, "pred.nii.gz")).get_fdata(np.float32)
        files = sorted(os.listdir(run_dir))
    if interp.shape != (352, 352, 30) or not np.all(np.isfinite(interp)):
        fail(f"interpolation volume: shape {interp.shape}, finite {np.all(np.isfinite(interp))}")
    if pred.shape != (352, 352, 15) or not np.all(np.isfinite(pred)):
        fail(f"reconstruction: shape {pred.shape}, finite {np.all(np.isfinite(pred))}")
    for name in ("metrics.json", "config.txt", "checkpoints"):
        if name not in files:
            fail(f"run dir lacks {name}: {files}")
    if not (math.isfinite(summary["psnr"]) and math.isfinite(summary["ssim"])):
        fail(f"PSNR {summary['psnr']} / SSIM {summary['ssim']} not finite")
    steps = summary["steps"]
    chunks = -(-352 * 352 * 15 // (1 << 17)) + -(-352 * 352 * 30 // (1 << 17))
    expected = {"hash_encode_forward": steps + chunks, "hash_encode_table_grad": steps}
    if steps != 185 or launches != expected:
        fail(f"launches {launches}, expected {expected} for {steps} steps (185 expected)")
    voxels_per_s = steps * summary["batch_size"] / summary["train_wall_s"]
    grid_s = summary["interp_eval_s"][str((352, 352, 30))]
    log(f"[main] {kind}: {steps} steps in {summary['train_wall_s']:.3f} s = "
        f"{steps / summary['train_wall_s']:.1f} steps/s, {voxels_per_s:,.0f} training voxel-evals/s "
        f"(first epoch, build already done)")
    log(f"[main] {kind}: (352,352,30) grid of {352 * 352 * 30:,d} voxels evaluated in {grid_s:.3f} s = "
        f"{352 * 352 * 30 / grid_s:,.0f} voxels/s; reconstruction {summary['recon_eval_s']:.3f} s")
    log(f"[main] PSNR {summary['psnr']:.3f} dB, SSIM {summary['ssim']:.4f}, final loss "
        f"{summary['final_loss']:.5f}; launches {launches}; launcher.run {run_s:.1f} s")

    # 6. where the time goes: device time by kernel over a short fit and a grid evaluation
    t0 = time.perf_counter()
    profile_main_path(torch)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, krows in rows.items():
        main_row = krows[0]  # flagship, training batch: the shape of most main-path launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in krows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
            "shapes": krows,
        })
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
