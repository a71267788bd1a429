#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mri_interpolation_tpu_torch``) on one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printed with its time as it ends:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``mri_interpolation_tpu_torch/ops/csrc`` with
   nvcc (one process per source, all at once), then the probe kernel held
   exactly to ``2 * x``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (and, for the hash kernels, a hashed geometry; for the
   fused MLP, the ``siren 352x5`` shape and a small gelu stack), with times
   and bounds;
4. small fit: ``Trainer.fit`` on the card against the same fit on the CPU, for
   the flagship HashMLP, a small SIREN and a small ``relu_plain`` HashMLP
   with ``adam_tcnn``;
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
6. profile: device time by kernel over 20 training steps of each path and one
   flagship grid evaluation (torch.profiler).

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
    "fused_mlp_forward": CSRC + "fused_mlp.cu",
    "fused_mlp_backward": CSRC + "fused_mlp.cu",
    "probe": CSRC + "probe.cu",
}
REPLACES = {
    "hash_encode_forward": "mri_interpolation_tpu/ops/pallas/hash_encode.py:175",
    "hash_encode_table_grad": "mri_interpolation_tpu/ops/pallas/hash_encode.py:198",
    "fused_mlp_forward": "mri_interpolation_tpu/ops/pallas/fused_mlp.py:185",
    "fused_mlp_backward": "mri_interpolation_tpu/ops/pallas/fused_mlp.py:205",
    "probe": "scripts/bench_pallas_exec.py:76",
}
VOLUME = (352, 352, 15)
GRID = (352, 352, 30)
CHUNKS = -(-352 * 352 * 15 // (1 << 17)) + -(-352 * 352 * 30 // (1 << 17))  # 15 + 29
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
    from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren

    gen = torch.Generator(device="cpu").manual_seed(1)
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
                   "bound_ms": fb, "bound_by": fk, "library_ms": None}
            rows["fused_mlp_forward"].append(row)
            log(f"  mlp forward  {what:13s} dims {dims[0]}-{dims[1]}x{len(dims) - 2}-{dims[-1]} N={n:>7,d}: "
                f"err {err:.3e}  kernel {row['ms']} ms  per call {row['call_ms']:.4f} ms  "
                f"plain {row['plain_ms']:.4f} ms  bound {fb:.5f} ms ({fk})")
            if not backward:
                continue
            g = torch.randn((n, dims[-1]), generator=gen).to(dev)
            dws, dbs, dx = fm.mlp_backward(ws, bs, x, g, acts, need_dx)
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
                   "bound_ms": gb, "bound_by": gk, "library_ms": None}
            rows["fused_mlp_backward"].append(row)
            log(f"  mlp backward {what:13s} N={n:>7,d} dx={need_dx!s:5s}: err {err:.3e}  kernel {row['ms']} ms  "
                f"per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound {gb:.5f} ms ({gk})")
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
    return {"what": "build check", "n": n, "max_abs_err": 0.0,
            **kernel_times(lambda: pr.probe(x), "probe_double_kernel"),
            "plain_ms": time_ms(lambda: pr.probe_reference(x)), "bound_ms": pb, "bound_by": pk,
            "library_ms": kernel_ms(lambda: torch.mul(x, 2.0), "")}


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
    step) and one (352, 352, 30) grid evaluation of the flagship and of path
    A, each under torch.profiler (which slows the host, so the busy shares
    are lower bounds)."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    ds = dataset_from_array(synthetic_volume(VOLUME, seed=0))
    zc = dataset_from_array(synthetic_volume(VOLUME, seed=0), zero_centered=True)
    flagship = make_hash_mlp(3)
    siren = make_siren(3, dim_hidden=128, n_layers=6)
    tcnn = make_hash_mlp(3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                         per_level_scale=1.4, dim_hidden=128, n_layers=2, decoder="relu_plain")
    fit = lambda model, d, cfg, n: lambda: Trainer(cfg).fit(model, d.coords[:n], d.values[:n])  # noqa: E731
    phases = (
        ("flagship train_step", fit(flagship, ds, TrainConfig(epochs=1), 200_000), 20),
        ("path A train_step", fit(siren, zc, TrainConfig(batch_size=4096, lr=1e-4), 20 * 4096), 20),
        ("path B train_step", fit(tcnn, ds, TrainConfig(lr=1e-2, optimizer="adam_tcnn"), 200_000), 20),
        ("flagship grid_eval_352x352x30", lambda: evaluate_grid(flagship, GRID), 1),
        ("path A grid_eval_352x352x30", lambda: evaluate_grid(siren, GRID, lo=-1.0), 1),
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
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.configs import RunConfig
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.ops import build
    from mri_interpolation_tpu_torch.ops import fused_mlp as fm
    from mri_interpolation_tpu_torch.ops import hash_encode as he
    from mri_interpolation_tpu_torch.ops import probe as pr

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

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    flagship = HashGridEncoding(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                                base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
    hashed = HashGridEncoding(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                              base_resolution=16, finest_resolution=None, per_level_scale=1.4)
    log(f"[kernels] flagship: {flagship.total_size:,d} rows, dense {flagship.level_dense.tolist()}; "
        f"hashed16: {hashed.total_size:,d} rows, {int((~hashed.level_dense).sum())} of 16 levels hashed")
    rows = check_kernels(torch, he, flagship, hashed, dev)
    rows.update(check_fused_mlp(torch, fm, dev))
    rows["probe"] = [probe_row]
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    # 4. small fits, card vs CPU
    t0 = time.perf_counter()
    rels = small_fits(torch)
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

    # 6. where the time goes: device time by kernel over short fits and grid evaluations
    t0 = time.perf_counter()
    profile_main_paths(torch)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, krows in rows.items():
        main_row = krows[0]  # the shape most main-path launches take: a training batch
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: p["launches"][name] for k, p in paths.items()},
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
