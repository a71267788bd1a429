#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mri_interpolation_tpu_torch``) on one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printed with its time as it ends:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``mri_interpolation_tpu_torch/ops/csrc`` with
   nvcc (one process per source, all at once) and the native NIfTI codec
   (``mri_interpolation_tpu_torch/native``) with g++, then the probe kernel held
   exactly to ``2 * x`` and timed against ``torch.mul`` and an empty kernel
   (a launch alone) as medians of 200 launches each;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (and, for the hash kernels, a hashed geometry at a
   training batch and at path B's grid chunk; for the fused MLP, path B's
   grid chunk, the ``siren 352x5`` shape (route 1 with two activation
   buffers), a small gelu stack, the widest stack the kernels take (``relu
   8-832-3``: route 2 throughout, 32-row blocks, a dot product for N = 3)
   and the multi-frame models' three stacks at one frame; for the
   coarse-level pair, the kernel bench's geometry, the JAX tests' geometry
   and the multi-frame HashMLP's levels 0-3 at one 352 x 352 frame, x
   uniform and in raster order, with kernels 1 and 2 beside them on the same
   levels (times side by side), on the whole multi-frame encoder and on it
   in raster order; and what one
   multi-frame grid frame launches: kernel 1 at the frame's coordinates,
   kernel 5 on the three stacks at their grid inputs; kernels 1-2 on the
   NGP geometry, 3 dense levels x F = 8, and kernels 5-6 on its relu
   24-64-1 decoder, at a training batch and a grid chunk, x in [0, 1] and
   in [-1, 1]; kernels 1-2 on hash_siren's encoder at N = 20,000, x in
   [-1, 1], and on the temporal protocol's at N = 10,000; kernels 5-6 on
   the protocol's relu 16-64-1 decoder; kernels 1-2 on the warp INR's 2-D
   encoder at N = 10,000 and 131,072, x = clip(u + 0.05 n, 0, 1), with the
   plain-torch coordinate gradient beside them, card against CPU; kernels
   1-2 on the full-4D recipe's encoder, 5 levels x F = 4 at 16 corners,
   12,134,251 rows, at N = 50,000 and 131,072, x in [0, 1]), with
   times (the
   profiler's device time, or CUDA events over a CUDA graph where it records
   none; kernel 5's forward rows hold its split prologue and its forward
   kernel), bounds (for kernels 5-6 also the 3xTF32 tensor-core bound) and
   ``index_add_``'s time beside kernels 2 and 4;
4. small fit: ``Trainer.fit`` on the card against the same fit on the CPU, for
   the flagship HashMLP, a small SIREN and a small ``relu_plain`` HashMLP
   with ``adam_tcnn``; ``Trainer.fit_frames`` likewise for a small
   MultiHashMLP and MultiSiren; then the options: the relu_plain HashMLP
   with cosine and gradient accumulation, the flagship with a freeze mask
   and weight decay, with the level anneal and the temporal TV, and with
   remat (held also to the card's fit without remat, BatchNorm statistics
   and the anneal counter included), ``fit_frames`` with cosine and
   accumulation, and the modulated, hash and PSF SIRENs; then the rest of
   the zoo: BaseMLP, RffNet, the real GaborNet, FreqMLP (siren encoder
   with a skip, and rff) and the warp INR (residual, warp_accel,
   warp_smooth, a level anneal); then the registrations at their default
   stages on the card and on the CPU (``register_pair`` on a (352, 352)
   pair and a (64, 64, 6) pair, ``register_group_temporal`` on 4 (352, 352)
   frames; a smooth frame under smooth displacements): the step-0 gradient,
   the first 10 losses, the control fields and the midpoints they
   synthesise; and ``Trainer.fit_streaming`` card against CPU, its first
   10 losses, for the recipe's shape cut to a (16, 16, 6, 5) volume and for
   the flagship HashMLP at its width on the (352, 352, 15) volume;
5. main paths, each with the launch counters set to 0 just before it and
   read just after:
   - flagship: ``launcher.run`` with the defaults on a synthetic
     (352, 352, 15) volume (1 epoch = 185 steps at batch 10,000, then the
     (352, 352, 30) interpolation grid; its all-dense encoder takes the
     separable grid path, so kernel 1 runs in training only);
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
   - ngp: ``launcher.main`` with the NGP 3-level F=8 paper+cosine flags
     (``scripts/experiments.py:158-166``: 2,224,303 dense rows x 8,
     relu_plain 24 -> 64 -> 1, ``adam_tcnn``, lr 1e-2, batch 10,000), 2
     epochs (370 steps) with the cosine over both, the eval PSNR and a
     checkpoint every epoch, then the grids; its scalars, checkpoints and
     last learning rate are checked;
   - ngp_resume: the same model resumed from ngp's checkpoints for 1
     epoch with gradient accumulation 2, remat and the temporal TV: its
     first loss continues ngp's last, and kernels 1 and 5 launch twice a
     step;
   - flagship_anneal: ``launcher.run`` with the flagship defaults and a
     92-step level anneal, whose launches are the flagship's;
   - protocol_tv: ``launcher.main --even_frames_only true --save_latents
     true`` with the temporal protocol's flags (``scripts/experiments.py:
     267-273``: 4 dense levels x F = 4, paper growth, relu_plain 16 -> 64 ->
     1, temporal TV 0.01, ``adam_tcnn``, lr 1e-2, cosine, weight decay 1e-5):
     99 steps on the 8 even frames, then the grids by the separable path;
     the odd frames' PSNR and SSIM, and ``latents.nii.gz`` (352, 352, 15, 16);
   - hash_siren (64x4, 10 levels, batch 20,000, zero-centred: 92 steps,
     kernel 1 on every grid chunk), modulated_siren (256x4, batch 20,000:
     92 steps) and psf_siren (256x5, 5^3 PSF points, batch 4096: 453 steps
     of 512,000-row plain forwards; its spacing checked);
   - flagship_undersample: the flagship on the 10% of the voxels that
     seed 1337's mask keeps (kept // 10,000 steps);
   - warp_protocol: ``launcher.main --model_class warp_inr
     --even_frames_only true`` with ``scripts/experiments.py:275-280``'s
     widths and RESULTS.md:34's residual (99 steps, the resolutions derived
     from the frames, kernel 1 on every grid chunk), the odd frames' PSNR
     and SSIM; warp_ensemble: ``ensembled_warp_fit_eval``, 2 seeds of 1
     epoch with warp_accel 1.0, blended with the linear baseline at 0.25;
   - rff_net, gabor, freq_mlp and mlp at RESULTS.md's widths, batch 20,000
     (92 steps each; plain torch, only the probe launches);
   - classical: the CLI with ``--method linear`` and ``cubic``, each file
     held to numpy within 1e-6;
   - registration_protocol: ``registration_interp_eval`` at its defaults
     (7 pairs), the odd frames' PSNR and SSIM and the wall a pair;
     classical_registration: the CLI with ``--method registration`` and
     ``registration_group`` (finite files, the even frames exact);
   - stacked: ``stacked_interp_eval`` with ``STACK_ROSTER`` (warp_transfer of
     one seed and one epoch, both registrations, cubic, linear): the global
     LOO weights on the simplex, the odd PSNR, sigma_mean, kernels 1-2 once
     a step of the 7 warp fits; stacking_cli: ``python -m
     ...train.stacking`` on the volume's 8 even frames (saved as NIfTI)
     with the same roster and a cache, twice: 7 fits and the odd frames
     scored against the volume's, then a replay that calls no family,
     launches nothing and writes the same volume;
   - full4d: the full-4D recipe (``scripts/experiments.py:398-402``) on a
     synthetic (352, 352, 6, 15) volume written as uncompressed NIfTI
     through ``launcher.main``: ``--plan`` (no device), full4d_resident (1
     epoch of 30: 223 steps at batch 50,000, then the (352, 352, 6, 30)
     interpolation) and full4d_streamed (``--stream_shard_voxels 4194304``:
     3 shards of 83 steps; no interpolation grid), with steps/s, the
     streamed epoch's host-synthesis and host-to-device seconds, each run's
     peak of allocated device memory and PSNR; the plan's table, decoder,
     Adam-moment and dataset bytes held exactly to the resident fit's, its
     step total printed beside both peaks, and the step roofline fed the
     resident steps/s;
   - the tooling: a ``--config_yaml`` run, a 2-D launcher run whose
     ``pred.png`` is decoded and held to viridis of ``pred.T``,
     ``make_figures`` on protocol_tv's run directory, the sweep CLI (2
     ``recon`` trials of 1 epoch and 2 ``odd_frames`` trials with
     ``--ens_seeds 2``, then both again from their logs, launching nothing)
     and a SIREN preset fit of a synthetic MNIST digit; ngp's run also
     writes its TensorBoard event file, read back equal to its scalars;
   - grid routes: the flagship's and ngp's fitted models on the (352, 352,
     30) grid by the separable path and by kernel 1 per chunk (``transform=
     lambda x: x``), held to each other (atol 1e-4 / 1e-5), their device
     and wall times, and ``transport="u16"`` within one step of f32;
   - native: the launcher's whole-volume load through the native NIfTI
     codec (built with g++ in phase 2) against numpy, on the (352, 352, 15)
     ``.nii.gz`` and the full-4D ``.nii``: within 2^-23 of the largest
     magnitude, and the seconds of each;
   - export (after the multi-frame paths, whose model it serves): the
     flagship's, path A's and path B's fitted models exported
     (``infer.export_evaluator_bytes``), written, loaded and run on the
     (352, 352, 30) grid in 114 chunks of 2^15, multi_hash_mlp's at frame 7,
     and full4d_resident's at float32 and with bf16 tables on (352, 352, 6,
     30) in 171 chunks of 2^17: each artifact equal to ``evaluate_grid``'s
     per-chunk route within 1e-6 and launching each of its kernels once a
     chunk (the flagship's also within 1e-4 of the separable route), bf16
     within 5e-3 of float32, the full-4D files at or above the plan's
     serving bytes and bf16 saving more than 0.4 x the table's; export,
     write and load seconds, each artifact's grid wall beside
     ``evaluate_grid``'s, the sizes;
6. profile: device time by kernel over 20 training steps of each path (one
   epoch of 15 frames for the multi-frame models) and one grid evaluation
   of the flagship, paths A and B, ngp, protocol_tv, hash_siren and
   warp_protocol (torch.profiler), 20 steps of the full-4D recipe at batch
   50,000, 20 steps of the registrations' full-size
   pair and group stages, and the warp coordinate gradient's device time a
   step (from phase 3).

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
import types

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
# the NGP 3-level F=8 paper+cosine HashMLP (scripts/experiments.py:158-166, RESULTS.md:16)
NGP = dict(n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(64, 64, 5),
           finest_resolution=(352, 352, 15), growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain")
NGP_FLAGS = ["--n_levels", "3", "--n_features_per_level", "8", "--log2_hashmap_size", "23",
             "--base_resolution", "64,64,5", "--finest_resolution", "352,352,15", "--growth", "paper",
             "--dim_hidden", "64", "--n_layers", "2", "--decoder", "relu_plain", "--optimizer", "adam_tcnn",
             "--lr", "1e-2", "--batch_size", "10000"]
NGP_STEPS = 185  # one epoch of (352, 352, 15) at batch 10,000
GRID_CHUNKS = -(-352 * 352 * 30 // (1 << 17))  # 29: the interpolation grid's chunks on the per-chunk route
# the temporal protocol's HashMLP (RESULTS.md:32, scripts/experiments.py:267-273): full time resolution and
# temporal TV, trained on the even frames; 4 dense levels x F=4, paper growth, relu_plain 16 -> 64 -> 1
PROTOCOL = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2),
                finest_resolution=(352, 352, 15), growth="paper")
PROTOCOL_FLAGS = ["--n_levels", "4", "--n_features_per_level", "4", "--log2_hashmap_size", "23",
                  "--base_resolution", "64,64,2", "--finest_resolution", "352,352,15", "--growth", "paper",
                  "--dim_hidden", "64", "--n_layers", "2", "--decoder", "relu_plain", "--temporal_tv", "0.01",
                  "--optimizer", "adam_tcnn", "--lr", "1e-2", "--lr_schedule", "cosine", "--cosine_t_max", "1",
                  "--weight_decay", "1e-5", "--batch_size", "10000", "--even_frames_only", "true",
                  "--save_latents", "true"]
# hash_siren 64x4 (scripts/experiments.py:200-203): 10 levels x F=2, log2 17, 921,464 rows, levels 0-3 dense
HASH_SIREN = dict(dim=3, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                  finest_resolution=None, per_level_scale=1.4)
HASH_SIREN_FLAGS = ["--model_class", "hash_siren", "--zero_centered", "true", "--n_levels", "10",
                    "--n_features_per_level", "2", "--log2_hashmap_size", "17", "--base_resolution", "16",
                    "--per_level_scale", "1.4", "--dim_hidden", "64", "--n_layers", "4", "--batch_size", "20000",
                    "--lr", "1e-4"]
# modulated_siren 256x4 (experiments.py:122-126) and psf_siren 256x5 with 5^3 PSF points (experiments.py:191-195)
MODULATED_FLAGS = ["--model_class", "modulated_siren", "--zero_centered", "true", "--dim_hidden", "256",
                   "--n_layers", "4", "--batch_size", "20000", "--lr", "1e-4"]
PSF_FLAGS = ["--model_class", "psf_siren", "--zero_centered", "true", "--dim_hidden", "256", "--n_layers", "5",
             "--n_sample", "5", "--batch_size", "4096", "--lr", "1e-4"]
# the warp INR of scripts/experiments.py:275-280 with RESULTS.md:34's residual: a 2-D canonical encoder (4 dense
# levels x F = 4, paper growth, base 64, finest 352: 181,603 rows), relu 16 -> 64 -> 1, SIREN warp 3 -> 64 -> 64 -> 2
# at w0 5 and scale 0.05, residual 0.05
WARP = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64),
            finest_resolution=(352, 352), growth="paper", dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
            warp_w0=5.0, warp_scale=0.05, residual_scale=0.05)
WARP_GEOMETRY = dict(dim=2, **{k: WARP[k] for k in ("n_levels", "n_features_per_level", "log2_hashmap_size",
                                                    "base_resolution", "finest_resolution", "growth")})
# the launcher derives base (64, 64) and finest (352, 352) from the volume's frames
WARP_FLAGS = ["--model_class", "warp_inr", "--n_levels", "4", "--n_features_per_level", "4", "--log2_hashmap_size",
              "23", "--growth", "paper", "--dim_hidden", "64", "--n_layers", "2", "--warp_hidden", "64",
              "--warp_layers", "3", "--warp_w0", "5", "--warp_scale", "0.05", "--residual_scale", "0.05",
              "--optimizer", "adam_tcnn", "--lr", "1e-2", "--lr_schedule", "cosine", "--cosine_t_max", "1",
              "--weight_decay", "1e-5", "--batch_size", "10000", "--even_frames_only", "true"]
# the rest of the zoo at RESULTS.md:12-14,21's widths (scripts/experiments.py:128-186), batch 20,000
ZOO_FLAGS = {
    "rff_net": ["--model_class", "rff_net", "--dim_hidden", "256", "--n_layers", "4", "--n_frequencies", "256",
                "--sigma", "10", "--lr", "1e-4"],
    "gabor": ["--model_class", "gabor", "--zero_centered", "true", "--dim_hidden", "256", "--n_layers", "4",
              "--sigma", "10", "--lr", "3e-4"],
    "freq_mlp": ["--model_class", "freq_mlp", "--dim_hidden", "352", "--n_layers", "4", "--encoder_type", "siren",
                 "--n_frequencies", "352", "--n_frequencies_t", "15", "--skip_connections", "2", "--lr", "1e-3",
                 "--weight_decay", "1e-5"],
    "mlp": ["--model_class", "mlp", "--dim_hidden", "352", "--n_layers", "8", "--lr", "1e-4"],
}
# the registrations (infer/registration.py) at their defaults: Adam at 3e-3, pyramid (4, 2, 1), control grids
# (8, 16, 32), 200 steps a stage for a pair and 300 for the group. Card vs CPU after the default stages: Adam divides
# each gradient by its running RMS, so where the loss is flat float rounding moves a control point by up to lr a step:
# the fields are held within lr, and the midpoints they synthesise within 2e-4 of their largest value, or each within
# twice as far as the CPU's own move when one input frame is perturbed by 1e-7 (N(0, 1) noise, seeded), where the
# problem is that ill-conditioned (the group's common drift, which its 1e-4 gauge term barely holds, moves every
# field and no midpoint); the step-0 gradient within 1e-5 of its largest entry with no sign flipped (the card's
# reductions and products sum in other orders; the 3-D pair's gradient is small beside its terms), and the first
# stage's first 10 losses within FIT_RTOL, as the small fits' 10-step curves (PERF.md section 2)
REG_LR = 3e-3
REG_FRAME, REG_FRAME_3D = (352, 352), (64, 64, 6)
REG_MID_SHARE = 2e-4
REG_GRAD_SHARE = 1e-5
# the stacked fusion's roster on the card: the transfer of a one-seed, one-epoch warp INR (default_interp_families'
# widths), the pairwise and group registrations at their defaults, cubic and linear
STACK_ROSTER = ("warp_transfer", "registration", "registration_group", "cubic", "linear")
TCNN_FLAGS = ["--n_levels", "16", "--n_features_per_level", "2", "--log2_hashmap_size", "19",
              "--base_resolution", "16", "--per_level_scale", "1.4", "--dim_hidden", "128", "--n_layers", "2",
              "--decoder", "relu_plain", "--lr", "1e-2", "--optimizer", "adam_tcnn"]
# the full-4D recipe (scripts/experiments.py:398-402) on the ankle volume's (352, 352, 6, 15) shape: 5 levels x F = 4,
# paper growth, the base rank-adapted to (64, 64, 2, 3) as the launcher derives it (12,134,251 rows, levels 0-3
# dense, 4 hashed), relu_plain 20 -> 64 -> 1, adam_tcnn at 1e-2 with the cosine over its 30 epochs, batch 50,000
# (16 corners a point and level); its interpolation grid doubles the time axis
FULL4D_VOLUME = (352, 352, 6, 15)
FULL4D_GRID = (352, 352, 6, 30)
FULL4D = dict(n_levels=5, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2, 3),
              finest_resolution=(352, 352, 6, 15), growth="paper")
FULL4D_FLAGS = ["--model_class", "hash_mlp", "--batch_size", "50000", "--n_levels", "5", "--n_features_per_level",
                "4", "--growth", "paper", "--decoder", "relu_plain", "--optimizer", "adam_tcnn", "--lr", "1e-2",
                "--lr_schedule", "cosine", "--cosine_t_max", "30", "--save_checkpoint", "false", "--epochs", "1"]
FULL4D_STEPS = 352 * 352 * 6 * 15 // 50_000  # 223: one resident epoch
STREAM_SHARD = 1 << 22  # the JAX launcher's default shard: 83 steps of 50,000, so 3 shards and 249 steps an epoch
STREAM_STEPS = -(-352 * 352 * 6 * 15 // (STREAM_SHARD // 50_000 * 50_000)) * (STREAM_SHARD // 50_000)
FULL4D_CHUNKS = -(-352 * 352 * 6 * 15 // (1 << 17))  # 86: the reconstruction's chunks (a hashed level: per chunk)
FULL4D_GRID_CHUNKS = -(-352 * 352 * 6 * 30 // (1 << 17))  # 171


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


def table_grad_bytes(n: int, d: int, L: int, F: int, touched_rows: int) -> float:
    """Bytes kernel 2 moves: x and g read once, and a read and a write of
    each touched (row, feature) of the zeroed gradient (its atomics add into
    those alone; the wrapper's zero fill of the dense (T, F) output is a
    separate kernel, not timed with it)."""
    return 4.0 * (n * d + n * L * F + 2 * touched_rows * F)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events around one
    replay of a CUDA graph of ``iters`` back-to-back calls: the kernels'
    time without the host's cost of launching them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(call, name: str, per_call: bool = False) -> dict:
    """The kernel's device time per launch (profiler) and the per-call time
    of its wrapper. ``per_call``: the device time of all the kernels whose
    name holds ``name`` per call of ``call`` (a wrapper that launches
    several), with each one's share under ``parts``. Where the profiler
    records no device time, the kernels alone by CUDA events over a CUDA
    graph of 20 back-to-back calls (``ms_source`` "graph events"); a call
    that the graph cannot capture fails the run."""
    call_ms = time_ms(call)
    parts = {}
    if per_call:
        kernels, _ = profile_device(call, 20)
        parts = {key: ms / 20 for key, (ms, _) in kernels.items() if name in key}
        ms = sum(parts.values()) if parts else None
    else:
        ms = kernel_ms(call, name)
    source = "profiler"
    if ms is None:
        ms, source = graph_ms(call), "graph events"
    out = {"ms": ms, "ms_source": source, "call_ms": call_ms}
    if parts:
        out["parts"] = parts
    return out


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
        ("hashed16", enc_hashed, points(1 << 17, 3), "grid chunk"),  # path B's grid
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
        gb, gk = bound_ms(table_grad_bytes(n, d, L, F, touched), n * L * flops_per_point_level(d, F, grad=True))
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


def encoder_rows(torch, he, enc, table, x, g, what: str, geometry: str = "multi_frame") -> dict:
    """Kernels 1 and 2 on the encoder ``enc`` (by default the multi-frame
    one at one frame), against their plain versions (forward: 2e-6 of the
    largest value; table gradient: the per-entry atomic bound), with times,
    bounds, the plain versions' and, for kernel 2, ``index_add_``'s."""
    n, d, L, F = x.shape[0], enc.input_dim, enc.n_levels, enc.n_features_per_level
    out = he.hash_encode_forward(enc, table, x)
    ref = he.hash_encode_reference(enc, table, x)
    dt = he.hash_encode_table_grad(enc, x, g)
    dref = he.hash_encode_table_grad_reference(enc, x, g)
    abs_sum = he.table_grad_abs_sum(enc, x, g)
    torch.cuda.synchronize()
    ferr, tol = float((out - ref).abs().max()), FWD_ATOL * max(1.0, float(ref.abs().max()))
    if not math.isfinite(ferr) or ferr > tol:
        fail(f"hash_encode_forward {geometry} {what}: max abs err {ferr} > {tol}")
    gerr = float((dt - dref).abs().max())
    excess = float(((dt - dref).abs() - he.atomic_sum_bound(abs_sum)).max())
    if not math.isfinite(gerr) or excess > 0.0:
        fail(f"hash_encode_table_grad {geometry} {what}: max abs err {gerr}, {excess} over the per-row bound")
    ids, w = enc.corner_ids_and_weights(x)
    touched = int(torch.unique(ids).numel())
    contrib = (g.reshape(n, L, 1, F) * w.unsqueeze(-1)).reshape(-1, F)
    flat_ids, zeros = ids.reshape(-1), torch.zeros((enc.total_size, F), device=x.device)
    fb, fk = bound_ms(4.0 * (n * d + touched * F + n * L * F), n * L * flops_per_point_level(d, F, grad=False))
    gb, gk = bound_ms(table_grad_bytes(n, d, L, F, touched), n * L * flops_per_point_level(d, F, grad=True))
    frow = {"geometry": geometry, "n": n, "what": what, "max_abs_err": ferr, "tolerance": tol,
            **kernel_times(lambda: he.hash_encode_forward(enc, table, x), "hash_encode_forward_kernel"),
            "plain_ms": time_ms(lambda: he.hash_encode_reference(enc, table, x), iters=5),
            "bound_ms": fb, "bound_by": fk, "library_ms": None}
    grow = {"geometry": geometry, "n": n, "what": what, "max_abs_err": gerr,
            "largest_bound": float(he.atomic_sum_bound(abs_sum).max()),
            **kernel_times(lambda: he.hash_encode_table_grad(enc, x, g), "hash_encode_table_grad", per_call=True),
            "plan": he.table_grad_plan(enc, n)._asdict(),
            "plain_ms": time_ms(lambda: he.hash_encode_table_grad_reference(enc, x, g), iters=5),
            "bound_ms": gb, "bound_by": gk,
            "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
    for label, row in (("forward   ", frow), ("table_grad", grow)):
        log(f"  {label} {geometry} N={n:>7,d} ({what}): err {row['max_abs_err']:.3e}  kernel {row['ms']} ms"
            f"  per call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
            f"  library {row['library_ms']} ms  bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return {"hash_encode_forward": frow, "hash_encode_table_grad": grow}


def check_ngp_hash_kernels(torch, he, dev) -> dict:
    """Kernels 1 and 2 on the NGP geometry (3 dense levels x F = 8,
    2,224,303 rows; every level global in kernel 2's plan, the corners split
    4 ways) at a training batch (N = 10,000) and a grid chunk (N = 131,072),
    x in [0, 1] and in [-1, 1], a table drawn U(-1, 1); returns per-kernel
    rows."""
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(8)
    enc = HashGridEncoding(dim=3, **{k: NGP[k] for k in ("n_levels", "n_features_per_level", "log2_hashmap_size",
                                                         "base_resolution", "finest_resolution", "growth")})
    table = (torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1).to(dev)
    log(f"[kernels] ngp: {enc.total_size:,d} rows x F={enc.n_features_per_level}, dense {enc.level_dense.tolist()}, "
        f"plan at N=10,000 {he.table_grad_plan(enc, 10_000)}")
    rows = {"hash_encode_forward": [], "hash_encode_table_grad": []}
    for n, what in ((10_000, "train batch"), (1 << 17, "grid chunk")):
        for lo in (0.0, -1.0):
            x = torch.rand((n, 3), generator=gen) * (1.0 - lo) + lo
            x[0], x[1] = lo, 1.0
            g = torch.randn((n, enc.output_dim), generator=gen)
            label = f"{what}, x in [{lo:g}, 1]"
            for name, row in encoder_rows(torch, he, enc, table, x.to(dev), g.to(dev), label, "ngp").items():
                rows[name].append(row)
    return rows


def check_slice_hash_kernels(torch, he, dev) -> dict:
    """Kernels 1 and 2 on the held-out-frame paths' encoders, a table drawn
    U(-1, 1): hash_siren's (10 levels x F = 2, 921,464 rows, levels 0-3
    dense) at its training batch, N = 20,000, and at its grid chunk, N =
    131,072 (hash_siren has no encode/decode split, so its grid launches
    kernel 1 per chunk), both with x in [-1, 1] (the clamped coordinates
    ``--zero_centered`` sends), and the temporal protocol's (4 dense levels
    x F = 4, 2,252,886 rows) at N = 10,000, x in [0, 1]; returns per-kernel
    rows."""
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(11)
    rows = {"hash_encode_forward": [], "hash_encode_table_grad": []}
    hash_siren, protocol = HashGridEncoding(**HASH_SIREN), HashGridEncoding(dim=3, **PROTOCOL)
    tables = {}
    for geometry, enc, n, lo, what in (("hash_siren", hash_siren, 20_000, -1.0, "train batch"),
                                       ("hash_siren", hash_siren, 1 << 17, -1.0, "grid chunk"),
                                       ("protocol", protocol, 10_000, 0.0, "train batch")):
        log(f"[kernels] {geometry}: {enc.total_size:,d} rows x F={enc.n_features_per_level}, dense "
            f"{enc.level_dense.tolist()}, plan at N={n:,d} {he.table_grad_plan(enc, n)}")
        if geometry not in tables:
            tables[geometry] = (torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1).to(dev)
        x = torch.rand((n, 3), generator=gen) * (1.0 - lo) + lo
        x[0], x[1] = lo, 1.0
        g = torch.randn((n, enc.output_dim), generator=gen)
        label = f"{what}, x in [{lo:g}, 1]"
        for name, row in encoder_rows(torch, he, enc, tables[geometry], x.to(dev), g.to(dev), label,
                                      geometry).items():
            rows[name].append(row)
    return rows


def check_warp_hash_kernels(torch, he, dev):
    """Kernels 1 and 2 on the warp INR's canonical encoder (2-D, 4 dense
    levels x F = 4, 181,603 rows), a table drawn U(-1, 1), at a training
    batch (N = 10,000) and a grid chunk (N = 131,072), x = clip(u + 0.05 n,
    0, 1) with u uniform and n normal: the warped points, a few percent on
    the bounds. Beside them the coordinate gradient (plain torch,
    ``he.hash_encode_coord_grad``) on the card against the same function on
    the CPU (atol 1e-5 of the largest value), with its device time (all the
    kernels it launches, profiler) and its time per call. Returns
    (per-kernel rows, coordinate-gradient rows)."""
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(12)
    enc = HashGridEncoding(**WARP_GEOMETRY)
    table = torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1
    table_d = table.to(dev)
    log(f"[kernels] warp: {enc.total_size:,d} rows x F={enc.n_features_per_level}, dense {enc.level_dense.tolist()}, "
        f"cell-view {enc.level_cellview.tolist()}, plan at N=10,000 {he.table_grad_plan(enc, 10_000)}")
    rows = {"hash_encode_forward": [], "hash_encode_table_grad": []}
    coord = []
    for n, what in ((10_000, "train batch"), (1 << 17, "grid chunk")):
        x = torch.clamp(torch.rand((n, 2), generator=gen) + 0.05 * torch.randn((n, 2), generator=gen), 0.0, 1.0)
        g = torch.randn((n, enc.output_dim), generator=gen)
        on_bounds = float(((x == 0) | (x == 1)).float().mean())
        label = f"{what}, x = clip(u + 0.05 n, 0, 1)"
        xd, gd = x.to(dev), g.to(dev)
        for name, row in encoder_rows(torch, he, enc, table_d, xd, gd, label, "warp").items():
            rows[name].append({**row, "share_on_bounds": on_bounds})
        got = he.hash_encode_coord_grad(enc, table_d, xd, gd)
        t0 = time.perf_counter()
        want = he.hash_encode_coord_grad(enc, table, x, g)
        plain_s = time.perf_counter() - t0
        err, tol = float((got.cpu() - want).abs().max()), 1e-5 * float(want.abs().max())
        if not math.isfinite(err) or err > tol:
            fail(f"hash_encode_coord_grad warp {what}: max abs err {err} > {tol}")
        call = lambda: he.hash_encode_coord_grad(enc, table_d, xd, gd)  # noqa: E731
        kernels, _ = profile_device(call, 20)
        row = {"n": n, "what": label, "share_on_bounds": on_bounds, "max_abs_err": err, "tolerance": tol,
               "device_ms": sum(ms for ms, _ in kernels.values()) / 20,
               "launches_per_call": sum(k for _, k in kernels.values()) / 20, "call_ms": time_ms(call),
               "cpu_ms": plain_s * 1e3}
        coord.append(row)
        log(f"  coord_grad warp N={n:>7,d} ({what}, {100 * on_bounds:.2f}% of coordinates on the bounds): err "
            f"{err:.3e} (tol {tol:.3e})  device {row['device_ms']:.4f} ms in {row['launches_per_call']:.0f} "
            f"launches  per call {row['call_ms']:.4f} ms  CPU {row['cpu_ms']:.2f} ms")
    return rows, coord


def check_coarse_kernels(torch, he, dev):
    """Kernels 3 and 4 against their plain versions on three geometries: the
    multi-frame HashMLP's levels 0-3 at one 352 x 352 frame (the main row;
    x uniform, then the frame in raster order), the kernel bench's and the
    JAX tests'; ragged N and x in [-1, 1]. Beside each frame, kernels 1 and 2
    on the same four levels (the same function: kernel 1 held to kernel 3's
    output, kernel 2 to kernel 4's within the per-entry bound), with the
    times side by side, and beside the uniform frame kernels 1-2 on the whole
    10-level encoder, x uniform and in raster order. Returns per-kernel
    rows."""
    from mri_interpolation_tpu_torch.bench_kernels import bench_geometry
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(4)
    geom_multi = dict(dim=2, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                      finest_resolution=None, per_level_scale=1.4)
    multi = HashGridEncoding(n_levels=10, **geom_multi)
    multi4 = HashGridEncoding(n_levels=4, **geom_multi)  # levels 0-3 of `multi`, alone
    paper = HashGridEncoding(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=11,
                             base_resolution=(3, 3, 2), finest_resolution=(11, 11, 6), growth="paper")
    xs = torch.linspace(0, 1, FRAME[0])
    raster = torch.stack(torch.meshgrid(xs, xs, indexing="ij"), dim=-1).reshape(-1, 2)
    cases = [  # (geometry, encoder, N, x's lower end, what)
        ("multi_frame", multi, FRAME[0] * FRAME[1], 0.0, "one 352x352 frame"),
        ("multi_frame", multi, FRAME[0] * FRAME[1], 0.0, "one 352x352 frame, raster order"),
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
        x = (raster if "raster" in what else x).to(dev)
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
                "plan": he._card_coarse_grad_plan(enc, levels, n, x.device)._asdict(),
                "plain_ms": time_ms(lambda: he.hash_encode_coarse_table_grad_reference(enc, x, g), iters=5),
                "bound_ms": gb, "bound_by": gk,
                "library_ms": kernel_ms(lambda: zeros.index_add_(0, flat_ids, contrib), "")}
        rows["hash_encode_coarse_table_grad"].append(grow)
        log(f"  coarse table_grad {geom:11s} N={n:>7,d} ({what}): err {err:.3e} (bound >= 1e-5)  kernel {grow['ms']} ms"
            f"  per call {grow['call_ms']:.4f} ms  plain {grow['plain_ms']:.4f} ms  index_add_ {grow['library_ms']} ms"
            f"  bound {gb:.5f} ms ({gk})")

        if geom == "multi_frame" and n == FRAME[0] * FRAME[1]:
            # kernels 1-2 on the same levels: the same function
            t4 = table[:multi4.total_size]
            same = he.hash_encode_forward(multi4, t4, x)
            same_grad = he.hash_encode_table_grad(multi4, x, g)
            torch.cuda.synchronize()
            e1 = float((same - out).abs().max())
            if e1 > FWD_ATOL:
                fail(f"kernel 1 on levels 0-3 ({what}) differs from kernel 3 by {e1}")
            e2 = float(((same_grad - dt[:multi4.total_size]).abs()
                        - he.atomic_sum_bound(abs_sum[:multi4.total_size])).max())
            if e2 > 0.0:
                fail(f"kernel 2 on levels 0-3 ({what}) differs from kernel 4 by {e2} over the per-row bound")
            beside = [("levels 0-3" + (", raster order" if "raster" in what else ""), multi4, t4, x, g)]
            if "raster" not in what:  # the whole encoder, x uniform and in raster order
                g_all = torch.randn((n, multi.output_dim), generator=gen).to(dev)
                beside += [("all 10 levels", multi, table, x, g_all),
                           ("all 10 levels, raster order", multi, table, raster.to(dev), g_all)]
            for what_b, enc_b, t_b, x_b, g_b in beside:
                for name, row in encoder_rows(torch, he, enc_b, t_b, x_b, g_b, what_b).items():
                    rows.setdefault(name, []).append(row)
            k1, k2 = rows["hash_encode_forward"][-len(beside)], rows["hash_encode_table_grad"][-len(beside)]
            frow["beside"] = {"kernel1_equals_kernel3": bool(torch.equal(same, out)), "kernel1_ms": k1["ms"],
                              "kernel2_ms": k2["ms"]}
            grow["beside"] = {"kernel2_ms": k2["ms"]}
            log(f"  beside, N={n:,d} ({what}), levels 0-3: kernel 3 {frow['ms'] * 1e3:.2f} us, kernel 1 "
                f"{k1['ms'] * 1e3:.2f} us (bitwise equal: {frow['beside']['kernel1_equals_kernel3']}); kernel 4 "
                f"{grow['ms'] * 1e3:.2f} us, kernel 2 {k2['ms'] * 1e3:.2f} us")
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
    from mri_interpolation_tpu_torch.models.core import dense_init

    gen = torch.Generator(device="cpu").manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    multi_siren = make_multi_siren(**{**MULTI_SIREN, "n_frames": 1}, device=dev)
    multi_hash = make_multi_hash_mlp(**{**MULTI_HASH, "n_frames": 1}, device=dev)
    siren_a = make_siren(3, dim_hidden=128, n_layers=6, device=dev).params
    siren_352 = make_siren(3, dim_hidden=352, n_layers=5, device=dev).params
    tcnn = make_hash_mlp(3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                         per_level_scale=1.4, dim_hidden=128, n_layers=2, decoder="relu_plain", device=dev)
    gelu_layers = [{"w": (torch.rand((k, n), generator=gen) - 0.5).to(dev) / 4,
                    "b": (torch.rand((n,), generator=gen) - 0.5).to(dev) / 4} for k, n in ((16, 64), (64, 64), (64, 2))]
    ngp_layers = [{k: v.to(dev) for k, v in dense_init(k, n, gen).items()} for k, n in ((24, 64), (64, 1))]
    protocol_layers = [{k: v.to(dev) for k, v in dense_init(k, n, gen).items()} for k, n in ((16, 64), (64, 1))]
    wide_layers = [{"w": (torch.rand((k, n), generator=gen) - 0.5).to(dev) / math.sqrt(k),
                    "b": (torch.rand((n,), generator=gen) - 0.5).to(dev) / math.sqrt(k)} for k, n in ((8, 832), (832, 3))]

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
        ("B grid chunk", [l.params for l in tcnn.layers], fm.mlp_acts(1, "relu"), 1 << 17, -0.5, False, False),
        ("gelu small", gelu_layers, fm.mlp_acts(2, "gelu"), 1000, -1.0, True, True),
        # the widest stack the kernels take: route 2 throughout, 32-row blocks, a dot product for N = 3
        ("relu 8-832-3", wide_layers, fm.mlp_acts(1, "relu"), 4099, -1.0, False, False),
        # the multi-frame paths' stacks at one 352 x 352 frame
        ("multi_siren enc", *siren_stack(multi_siren.encoders.params(0), 4), FRAME[0] * FRAME[1], -1.0, True, False),
        ("multi_siren dec", *siren_stack(multi_siren.decoder.params(), 4), FRAME[0] * FRAME[1], -1.0, True, True),
        ("multi_hash dec", [l.params for l in multi_hash.decoder], fm.mlp_acts(1, "relu"), FRAME[0] * FRAME[1], -1.0,
         True, True),
        # the NGP HashMLP's relu 24-64-1 decoder (kernel 2's dx feeds it the table gradient)
        ("ngp train step", ngp_layers, fm.mlp_acts(1, "relu"), 10_000, -1.0, True, True),
        ("ngp grid chunk", ngp_layers, fm.mlp_acts(1, "relu"), 1 << 17, -1.0, False, False),
        # the temporal protocol's relu 16-64-1 decoder: its training step (dx into kernel 2) and a grid chunk
        ("protocol step", protocol_layers, fm.mlp_acts(1, "relu"), 10_000, -1.0, True, True),
        ("protocol grid chunk", protocol_layers, fm.mlp_acts(1, "relu"), 1 << 17, -1.0, False, False),
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
                   "plan": fm.forward_plan(dims, acts, n, sms)._asdict(),
                   # the split prologue (route-1 layers) and the forward kernel of one call
                   **kernel_times(call, "fused_mlp_", per_call=True),
                   "plain_ms": time_ms(lambda: fm.mlp_forward_reference(ws, bs, x, acts), iters=5),
                   "bound_ms": fb, "bound_by": fk, "bound_tc_ms": tensor_core_bound_ms(dims, n, False, False),
                   "library_ms": None}
            rows["fused_mlp_forward"].append(row)
            log(f"  mlp forward  {what:15s} dims {dims[0]}-{dims[1]}x{len(dims) - 2}-{dims[-1]} N={n:>7,d} "
                f"routes {row['plan']['routes']} rows {row['plan']['rows']}: "
                f"err {err:.3e}  kernel {row['ms']} ms ({row['ms_source']})  per call {row['call_ms']:.4f} ms  "
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


def check_grid_frames(torch, he, fm, dev):
    """What ``evaluate_grid(model, (352, 352), frame_idx=t)`` launches for
    one frame of the multi-frame paths, forward only, against the plain
    versions: kernel 1 on the multi-frame encoder (a table drawn U(-1, 1)) at
    the frame's coordinates, kernel 5 on multi_hash's decoder at that
    encoding, and kernel 5 on multi_siren's encoder at the frame's
    coordinates in [-1, 1] and on its decoder at the encoder's output.
    Returns per-kernel rows."""
    from mri_interpolation_tpu_torch.infer import flat_index_to_coords
    from mri_interpolation_tpu_torch.models import make_multi_hash_mlp, make_multi_siren

    gen = torch.Generator(device="cpu").manual_seed(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = FRAME[0] * FRAME[1]
    flat = torch.arange(n, device=dev)
    mh = make_multi_hash_mlp(**{**MULTI_HASH, "n_frames": 1}, device=dev)
    msn = make_multi_siren(**{**MULTI_SIREN, "n_frames": 1}, device=dev)
    enc = mh.geometry
    table = (torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1).to(dev)
    x01, x11 = flat_index_to_coords(flat, FRAME), flat_index_to_coords(flat, FRAME, -1.0, 1.0)
    rows = {"hash_encode_forward": [], "fused_mlp_forward": []}
    with torch.no_grad():
        feats = he.hash_encode_forward(enc, table, x01)
        ref = he.hash_encode_reference(enc, table, x01)
        torch.cuda.synchronize()
        err, tol = float((feats - ref).abs().max()), FWD_ATOL * max(1.0, float(ref.abs().max()))
        if not math.isfinite(err) or err > tol:
            fail(f"hash_encode_forward grid frame: max abs err {err} > {tol}")
        ids, _ = enc.corner_ids_and_weights(x01)
        d, L, F = enc.input_dim, enc.n_levels, enc.n_features_per_level
        fb, fk = bound_ms(4.0 * (n * d + int(torch.unique(ids).numel()) * F + n * L * F),
                          n * L * flops_per_point_level(d, F, grad=False))
        row = {"geometry": "multi_frame", "n": n, "what": "grid frame (evaluate_grid)", "max_abs_err": err,
               "tolerance": tol, **kernel_times(lambda: he.hash_encode_forward(enc, table, x01),
                                                "hash_encode_forward_kernel"),
               "plain_ms": time_ms(lambda: he.hash_encode_reference(enc, table, x01), iters=5),
               "bound_ms": fb, "bound_by": fk, "library_ms": None}
        rows["hash_encode_forward"].append(row)
        log(f"  forward    multi_frame N={n:>7,d} (grid frame): err {err:.3e}  kernel {row['ms']} ms "
            f"({row['ms_source']})  plain {row['plain_ms']:.4f} ms  bound {fb:.5f} ms ({fk})")

        def siren(params):
            layers = params["layers"] + [params["last"]]
            return [l["w"] for l in layers], [l["b"] for l in layers], fm.siren_acts(4, 30.0, 30.0)

        enc_ws, enc_bs, sacts = siren(msn.encoders.params(0))
        dec_ws, dec_bs, _ = siren(msn.decoder.params())
        z = fm.mlp_forward(enc_ws, enc_bs, x11, sacts)
        stacks = [("multi_hash dec grid frame", [l.params["w"] for l in mh.decoder], [l.params["b"] for l in mh.decoder],
                   fm.mlp_acts(1, "relu"), feats, MLP_SHARE),
                  ("multi_siren enc grid frame", enc_ws, enc_bs, sacts, x11, MLP_SINE_SHARE),
                  ("multi_siren dec grid frame", dec_ws, dec_bs, sacts, z, MLP_SINE_SHARE)]
        for what, ws, bs, acts, x, share in stacks:
            dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
            y = fm.mlp_forward(ws, bs, x, acts)
            ref = fm.mlp_forward_reference(ws, bs, x, acts)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            if not math.isfinite(err) or err > share * float(ref.abs().max()):
                fail(f"fused_mlp_forward {what}: max abs err {err} > {share} x {float(ref.abs().max())}")
            fb, fk = bound_ms(*mlp_work(dims, n, False, False))
            row = {"what": what, "dims": dims, "n": n, "max_abs_err": err, "tolerance_share": share,
                   "plan": fm.forward_plan(dims, acts, n, sms)._asdict(),
                   **kernel_times(lambda: fm.mlp_forward(ws, bs, x, acts), "fused_mlp_", per_call=True),
                   "plain_ms": time_ms(lambda: fm.mlp_forward_reference(ws, bs, x, acts), iters=5),
                   "bound_ms": fb, "bound_by": fk, "bound_tc_ms": tensor_core_bound_ms(dims, n, False, False),
                   "library_ms": None}
            rows["fused_mlp_forward"].append(row)
            log(f"  mlp forward  {what:26s} N={n:>7,d} routes {row['plan']['routes']}: err {err:.3e}  "
                f"kernel {row['ms']} ms ({row['ms_source']})  plain {row['plain_ms']:.4f} ms  "
                f"bound {fb:.5f} ms ({fk}), 3xTF32 {row['bound_tc_ms']:.5f} ms")
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
    # each kernel alone, 200 launches: medians and spread; an empty kernel's is a launch alone
    probe_stats = launch_stats(lambda: pr.probe(x), "probe_double_kernel")
    mul_stats = launch_stats(lambda: torch.mul(x, 2.0), "")
    empty_stats = launch_stats(lambda: pr.launch_empty(dev), "probe_empty_kernel")
    return {"what": "build check", "n": n, "max_abs_err": 0.0,
            **kernel_times(lambda: pr.probe(x), "probe_double_kernel"),
            "plain_ms": time_ms(lambda: pr.probe_reference(x)), "bound_ms": pb, "bound_by": pk,
            "library_ms": kernel_ms(lambda: torch.mul(x, 2.0), ""),
            # the least a launched kernel takes: the larger of the byte bound and an empty launch
            "launch_floor_ms": max(pb, empty_stats["median_us"] * 1e-3),
            "launch_stats": {"probe": probe_stats, "torch_mul": mul_stats, "empty_kernel": empty_stats,
                             "probe_slower_beyond_spread": bool(probe_stats["p25_us"] > mul_stats["p75_us"]),
                             "probe_above_empty_beyond_spread": bool(probe_stats["p25_us"] > empty_stats["p75_us"])}}


def small_fit_setup(torch, make_model, zero_centered: bool = False):
    """A (16, 16, 8) volume and one init of ``make_model``; a hash table is
    redrawn U(-0.5, 0.5): at the factory's 1e-4 table scale BatchNorm cancels
    nearly equal numbers and the curves of any two summation orders drift
    apart by ~3e-4 (tests/test_torch_trainer.py)."""
    from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume

    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=3), zero_centered=zero_centered)
    state = make_model("cpu").state_dict()
    if "encoder.table" in state:
        state["encoder.table"] = torch.empty(state["encoder.table"].shape).uniform_(
            -0.5, 0.5, generator=torch.Generator().manual_seed(6))
    return ds, state


def small_fit(make_model, cfg, dev, ds, state, freeze_mask_fn=None):
    """Trainer.fit of a model loaded with ``state`` on ``dev``: (model, losses)."""
    from mri_interpolation_tpu_torch.train import Trainer

    model = make_model(dev)
    model.load_state_dict(state)
    return model, Trainer(cfg, freeze_mask_fn=freeze_mask_fn).fit(model, ds.coords, ds.values, device=dev).losses


def curves_match(name: str, losses, ref) -> float:
    """Ten finite losses, within rtol FIT_RTOL of ``ref``'s; returns the
    largest relative difference."""
    if len(ref) != 10 or not np.all(np.isfinite(losses)):
        fail(f"small fit {name}: {len(ref)} steps, losses {losses}")
    rel = float(np.max(np.abs(losses - ref) / np.abs(ref)))
    if rel > FIT_RTOL:
        fail(f"small fit {name}: the two loss curves differ by {rel} > rtol {FIT_RTOL}")
    return rel


def small_fit_matches_cpu(torch, name: str, make_model, cfg, zero_centered: bool = False,
                          freeze_mask_fn=None) -> float:
    """Ten steps of Trainer.fit on the small volume, card vs CPU, from one
    init (``small_fit_setup``); returns the largest relative difference of
    the loss curves."""
    ds, state = small_fit_setup(torch, make_model, zero_centered)
    card = small_fit(make_model, cfg, "cuda", ds, state, freeze_mask_fn)[1]
    return curves_match(name, card, small_fit(make_model, cfg, "cpu", ds, state, freeze_mask_fn)[1])


def remat_matches_plain(torch, make_model, base: dict) -> float:
    """Ten steps with remat and without, both on the card, from one init:
    the loss curves, the BatchNorm statistics (rtol FIT_RTOL: kernel 2's
    atomics sum in another order in each run) and the anneal counter
    (exactly 10 in both). The BatchNorm-fed biases are frozen: their true
    gradient is zero, so Adam moves them by float noise, differently in each
    run, and the running means track them. Returns the loss curves' largest
    relative difference."""
    from mri_interpolation_tpu_torch.train import TrainConfig

    ds, state = small_fit_setup(torch, make_model)
    freeze = lambda named: {k: not (k.startswith("layers.") and k.endswith(".b")) for k in named}  # noqa: E731
    remat, remat_losses = small_fit(make_model, TrainConfig(**base, remat=True), "cuda", ds, state, freeze)
    plain, plain_losses = small_fit(make_model, TrainConfig(**base), "cuda", ds, state, freeze)
    rel = curves_match("flagship remat vs plain (card)", remat_losses, plain_losses)
    plain_state = plain.state_dict()
    for key, a in remat.state_dict().items():
        b = plain_state[key]
        if key == "anneal_step":
            if int(a) != 10 or int(b) != 10:
                fail(f"flagship remat: anneal counter {int(a)} (remat) and {int(b)} (plain) after 10 steps")
        elif key.startswith("bn.") and not torch.allclose(a, b, rtol=FIT_RTOL, atol=1e-6):
            fail(f"flagship remat: BatchNorm {key} differs from the fit without remat by {float((a - b).abs().max())}")
    return rel


def small_fits(torch) -> dict:
    from mri_interpolation_tpu_torch.models import (make_hash_mlp, make_hash_siren, make_modulated_siren,
                                                    make_psf_siren, make_siren)
    from mri_interpolation_tpu_torch.train import TrainConfig

    siren_cfg = TrainConfig(batch_size=200, epochs=1, lr=1e-4, shuffle=False)
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
        # the SIREN family: plain tensor code, and kernels 1-2 for hash_siren's encoder (coordinates in [0, 1]:
        # the clamped extrapolation of [-1, 1] with a U(-0.5, 0.5) table leaves the curves ill-conditioned)
        "modulated_siren": small_fit_matches_cpu(
            torch, "modulated_siren", lambda d: make_modulated_siren(3, dim_hidden=64, n_layers=3, device=d, seed=5),
            siren_cfg, zero_centered=True),
        "hash_siren": small_fit_matches_cpu(
            torch, "hash_siren", lambda d: make_hash_siren(3, dim_hidden=32, n_layers=3, n_levels=6,
                                                           log2_hashmap_size=12, base_resolution=4,
                                                           per_level_scale=1.5, device=d, seed=5), siren_cfg),
        "psf_siren": small_fit_matches_cpu(
            torch, "psf_siren", lambda d: make_psf_siren(3, dim_hidden=64, n_layers=3, n_sample=3, device=d, seed=5,
                                                         coordinates_spacing=(0.5 / 15, 0.5 / 15, 0.5 / 7)),
            siren_cfg, zero_centered=True),
    }


def small_option_fits(torch) -> dict:
    """The trainer's and HashMLP's options, 10 steps each, card vs CPU: the
    relu_plain HashMLP with adam_tcnn, cosine and accumulation over 3
    mini-steps; the flagship with its decoder frozen and weight decay 1e-3;
    with a 5-step level anneal and the temporal TV; and with remat and the
    anneal, held to the CPU, and to the card's fit without remat
    (``remat_matches_plain``). Returns the largest relative differences."""
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import TrainConfig

    flagship = dict(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, seed=5)
    tcnn = dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4, per_level_scale=1.5,
                dim_hidden=64, n_layers=2, decoder="relu_plain", seed=5)
    base = dict(batch_size=200, epochs=1, shuffle=False)
    rels = {
        "relu_plain cosine k3": small_fit_matches_cpu(
            torch, "relu_plain cosine k3", lambda d: make_hash_mlp(3, device=d, **tcnn),
            TrainConfig(**base, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=1,
                        accumulate_grad_batches=3)),
        "flagship frozen wd": small_fit_matches_cpu(
            torch, "flagship frozen wd", lambda d: make_hash_mlp(3, device=d, **flagship),
            TrainConfig(**base, weight_decay=1e-3), freeze_mask_fn=lambda named: {
                k: k.startswith("encoder.") for k in named}),
        "flagship anneal tv": small_fit_matches_cpu(
            torch, "flagship anneal tv",
            lambda d: make_hash_mlp(3, device=d, level_anneal_steps=5, temporal_tv=0.1, **flagship),
            TrainConfig(**base)),
    }
    make = lambda d: make_hash_mlp(3, device=d, level_anneal_steps=5, **flagship)  # noqa: E731
    rels["flagship remat"] = small_fit_matches_cpu(torch, "flagship remat", make, TrainConfig(**base, remat=True))
    rels["flagship remat vs plain (card)"] = remat_matches_plain(torch, make, base)
    return rels


def small_zoo_fits(torch) -> dict:
    """The rest of the zoo, 10 steps each, card vs CPU: BaseMLP, RffNet,
    the real GaborNet (zero-centred), FreqMLP with the siren encoder and a
    skip before block 2 and with the rff encoder (weight decay 1e-5), and
    the warp INR with the residual, warp_accel, warp_smooth (the exact jvp)
    and a 5-step level anneal (its encoder on kernels 1-2, its warped points
    on the coordinate gradient; at init every point on a bound sits on the
    clip's tie). Returns the largest relative differences."""
    from mri_interpolation_tpu_torch.models import make_freq_mlp, make_gabor_net, make_mlp, make_rff_net, make_warp_inr
    from mri_interpolation_tpu_torch.train import TrainConfig

    base = dict(batch_size=200, epochs=1, shuffle=False)
    freq = dict(dim_hidden=32, n_layers=3, n_frequencies=32, n_frequencies_t=8, seed=5)
    warp = dict(n_levels=3, n_features_per_level=4, base_resolution=(4, 4), finest_resolution=(16, 16),
                dim_hidden=16, warp_hidden=16, residual_scale=0.05, warp_accel=1.0, warp_smooth=0.1,
                level_anneal_steps=5, seed=5)
    return {
        "mlp": small_fit_matches_cpu(torch, "mlp", lambda d: make_mlp(3, 64, n_layers=4, device=d, seed=5),
                                     TrainConfig(**base, lr=1e-3)),
        "rff_net": small_fit_matches_cpu(
            torch, "rff_net", lambda d: make_rff_net(3, 64, n_layers=3, n_frequencies=32, device=d, seed=5),
            TrainConfig(**base, lr=1e-3)),
        "gabor": small_fit_matches_cpu(torch, "gabor", lambda d: make_gabor_net(3, 32, n_layers=3, device=d, seed=5),
                                       TrainConfig(**base, lr=3e-4), zero_centered=True),
        "freq_mlp siren skip": small_fit_matches_cpu(
            torch, "freq_mlp siren skip",
            lambda d: make_freq_mlp(3, skip_connections=(2,), encoder_type="siren", device=d, **freq),
            TrainConfig(**base, lr=1e-3, weight_decay=1e-5)),
        "freq_mlp rff": small_fit_matches_cpu(
            torch, "freq_mlp rff", lambda d: make_freq_mlp(3, encoder_type="rff", device=d, **freq),
            TrainConfig(**base, lr=1e-3, weight_decay=1e-5)),
        "warp_inr": small_fit_matches_cpu(torch, "warp_inr", lambda d: make_warp_inr(3, device=d, **warp),
                                          TrainConfig(**base, lr=1e-2, optimizer="adam_tcnn")),
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
    # the options fit_frames takes: cosine over 2 epochs of frames, accumulation over 2 frames
    models["multi_hash_mlp cosine k2"] = (models["multi_hash_mlp"][0], TrainConfig(
        epochs=2, lr=5e-3, weight_decay=1e-5, lr_schedule="cosine", cosine_t_max=2, accumulate_grad_batches=2),
        coords, values)
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
    train_s, hook_s = summary["train_wall_s"], summary["train_hook_s"]  # the whole fit, epoch hooks included
    grid_s = summary["interp_eval_s"][str(GRID)]
    out = {"run_dir": run_dir, "steps": steps, "train_wall_s": train_s, "train_hook_s": hook_s,
           "steps_per_s": steps / train_s, "train_voxel_evals_per_s": steps * batch / train_s,
           # per layer: the trainer's loop alone, the hooks' scalars, eval and checkpoints apart
           "steps_per_s_without_hooks": steps / (train_s - hook_s), "recon_eval_s": summary["recon_eval_s"],
           "grid_eval_s": grid_s, "grid_voxels_per_s": float(np.prod(GRID)) / grid_s, "psnr": summary["psnr"],
           "ssim": summary["ssim"], "final_loss": summary["final_loss"], "wall_s": seconds, "launches": launches,
           "train_voxels": summary["train_voxels"],
           **{k: v for k, v in summary.items() if k.startswith("odd_") or k == "coordinates_spacing"}}
    log(f"[{name}] {kind}: {steps} steps in {train_s:.3f} s = {out['steps_per_s']:.1f} steps/s, "
        f"{out['train_voxel_evals_per_s']:,.0f} training voxel-evals/s; epoch hooks {hook_s:.3f} s of it "
        f"({out['steps_per_s_without_hooks']:.1f} steps/s without them)")
    log(f"[{name}] {kind}: {GRID} grid of {int(np.prod(GRID)):,d} voxels in {grid_s:.3f} s = "
        f"{out['grid_voxels_per_s']:,.0f} voxels/s; reconstruction {summary['recon_eval_s']:.3f} s")
    log(f"[{name}] PSNR {summary['psnr']:.3f} dB, SSIM {summary['ssim']:.4f}, final loss "
        f"{summary['final_loss']:.5f}; launches {launches}; {seconds:.1f} s")
    return out


def ngp_geometry():
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    keys = ("n_levels", "n_features_per_level", "log2_hashmap_size", "base_resolution", "finest_resolution", "growth")
    return HashGridEncoding(dim=3, **{k: NGP[k] for k in keys})


def check_ngp_run(out: dict) -> None:
    """ngp's scalars (370 train_loss and 2 finite psnr records), its epoch
    checkpoints, and the optimizer state that the first epoch's checkpoint
    holds: after 185 inner updates, Adam's count 185 and the rate of update
    184, the cosine's closed form with D = 370 (the final checkpoint, as in
    the JAX launcher, holds the model alone)."""
    from mri_interpolation_tpu_torch.train import read_scalars, restore_checkpoint

    recs = read_scalars(os.path.join(out["run_dir"], "scalars.jsonl"))
    losses = [r["value"] for r in recs if r["tag"] == "train_loss"]
    psnr = [r["value"] for r in recs if r["tag"] == "psnr"]
    if len(losses) != 2 * NGP_STEPS or len(psnr) != 2 or not np.all(np.isfinite(losses + psnr)):
        fail(f"ngp: {len(losses)} train_loss and {len(psnr)} psnr records ({psnr})")
    ckpt_dir = os.path.join(out["run_dir"], "checkpoints")
    ckpts = sorted(os.listdir(ckpt_dir))
    if ckpts != sorted([f"step_{NGP_STEPS}.pt", f"step_{2 * NGP_STEPS}.pt"]):
        fail(f"ngp: checkpoints {ckpts}")
    opt = restore_checkpoint(ckpt_dir, NGP_STEPS)["optimizer"]
    decay = 2 * NGP_STEPS
    want = 1e-2 * 0.5 * (1.0 + math.cos(math.pi * (NGP_STEPS - 1) / decay))
    got = opt["adam"]["param_groups"][0]["lr"]
    adam_steps = {int(st["step"]) for st in opt["adam"]["state"].values()}
    if not math.isclose(got, want, rel_tol=1e-12) or adam_steps != {NGP_STEPS} or opt["updates"] != NGP_STEPS:
        fail(f"ngp: step_{NGP_STEPS}.pt: rate {got} (closed form {want}), Adam steps {adam_steps}, "
             f"{opt['updates']} updates")
    from mri_interpolation_tpu_torch.train.tb_events import read_event_file

    tb = os.path.join(out["run_dir"], "tb")
    (event_file,) = os.listdir(tb)
    events = list(read_event_file(os.path.join(tb, event_file)))[1:]
    if ([(e["step"], e["scalars"][0][0]) for e in events] != [(r["step"], r["tag"]) for r in recs]
            or not np.array_equal([e["scalars"][0][1] for e in events], np.float32([r["value"] for r in recs]))):
        fail(f"ngp: the TensorBoard event file ({len(events)} scalars) differs from scalars.jsonl ({len(recs)})")
    log(f"[ngp] tb/{event_file}: {len(events)} scalar events, equal to scalars.jsonl")
    out.update(eval_psnr=psnr, lr_at_update_184=got, first_loss=losses[0], last_losses=losses[-10:])
    log(f"[ngp] eval PSNR by epoch {psnr}; step_{NGP_STEPS}.pt: rate of update {NGP_STEPS - 1} {got:.6e} = closed "
        f"form {want:.6e}, Adam count {NGP_STEPS}; checkpoints {ckpts}")


def check_ngp_resume(out: dict, ngp: dict, ngp_ckpt: str) -> None:
    """The resumed fit starts where ngp ended, not from an init: its first
    loss is below a tenth of ngp's first and at most 3x ngp's last ten plus
    the temporal TV term of the restored table."""
    from mri_interpolation_tpu_torch.encodings.hashgrid import temporal_table_tv
    from mri_interpolation_tpu_torch.train import read_scalars, restore_checkpoint

    first = read_scalars(os.path.join(out["run_dir"], "scalars.jsonl"), "train_loss")[0]["value"]
    table = restore_checkpoint(ngp_ckpt)["model"]["encoder.table"]
    tv_term = 1e-3 * float(temporal_table_tv(ngp_geometry(), table))
    if not (first < 0.1 * ngp["first_loss"] and first <= 3 * max(ngp["last_losses"]) + tv_term):
        fail(f"ngp_resume: first loss {first}; ngp began at {ngp['first_loss']} and ended at {ngp['last_losses']}, "
             f"TV term {tv_term}")
    out.update(first_loss=first, tv_term=tv_term)
    log(f"[ngp_resume] first loss {first:.6f}: ngp began at {ngp['first_loss']:.6f}, ended at "
        f"{ngp['last_losses'][-1]:.6f}; TV term of the restored table {tv_term:.3e}")


def drive_ngp_paths(path: str, tmp: str, zero: dict, paths: dict) -> None:
    """Phase 5's paths of the trainer's options, each with the counters at 0
    just before it and read just after: ngp, ngp_resume (from ngp's
    checkpoints) and flagship_anneal (whose launches must equal
    ``paths["flagship"]``'s), on the volume at ``path``."""
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.configs import RunConfig
    from mri_interpolation_tpu_torch.train import restore_checkpoint

    grid = ["--image_path", path, "--interp_shapes", str(GRID)]
    # NGP paper+cosine: 2 epochs, the cosine over both; per epoch one eval forward of 103,254 voxels; its
    # all-dense encoder takes the separable grid path (no kernel 1 on the grids, kernel 5 on every chunk)
    paths["ngp"] = drive_path(
        "ngp", "launcher.main, NGP 3-level F=8 paper+cosine",
        lambda: cli(launcher, [*NGP_FLAGS, "--lr_schedule", "cosine", "--cosine_t_max", "2", "--epochs", "2",
                               "--eval_every_epochs", "1", "--checkpoint_every_epochs", "1", "--tb_events", "true",
                               "--output_root", os.path.join(tmp, "ngp"), *grid]),
        2 * NGP_STEPS, 10_000, {**zero, "hash_encode_forward": 2 * NGP_STEPS + 2,
                                "hash_encode_table_grad": 2 * NGP_STEPS,
                                "fused_mlp_forward": 2 * NGP_STEPS + 2 + CHUNKS,
                                "fused_mlp_backward": 2 * NGP_STEPS, "probe": 1})
    check_ngp_run(paths["ngp"])
    # resumed: remat runs kernels 1 and 5 twice a step (the forward, and again inside the backward)
    ngp_ckpt = os.path.join(paths["ngp"]["run_dir"], "checkpoints")
    paths["ngp_resume"] = drive_path(
        "ngp_resume", "launcher.main, ngp resumed with accumulation 2, remat and temporal TV",
        lambda: cli(launcher, [*NGP_FLAGS, "--checkpoint_path", ngp_ckpt, "--epochs", "1",
                               "--accumulate_grad_batches", "2", "--remat", "true", "--temporal_tv", "1e-3",
                               "--output_root", os.path.join(tmp, "ngp_resume"), *grid]),
        NGP_STEPS, 10_000, {**zero, "hash_encode_forward": 2 * NGP_STEPS,
                            "hash_encode_table_grad": NGP_STEPS, "fused_mlp_forward": 2 * NGP_STEPS + CHUNKS,
                            "fused_mlp_backward": NGP_STEPS, "probe": 1})
    check_ngp_resume(paths["ngp_resume"], paths["ngp"], ngp_ckpt)
    # the level anneal adds no launch: the flagship's counts
    paths["flagship_anneal"] = drive_path(
        "flagship_anneal", "launcher.run, flagship with a 92-step level anneal",
        lambda: launcher.run(RunConfig(image_path=path, output_root=os.path.join(tmp, "anneal"), epochs=1,
                                       interp_shapes=(GRID,), level_anneal_steps=92)),
        NGP_STEPS, 10_000, paths["flagship"]["launches"])
    counter = int(restore_checkpoint(os.path.join(paths["flagship_anneal"]["run_dir"], "checkpoints"))
                  ["model"]["anneal_step"])
    if counter != NGP_STEPS:
        fail(f"flagship_anneal: anneal counter {counter} after {NGP_STEPS} steps")


def drive_held_out_paths(path: str, tmp: str, zero: dict, paths: dict) -> None:
    """Phase 5's paths of the held-out-frame slice, each with the counters
    at 0 just before it and read just after, on the volume at ``path``:
    protocol_tv (the temporal protocol's HashMLP on the 8 even frames, its
    latents saved; scored on the 7 odd ones), hash_siren, modulated_siren,
    psf_siren, and flagship_undersample (the flagship on the 10% of the
    voxels that the seed's mask keeps)."""
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.configs import RunConfig
    from mri_interpolation_tpu_torch.io import nifti
    from mri_interpolation_tpu_torch.utils import create_rn_mask

    grid = ["--image_path", path, "--interp_shapes", str(GRID), "--epochs", "1"]
    n = int(np.prod(VOLUME))
    even = n // VOLUME[-1] * ((VOLUME[-1] + 1) // 2)  # the even frames' voxels
    steps = even // 10_000  # 99 on the (352, 352, 15) volume
    # the separable grid path: kernel 1 in training only, kernel 5 on every chunk of both grids
    paths["protocol_tv"] = out = drive_path(
        "protocol_tv", "launcher.main, temporal protocol (even frames, temporal TV, latents)",
        lambda: cli(launcher, [*PROTOCOL_FLAGS, "--output_root", os.path.join(tmp, "protocol"), *grid]),
        steps, 10_000, {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps,
                        "fused_mlp_forward": steps + CHUNKS, "fused_mlp_backward": steps, "probe": 1})
    latents = nifti.load(os.path.join(out["run_dir"], "latents.nii.gz"))
    if latents.shape != VOLUME + (16,) or not all(math.isfinite(out[k]) for k in ("odd_psnr", "odd_ssim")):
        fail(f"protocol_tv: latents {latents.shape}, odd PSNR {out.get('odd_psnr')} / SSIM {out.get('odd_ssim')}")
    if out["train_voxels"] != even:
        fail(f"protocol_tv: {out['train_voxels']} training voxels, not the even frames' {even}")
    log(f"[protocol_tv] held-out odd frames: PSNR {out['odd_psnr']:.3f} dB, SSIM {out['odd_ssim']:.4f}; "
        f"latents {latents.shape}")
    # hash_siren has no encode/decode split: kernel 1 on every grid chunk, on x in [-1, 1]
    paths["hash_siren"] = drive_path(
        "hash_siren", "launcher.main, hash SIREN 64x4 (10 levels)",
        lambda: cli(launcher, [*HASH_SIREN_FLAGS, "--output_root", os.path.join(tmp, "hash_siren"), *grid]),
        n // 20_000, 20_000, {**zero, "hash_encode_forward": n // 20_000 + CHUNKS,
                              "hash_encode_table_grad": n // 20_000, "probe": 1})
    paths["modulated_siren"] = drive_path(
        "modulated_siren", "launcher.main, modulated SIREN 256x4",
        lambda: cli(launcher, [*MODULATED_FLAGS, "--output_root", os.path.join(tmp, "modulated"), *grid]),
        n // 20_000, 20_000, {**zero, "probe": 1})
    paths["psf_siren"] = out = drive_path(
        "psf_siren", "launcher.main, PSF SIREN 256x5 (5^3 points: 512,000-row forwards)",
        lambda: cli(launcher, [*PSF_FLAGS, "--output_root", os.path.join(tmp, "psf"), *grid]),
        n // 4096, 4096, {**zero, "probe": 1})
    want = [0.5 / (s - 1) for s in VOLUME]
    if out.get("coordinates_spacing") != want:
        fail(f"psf_siren: spacing {out.get('coordinates_spacing')}, expected {want}")
    log(f"[psf_siren] coordinates_spacing {out['coordinates_spacing']}")
    _, kept = create_rn_mask((n,), 10.0, key=1337)
    batch = min(10_000, len(kept))
    steps = len(kept) // batch
    paths["flagship_undersample"] = out = drive_path(
        "flagship_undersample", "launcher.run, flagship on 10% of the voxels",
        lambda: launcher.run(RunConfig(image_path=path, output_root=os.path.join(tmp, "undersample"), epochs=1,
                                       interp_shapes=(GRID,), undersample_pct=10.0)),
        steps, batch, {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps, "probe": 1})
    if out["train_voxels"] != len(kept):
        fail(f"flagship_undersample: {out['train_voxels']} training voxels, the seed's mask keeps {len(kept)}")
    log(f"[flagship_undersample] {len(kept):,d} of {n:,d} voxels kept ({100 * len(kept) / n:.3f}%)")


def numpy_linear(volume: np.ndarray, out_shape) -> np.ndarray:
    """Multilinear resampling in float64 numpy, as ``map_coordinates(order=1,
    mode="nearest")`` computes it: at the source index j (S - 1) / (O - 1)
    per axis (``numpy_sample``)."""
    axes = [np.arange(out, dtype=np.float64) * ((size - 1) / max(out - 1, 1))
            for size, out in zip(np.shape(volume), out_shape)]
    return numpy_sample(volume, np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)).astype(np.float32)


def drive_slice_nine_paths(path: str, img: np.ndarray, tmp: str, zero: dict, paths: dict) -> None:
    """Phase 5's paths of the zoo slice, each with the counters at 0 just
    before it and read just after, on the volume at ``path``: warp_protocol
    (``launcher.main --model_class warp_inr --even_frames_only true``, the
    spatial resolutions derived from the frames), warp_ensemble
    (``ensembled_warp_fit_eval``, 2 seeds of 1 epoch, linear blend 0.25), the
    zoo at RESULTS.md's widths (rff_net, gabor, freq_mlp, mlp: batch 20,000,
    plain torch, only the probe launches), and classical (the CLI with
    ``--method linear`` and ``cubic``, each file held to numpy within
    1e-6). ``img`` is the volume at ``path`` as an array, which the ensemble
    fits."""
    import torch
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.infer import classical
    from mri_interpolation_tpu_torch.io import nifti
    from mri_interpolation_tpu_torch.models import make_warp_inr
    from mri_interpolation_tpu_torch.train import TrainConfig
    from mri_interpolation_tpu_torch.train.protocols import ensembled_warp_fit_eval

    grid = ["--image_path", path, "--interp_shapes", str(GRID), "--epochs", "1"]
    n = int(np.prod(VOLUME))
    even = n // VOLUME[-1] * ((VOLUME[-1] + 1) // 2)
    steps = even // 10_000  # 99 on the (352, 352, 15) volume
    # no encode/decode split: kernel 1 on every chunk of both grids, the warped points' gradient in plain torch
    paths["warp_protocol"] = out = drive_path(
        "warp_protocol", "launcher.main, warp INR on the even frames (residual 0.05)",
        lambda: cli(launcher, [*WARP_FLAGS, "--output_root", os.path.join(tmp, "warp"), *grid]),
        steps, 10_000, {**zero, "hash_encode_forward": steps + CHUNKS, "hash_encode_table_grad": steps, "probe": 1})
    with open(os.path.join(out["run_dir"], "config.txt")) as f:
        text = f.read()
    frame = VOLUME[:-1]
    base = tuple(max(2, round(v / 5.5)) for v in frame)  # (64, 64) for (352, 352) frames
    if f"base_resolution : {base}\n" not in text or f"finest_resolution : {frame}\n" not in text:
        fail(f"warp_protocol: the spatial resolutions were not derived from the {frame} frames")
    if not all(math.isfinite(out[k]) for k in ("odd_psnr", "odd_ssim")) or out["train_voxels"] != even:
        fail(f"warp_protocol: odd PSNR {out.get('odd_psnr')} / SSIM {out.get('odd_ssim')}, "
             f"{out['train_voxels']} training voxels")
    log(f"[warp_protocol] held-out odd frames: PSNR {out['odd_psnr']:.3f} dB, SSIM {out['odd_ssim']:.4f}")

    cfg = TrainConfig(batch_size=10_000, epochs=1, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                      cosine_t_max=1, weight_decay=1e-5)
    seeds = (1337, 7)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    q = ensembled_warp_fit_eval(lambda seed: make_warp_inr(3, warp_accel=1.0, seed=seed, **WARP), img, cfg,
                                seeds=seeds, linear_blend=0.25)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    recon_chunks = -(-n // (1 << 17))
    want = {**zero, "hash_encode_forward": 2 * (steps + recon_chunks), "hash_encode_table_grad": 2 * steps}
    scores = [*q["per_seed_odd_psnr"], q["odd"]["psnr"], q["odd"]["ssim"], q["full"]["psnr"], q["full"]["ssim"]]
    if launches != want or not all(math.isfinite(v) for v in scores):
        fail(f"warp_ensemble: launches {launches} (expected {want}), scores {scores}")
    paths["warp_ensemble"] = {"launches": launches, "wall_s": seconds, "per_seed_odd_psnr": q["per_seed_odd_psnr"],
                              "odd": q["odd"], "full": q["full"]}
    log(f"[warp_ensemble] 2 seeds x {steps} steps, linear blend 0.25: odd PSNR per seed "
        f"{[round(v, 3) for v in q['per_seed_odd_psnr']]}, ensembled {q['odd']['psnr']:.3f} dB (SSIM "
        f"{q['odd']['ssim']:.4f}), full {q['full']['psnr']:.3f} dB; launches {launches}; {seconds:.1f} s")

    for name, flags in ZOO_FLAGS.items():
        paths[name] = drive_path(
            name, f"launcher.main, {name} (" + " ".join(flags[2:]) + ")",
            lambda flags=flags, name=name: cli(launcher, [*flags, "--batch_size", "20000", "--output_root",
                                                          os.path.join(tmp, name), *grid]),
            n // 20_000, 20_000, {**zero, "probe": 1})

    data = nifti.load(path).get_fdata(np.float32)
    data = data / data.max()
    out_dir = os.path.join(tmp, "classical")
    os.makedirs(out_dir)
    reset_counts()
    t0 = time.perf_counter()
    errs = {}
    for method in ("linear", "cubic"):
        out_path = os.path.join(out_dir, f"{method}.nii.gz")
        with contextlib.redirect_stdout(io.StringIO()):
            classical.main([path, "--out", out_path, "--method", method])
        got = nifti.load(out_path).get_fdata(np.float32)
        if method == "linear":
            ref = numpy_linear(data[..., ::2], VOLUME)
        else:
            t_keep = [2 * j / (VOLUME[-1] - 1) for j in range((VOLUME[-1] + 1) // 2)]
            ref = classical.cubic_interpolate_frames(data[..., ::2], t_keep,
                                                     [i / (VOLUME[-1] - 1) for i in range(VOLUME[-1])])
        errs[method] = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
        if not errs[method] <= 1e-6:
            fail(f"classical {method}: file {got.shape} differs from numpy by {errs[method]} (atol 1e-6)")
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches != zero:
        fail(f"classical: launches {launches}")
    paths["classical"] = {"launches": launches, "wall_s": seconds, "max_abs_err": errs}
    log(f"[classical] CLI --method linear / cubic on {VOLUME} (even frames to all): files within "
        f"{errs['linear']:.3e} / {errs['cubic']:.3e} of numpy; {seconds:.1f} s")


def numpy_sample(frame: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``map_coordinates(frame, idx, order=1, mode="nearest")`` in float64
    numpy at voxel positions ``idx`` (..., d): the 2^d corners, each index
    clipped to [0, S - 1]."""
    vol = np.asarray(frame, np.float64)
    lower = np.floor(idx)
    w = idx - lower
    lower = lower.astype(np.int64)
    out = np.zeros(idx.shape[:-1], np.float64)
    for corner in range(1 << vol.ndim):
        index, weight = [], 1.0
        for k in range(vol.ndim):
            bit = (corner >> k) & 1
            index.append(np.clip(lower[..., k] + bit, 0, vol.shape[k] - 1))
            weight = weight * (w[..., k] if bit else 1.0 - w[..., k])
        out += weight * vol[tuple(index)]
    return out


def moved(frame: np.ndarray, amp: float) -> np.ndarray:
    """``frame`` under a smooth in-plane displacement of up to ``amp``
    voxels (a sine along the first axis, half a cosine along the second)."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in frame.shape], indexing="ij")
    disp = [amp * np.sin(2 * np.pi * grids[1] / frame.shape[1]), 0.5 * amp * np.cos(2 * np.pi * grids[0] / frame.shape[0])]
    disp += [np.zeros_like(g) for g in grids[2:]]
    return numpy_sample(frame, np.stack([g + d for g, d in zip(grids, disp)], axis=-1)).astype(np.float32)


def psnr_db(pred: np.ndarray, truth: np.ndarray) -> float:
    return float(-10.0 * np.log10(np.mean((np.asarray(pred, np.float64) - truth) ** 2)))


def check_registration_card_vs_cpu(torch, card=None) -> dict:
    """``register_pair`` on a (352, 352) pair and a (64, 64, 6) pair (the
    antialiased 3-D resize on the card) and ``register_group_temporal`` on 4
    (352, 352) frames, each at its default stages, on the card and on the
    CPU: a smooth synthetic frame under smooth displacements of up to 6 (3
    for 3-D) voxels. Held: the step-0 gradient of the first stage and its
    first 10 losses, the final control fields (within lr) and the midpoints
    they synthesise (within ``REG_MID_SHARE`` of the largest value); each of
    the last two also passes within twice the CPU's own spread, its move
    when the first frame is perturbed by 1e-7. Returns the differences, the
    spreads, the walls and the midpoints' PSNR against the true midpoint."""
    from mri_interpolation_tpu_torch.infer import registration as R
    from mri_interpolation_tpu_torch.io import normalize_intensity, synthetic_volume

    cpu, card = torch.device("cpu"), card or torch.device("cuda")
    frame2 = normalize_intensity(synthetic_volume(REG_FRAME, seed=5))
    frame3 = normalize_intensity(synthetic_volume(REG_FRAME_3D, seed=6))
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def first_stage(name, loss_of, ctrl_shape):
        """The step-0 gradient and the first 10 losses, card vs CPU."""
        grads, losses = {}, {}
        for dev in (card, cpu):
            c = torch.zeros(ctrl_shape, device=dev, requires_grad=True)
            loss_of(dev)(c).backward()
            grads[dev] = c.grad.cpu().numpy()
            losses[dev] = R._adam(torch.zeros(ctrl_shape, device=dev), loss_of(dev), REG_LR, 10)[1].cpu().numpy()
        g, ref = grads[card], grads[cpu]
        bound = REG_GRAD_SHARE * float(np.abs(ref).max())
        big = np.abs(ref) > bound
        flips = int(np.sum(np.sign(g[big]) != np.sign(ref[big])))
        grad_err = float(np.abs(g - ref).max())
        loss_rel = float(np.max(np.abs(losses[card] - losses[cpu]) / np.abs(losses[cpu])))
        if grad_err > bound or flips or loss_rel > FIT_RTOL:
            fail(f"registration {name}: step-0 gradient off by {grad_err:.3e} (bound {bound:.3e}), {flips} signs "
                 f"flipped, first losses off by {loss_rel:.3e} (rtol {FIT_RTOL})")
        log(f"[registration] {name}: step-0 gradient {grad_err:.3e} apart (largest {float(np.abs(ref).max()):.3e}, "
            f"bound {bound:.3e}), no sign flipped; first 10 losses within {loss_rel:.3e} (rtol {FIT_RTOL})")
        return {"step0_grad_err": grad_err, "step0_grad_bound": bound, "first10_loss_rel": loss_rel}

    def perturbed(x):
        """``x`` plus 1e-7 N(0, 1) noise (seeded)."""
        return x + 1e-7 * np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def held(name, ctrl_card, ctrl_cpu, ctrl_spread, mid_card, mid_cpu, mid_spread, truth, fade, card_s, cpu_s):
        ctrl_err = float(np.abs(ctrl_card.cpu().numpy() - ctrl_cpu.numpy()).max())
        mid_err = float(np.abs(mid_card - mid_cpu).max())
        c_spread = float((ctrl_spread - ctrl_cpu).abs().max())
        spread = float(np.abs(mid_spread - mid_cpu).max())
        ctrl_bound = max(REG_LR, 2.0 * c_spread)
        mid_bound = max(REG_MID_SHARE * float(np.abs(mid_cpu).max()), 2.0 * spread)
        row = {"ctrl_err": ctrl_err, "ctrl_max": float(ctrl_cpu.abs().max()), "ctrl_spread_cpu": c_spread,
               "ctrl_bound": ctrl_bound, "mid_err": mid_err, "mid_spread_cpu": spread, "mid_bound": mid_bound,
               "card_s": card_s, "cpu_s": cpu_s,
               "psnr_card": psnr_db(mid_card, truth), "psnr_cpu": psnr_db(mid_cpu, truth),
               "psnr_fade": psnr_db(fade, truth)}
        if not (ctrl_card.device.type == card.type and ctrl_err <= ctrl_bound and mid_err <= mid_bound
                and np.all(np.isfinite(mid_card))):
            fail(f"registration {name}: control fields {ctrl_err:.3e} apart (bound {ctrl_bound:.3e}), midpoints "
                 f"{mid_err:.3e} (bound {mid_bound:.3e}), fields on {ctrl_card.device}")
        log(f"[registration] {name}: card {card_s:.2f} s, CPU {cpu_s:.2f} s; control fields {ctrl_err:.3e} apart "
            f"(largest {row['ctrl_max']:.4f}; bound {ctrl_bound:.3e}; the CPU's own spread {c_spread:.3e}), midpoints "
            f"{mid_err:.3e} (bound {mid_bound:.3e}; the CPU's own spread {spread:.3e}); "
            f"midpoint PSNR card {row['psnr_card']:.3f} / CPU {row['psnr_cpu']:.3f} / cross-fade "
            f"{row['psnr_fade']:.3f} dB")
        return row

    for name, a, amp in (("pair_" + "x".join(map(str, REG_FRAME)), frame2, 6.0),
                         ("pair_" + "x".join(map(str, REG_FRAME_3D)), frame3, 3.0)):
        b, truth = moved(a, amp), moved(a, amp / 2)
        gshape = R._stage_shape(a.shape, 8, 4) + (a.ndim,)
        row = first_stage(name, lambda dev: R._pair_loss(R._resize_frame(R._frame(a, dev), 4),
                                                         R._resize_frame(R._frame(b, dev), 4), 1e-2), gshape)
        ctrl_card, card_s = timed(lambda: R.register_pair(a, b, device=card))
        ctrl_cpu, cpu_s = timed(lambda: R.register_pair(a, b, device=cpu))
        mid_card = R.synthesize_frame(a, b, ctrl_card, device=card).cpu().numpy()
        mid_cpu = R.synthesize_frame(a, b, ctrl_cpu, device=cpu).numpy()
        ctrl_spread = R.register_pair(perturbed(a), b, device=cpu)
        mid_spread = R.synthesize_frame(a, b, ctrl_spread, device=cpu).numpy()
        out[name] = {**row, **held(name, ctrl_card, ctrl_cpu, ctrl_spread, mid_card, mid_cpu, mid_spread, truth,
                                   0.5 * (a + b), card_s, cpu_s)}

    frames = np.stack([moved(frame2, amp) for amp in (0.0, 2.0, 4.0, 6.0)], axis=-1)
    truth = np.stack([moved(frame2, amp) for amp in (1.0, 3.0, 5.0)], axis=-1)
    stack = np.moveaxis(frames, -1, 0)
    group = "group_4x" + "x".join(map(str, REG_FRAME))
    row = first_stage(group,
                      lambda dev: R._group_loss(R._resize_frame(R._frame(stack, dev), 4, batch=1), 1e-2, 1e-1, None),
                      (4,) + R._stage_shape(REG_FRAME, 8, 4) + (2,))
    ctrl_card, card_s = timed(lambda: R.register_group_temporal(frames, device=card))
    ctrl_cpu, cpu_s = timed(lambda: R.register_group_temporal(frames, device=cpu))
    up_card = R.group_motion_upsample(frames, 7, ctrl=ctrl_card, device=card)[..., 1::2]
    up_cpu = R.group_motion_upsample(frames, 7, ctrl=ctrl_cpu, device=cpu)[..., 1::2]
    frames_p = frames.copy()
    frames_p[..., 0] = perturbed(frames[..., 0])
    ctrl_spread = R.register_group_temporal(frames_p, device=cpu)
    up_spread = R.group_motion_upsample(frames, 7, ctrl=ctrl_spread, device=cpu)[..., 1::2]
    out[group] = {**row, **held(group, ctrl_card, ctrl_cpu, ctrl_spread, up_card, up_cpu, up_spread, truth,
                                            0.5 * (frames[..., :-1] + frames[..., 1:]), card_s, cpu_s)}
    return out


def drive_slice_ten_paths(path: str, img: np.ndarray, tmp: str, zero: dict, paths: dict) -> None:
    """Phase 5's paths of the registration slice, each with the counters at
    0 just before it and read just after, on the volume at ``path`` (``img``
    as an array): registration_protocol (``registration_interp_eval`` at its
    defaults: 7 pairs), classical_registration (the CLI with ``--method
    registration`` and ``registration_group``), stacked
    (``stacked_interp_eval`` with ``STACK_ROSTER``, one seed, one warp epoch)
    and stacking_cli (``python -m ...train.stacking`` on the volume's even
    frames saved as NIfTI, with the same roster and a prediction cache,
    twice: the second run calls no family and writes the same volume; the
    first one's odd frames scored against the volume's)."""
    import torch
    from mri_interpolation_tpu_torch.infer import classical
    from mri_interpolation_tpu_torch.io import load_volume, nifti
    from mri_interpolation_tpu_torch.train import TrainConfig
    from mri_interpolation_tpu_torch.train import stacking as stk
    from mri_interpolation_tpu_torch.train.protocols import registration_interp_eval

    even = img[..., ::2]
    n_pairs = even.shape[-1] - 1
    (recon, q), seconds, launches = counted(lambda: registration_interp_eval(img))
    scores = [q[p][m] for p in ("full", "odd") for m in ("psnr", "ssim")]
    if launches != zero or not np.array_equal(recon[..., ::2], even) or not all(math.isfinite(v) for v in scores):
        fail(f"registration_protocol: launches {launches}, even frames passed through "
             f"{np.array_equal(recon[..., ::2], even)}, scores {scores}")
    paths["registration_protocol"] = {"launches": launches, "wall_s": seconds, "wall_per_pair_s": seconds / n_pairs,
                                      "odd": q["odd"], "full": q["full"]}
    log(f"[registration_protocol] {n_pairs} pairs of {VOLUME[:-1]} at the default stages: odd PSNR "
        f"{q['odd']['psnr']:.3f} dB, SSIM {q['odd']['ssim']:.4f}; full {q['full']['psnr']:.3f} dB; {seconds:.1f} s "
        f"({seconds / n_pairs:.2f} s a pair)")

    data = nifti.load(path).get_fdata(np.float32)
    data = data / data.max()
    walls = {}
    for method in ("registration", "registration_group"):
        out_path = os.path.join(tmp, f"classical_{method}.nii.gz")
        with contextlib.redirect_stdout(io.StringIO()):
            _, walls[method], launches = counted(lambda: classical.main([path, "--out", out_path, "--method", method]))
        got = nifti.load(out_path).get_fdata(np.float32)
        if (launches != zero or got.shape != VOLUME or not np.all(np.isfinite(got))
                or not np.array_equal(got[..., ::2], data[..., ::2])):
            fail(f"classical {method}: launches {launches}, file {got.shape}, finite {np.all(np.isfinite(got))}, "
                 f"even frames passed through {got.shape == VOLUME and np.array_equal(got[..., ::2], data[..., ::2])}")
    paths["classical_registration"] = {"launches": zero, "wall_s": walls}
    log(f"[classical_registration] CLI --method registration / registration_group on {VOLUME}: files finite, "
        f"even frames exact; {walls['registration']:.1f} / {walls['registration_group']:.1f} s")

    n_frame = VOLUME[0] * VOLUME[1]

    def fit_steps(t_kept: int) -> int:
        """The warp fits' steps of one LOO protocol over ``t_kept`` frames:
        the deployment on all, one fold on all but one per interior frame."""
        return t_kept * n_frame // 10_000 + (t_kept - 2) * ((t_kept - 1) * n_frame // 10_000)

    cfg = TrainConfig(batch_size=10_000, epochs=1, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                      cosine_t_max=1, weight_decay=1e-5)
    disk = stk._FIT_DISK_DIR
    stk._FIT_DISK_DIR = ""
    try:
        families = stk.default_interp_families(cfg, VOLUME, seeds=(1337,), include=STACK_ROSTER)
        (recon, q), seconds, launches = counted(lambda: stk.stacked_interp_eval(img, cfg, families=families))
        steps = fit_steps(even.shape[-1])
        want = {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps}
        w = q["weights"]["global"]
        if (launches != want or not np.array_equal(recon[..., ::2], even) or abs(sum(w.values()) - 1.0) > 1e-6
                or min(w.values()) < 0.0 or not math.isfinite(q["odd"]["psnr"])):
            fail(f"stacked: launches {launches} (expected {want}), even frames passed through "
                 f"{np.array_equal(recon[..., ::2], even)}, weights {w}, odd {q['odd']}")
        paths["stacked"] = {"launches": launches, "wall_s": seconds, "weights": w, "odd": q["odd"], "full": q["full"],
                            "sigma_mean": q["uncertainty"]["sigma_mean"]}
        log(f"[stacked] roster {STACK_ROSTER}, one seed, one warp epoch: global LOO weights "
            + ", ".join(f"{k} {v:.4f}" for k, v in w.items()) + f"; odd PSNR {q['odd']['psnr']:.3f} dB, SSIM "
            f"{q['odd']['ssim']:.4f}; sigma_mean {q['uncertainty']['sigma_mean']:.5f}; launches {launches}; "
            f"{seconds:.1f} s")

        calls = {"n": 0}
        make = stk.default_interp_families

        def counting(*a, **k):
            def wrap(f):
                def family(*args):
                    calls["n"] += 1
                    return f(*args)

                return family

            return {n: wrap(f) for n, f in make(*a, **k).items()}

        stk.default_interp_families = counting
        even_path = os.path.join(tmp, "even_frames.nii.gz")
        nifti.save(even, even_path)
        runs = []
        try:
            for run in range(2):
                out_path = os.path.join(tmp, f"stacked_sr{run}.nii.gz")
                argv = [even_path, "--out", out_path, "--families", ",".join(STACK_ROSTER), "--seeds", "1337", "--epochs",
                        "1", "--cache_dir", os.path.join(tmp, "stack_cache")]
                calls["n"] = 0
                with contextlib.redirect_stdout(io.StringIO()):
                    rec, seconds, launches = counted(lambda: stk._main(argv))
                runs.append({"calls": calls["n"], "wall_s": seconds, "launches": launches, "weights":
                             rec["global_weights"], "volume": nifti.load(out_path).get_fdata(np.float32)})
        finally:
            stk.default_interp_families = make
    finally:
        stk._FIT_DISK_DIR = disk
    T = even.shape[-1]
    steps = fit_steps(T)
    first, second = runs
    lo, hi = float(even.min()), float(even.max())  # the CLI's normalisation of its input
    odd_psnr = psnr_db(first["volume"][..., 1::2], (img[..., 1::2] - lo) / (hi - lo))
    want = {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps}
    n_calls = len(STACK_ROSTER) * (1 + T - 2)
    t_up = 2 * (T - 1) + 1
    if (first["launches"] != want or first["calls"] != n_calls or second["calls"] != 0 or second["launches"] != zero
            or first["volume"].shape != VOLUME[:-1] + (t_up,) or not np.all(np.isfinite(first["volume"]))
            or first["volume"].tobytes() != second["volume"].tobytes()
            or not np.array_equal(first["volume"][..., ::2], load_volume(even_path).image())):
        fail(f"stacking_cli: first run {first['calls']} family calls (expected {n_calls}), launches "
             f"{first['launches']} (expected {want}); second run {second['calls']} calls, launches "
             f"{second['launches']}; volume {first['volume'].shape}, replay identical "
             f"{first['volume'].tobytes() == second['volume'].tobytes()}")
    paths["stacking_cli"] = {"launches": first["launches"], "wall_s": first["wall_s"],
                             "replay_wall_s": second["wall_s"], "weights": first["weights"], "odd_psnr": odd_psnr}
    log(f"[stacking_cli] the {T} even frames of {VOLUME} to {t_up} frames, roster {STACK_ROSTER}: {first['calls']} "
        f"family calls, launches {first['launches']}, {first['wall_s']:.1f} s; the odd frames against the volume's: "
        f"PSNR {odd_psnr:.3f} dB; replay from the cache: no family called, no launch, the same volume bit for bit, "
        f"{second['wall_s']:.1f} s; global weights " + ", ".join(f"{k} {v:.4f}" for k, v in first["weights"].items()))


def check_full4d_hash_kernels(torch, he, dev) -> dict:
    """Kernels 1 and 2 on the full-4D recipe's encoder (``FULL4D``, 12,134,251
    rows x F = 4, 16 corners a point and level; every level global in kernel
    2's plan) at its training batch (N = 50,000) and a grid chunk (N =
    131,072), x in [0, 1], a table drawn U(-1, 1); returns per-kernel rows."""
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding

    gen = torch.Generator(device="cpu").manual_seed(14)
    enc = HashGridEncoding(dim=4, **FULL4D)
    table = (torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1).to(dev)
    rows = {"hash_encode_forward": [], "hash_encode_table_grad": []}
    for n, what in ((50_000, "train batch"), (1 << 17, "grid chunk")):
        plan = he.table_grad_plan(enc, n)
        log(f"[kernels] full4d: {enc.total_size:,d} rows x F={enc.n_features_per_level}, dense "
            f"{enc.level_dense.tolist()}, resolutions {enc.level_resolutions.tolist()}, plan at N={n:,d} {plan}")
        x = torch.rand((n, 4), generator=gen)
        x[0], x[1] = 0.0, 1.0
        g = torch.randn((n, enc.output_dim), generator=gen)
        for name, row in encoder_rows(torch, he, enc, table, x.to(dev), g.to(dev), f"{what}, x in [0, 1]",
                                      "full4d").items():
            rows[name].append(row)
    return rows


def stream_matches_cpu(torch, name: str, make_model, volume, cfg, shard_voxels: int) -> float:
    """``Trainer.fit_streaming`` of one init on the card and on the CPU (the
    hash table redrawn U(-0.5, 0.5), as ``small_fit_setup``): the first 10
    losses within rtol FIT_RTOL; returns their largest relative difference."""
    from mri_interpolation_tpu_torch.train import Trainer

    state = make_model("cpu").state_dict()
    state["encoder.table"] = torch.empty(state["encoder.table"].shape).uniform_(
        -0.5, 0.5, generator=torch.Generator().manual_seed(6))
    losses = {}
    for dev in ("cuda", "cpu"):
        model = make_model(dev)
        model.load_state_dict(state)
        losses[dev] = Trainer(cfg).fit_streaming(model, volume, shard_voxels=shard_voxels, device=dev).losses
    card, cpu = losses["cuda"][:10], losses["cpu"][:10]
    if len(cpu) != 10 or not np.all(np.isfinite(losses["cuda"])):
        fail(f"streamed fit {name}: {len(losses['cpu'])} steps, card losses {losses['cuda']}")
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    if rel > FIT_RTOL:
        fail(f"streamed fit {name}: card and CPU loss curves differ by {rel} > rtol {FIT_RTOL}")
    return rel


def check_streaming_card_vs_cpu(torch) -> dict:
    """``fit_streaming`` card against CPU, the first 10 steps: the recipe's
    shape cut to a (16, 16, 6, 5) volume (3 steps of 256 a shard, 10 shards,
    the last padded), and the flagship HashMLP at its width on the (352, 352,
    15) volume (10 steps of 10,000 a shard, 19 shards)."""
    from mri_interpolation_tpu_torch.io import synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import TrainConfig

    small4d = dict(n_levels=5, n_features_per_level=4, log2_hashmap_size=12, base_resolution=(2, 2, 2, 2),
                   finest_resolution=(16, 16, 6, 5), growth="paper", decoder="relu_plain", dim_hidden=64, seed=5)
    return {
        "full4d cut to (16, 16, 6, 5)": stream_matches_cpu(
            torch, "full4d small", lambda d: make_hash_mlp(4, device=d, **small4d),
            synthetic_volume((16, 16, 6, 5), seed=3),
            TrainConfig(batch_size=256, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=30,
                        seed=7), 768),
        "flagship (352, 352, 15)": stream_matches_cpu(
            torch, "flagship", lambda d: make_hash_mlp(3, device=d, seed=5), synthetic_volume(VOLUME, seed=0),
            TrainConfig(batch_size=10_000, seed=7), 100_000),
    }


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG whose rows all carry filter 0 (what
    ``io/png.py`` writes), decoded with zlib alone."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            fail(f"{path}: chunk {kind} fails its CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = hdr[:4]
    channels = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if depth != 8 or rows[:, 0].any():
        fail(f"{path}: bit depth {depth}, filters {set(rows[:, 0].tolist())}")
    return rows[:, 1:].reshape((h, w) if channels == 1 else (h, w, 3))


# fitted models the export phase serves again: multi_hash_mlp's (drive_frames) and full4d_resident's (drive_full4d)
MODELS = {}


def counted(fn):
    """``fn()`` with the counters at 0 just before and read just after:
    (result, seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, read_counts()


def drive_full4d(torch, tmp: str, zero: dict, paths: dict) -> dict:
    """The full-4D recipe on a synthetic (352, 352, 6, 15) volume written as
    uncompressed NIfTI, through ``launcher.main``: ``--plan`` (no device),
    full4d_resident (1 epoch of 30, 223 steps, the (352, 352, 6, 30)
    interpolation) and full4d_streamed (``--stream_shard_voxels 4194304``:
    3 shards of 83 steps, no interpolation grid), each with the counters at
    0 just before it and read just after and its peak of allocated device
    memory. The plan's table, decoder and optimizer bytes are held exactly
    to the resident fit's parameters and Adam's two moment buffers, its
    dataset bytes to the (coords, values) the fit put on the card; the
    step roofline is fed the resident run's steps/s. Returns the plan."""
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.plan import step_roofline
    from mri_interpolation_tpu_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    path = os.path.join(tmp, "synthetic_352x352x6x15.nii")
    nifti.save(synthetic_volume(FULL4D_VOLUME, seed=0), path)
    log(f"[full4d] volume {FULL4D_VOLUME} written uncompressed in {time.perf_counter() - t0:.1f} s")
    base = ["--image_path", path, *FULL4D_FLAGS]

    (plan, seconds, launches) = counted(lambda: cli(launcher, [*base, "--plan"]))
    if launches != zero:
        fail(f"full4d --plan: launches {launches}")
    log(f"[full4d] --plan in {seconds:.3f} s: bytes {json.dumps(plan['bytes'])}; {plan['recommendations']}")

    # spies on the resident fit: the optimizer it makes and the arrays it puts on the card
    captured = {}
    make_optimizer, fit = trainer_mod.make_optimizer, trainer_mod.Trainer.fit

    def spy_optimizer(cfg, params):
        captured["optimizer"] = make_optimizer(cfg, params)
        return captured["optimizer"]

    def spy_fit(self, model, coords, values, **kw):
        captured["dataset"] = sum(np.asarray(a, dtype=np.float32).nbytes for a in (coords, values))
        MODELS["full4d_resident"] = model
        return fit(self, model, coords, values, **kw)

    runs = {}
    for name, flags, steps, chunks in (
            ("full4d_resident", ["--interp_shapes", str(FULL4D_GRID)], FULL4D_STEPS,
             FULL4D_CHUNKS + FULL4D_GRID_CHUNKS),
            ("full4d_streamed", ["--stream_shard_voxels", str(STREAM_SHARD), "--interp_shapes", "()"], STREAM_STEPS,
             FULL4D_CHUNKS)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer_mod.make_optimizer, trainer_mod.Trainer.fit = spy_optimizer, spy_fit
        try:
            summary, seconds, launches = counted(
                lambda: cli(launcher, [*base, *flags, "--output_root", os.path.join(tmp, name)]))
        finally:
            trainer_mod.make_optimizer, trainer_mod.Trainer.fit = make_optimizer, fit
        peak = torch.cuda.max_memory_allocated()
        want = {**zero, "hash_encode_forward": steps + chunks, "hash_encode_table_grad": steps,
                "fused_mlp_forward": steps + chunks, "fused_mlp_backward": steps, "probe": 1}
        if summary["steps"] != steps or launches != want or not math.isfinite(summary["psnr"]):
            fail(f"{name}: {summary['steps']} steps, PSNR {summary['psnr']}, launches {launches}; expected {steps} "
                 f"steps, launches {want}")
        files = set(os.listdir(summary["run_dir"]))
        if "pred.nii.gz" not in files or (name == "full4d_resident") != (f"interpolation{FULL4D_GRID}.nii.gz" in files):
            fail(f"{name}: run directory holds {sorted(files)}")
        train_s = summary["train_wall_s"]
        runs[name] = out = {
            "run_dir": summary["run_dir"], "steps": steps, "train_wall_s": train_s, "steps_per_s": steps / train_s,
            "train_voxel_evals_per_s": steps * 50_000 / train_s, "recon_eval_s": summary["recon_eval_s"],
            "interp_eval_s": summary["interp_eval_s"], "psnr": summary["psnr"], "ssim": summary["ssim"],
            "final_loss": summary["final_loss"], "wall_s": seconds, "launches": launches,
            "peak_allocated_bytes": peak, "allocated_before_bytes": before, "stream": summary.get("stream")}
        log(f"[{name}] launcher.main: {steps} steps in {train_s:.3f} s = {out['steps_per_s']:.1f} steps/s, "
            f"{out['train_voxel_evals_per_s']:,.0f} training voxel-evals/s; reconstruction "
            f"{summary['recon_eval_s']:.3f} s, interpolation {summary['interp_eval_s']}; PSNR {summary['psnr']:.3f} dB, "
            f"SSIM {summary['ssim']:.4f}; peak allocated {peak / 1e9:.3f} GB ({before / 1e9:.3f} GB before); "
            f"launches {launches}; {seconds:.1f} s")
        if name == "full4d_streamed":
            captured.pop("optimizer")
            st = summary["stream"]
            if len(st["host_synth_s"]) != 1 or "dataset" in captured:
                fail(f"full4d_streamed: stream record {st}, resident dataset {captured.get('dataset')}")
            log(f"[full4d_streamed] epoch {st['epoch_s'][0]:.3f} s: host synthesis {st['host_synth_s'][0]:.3f} s "
                f"(worker thread), host-to-device {st['h2d_s'][0]:.4f} s (copy events), the loop waited "
                f"{st['shard_wait_s'][0]:.3f} s for shards")
            continue
        # the resident fit's real bytes against the plan's
        opt = captured.pop("optimizer")
        params = [p for group in opt.param_groups for p in group["params"]]
        rows = HashGridEncoding(dim=4, **FULL4D).total_size
        table = [p for p in params if tuple(p.shape) == (rows, FULL4D["n_features_per_level"])]
        table_bytes = sum(p.numel() * p.element_size() for p in table)
        decoder_bytes = sum(p.numel() * p.element_size() for p in params) - table_bytes
        moment_bytes = sum(st[k].numel() * st[k].element_size() for st in opt.state.values()
                           for k in ("exp_avg", "exp_avg_sq"))
        real = {"table": table_bytes, "decoder_params": decoder_bytes, "optimizer_state": moment_bytes,
                "dataset": captured.pop("dataset")}
        del opt, params, table
        got = {k: plan["bytes"][k] for k in real}
        if got != real:
            fail(f"full4d --plan: the plan's bytes {got} differ from the resident fit's {real}")
        out["real_bytes"] = real
        log(f"[full4d --plan] table, decoder, Adam moments and dataset bytes equal the resident fit's: {real}")
    step_total = plan["bytes"]["step_total"]
    for name, out in runs.items():
        log(f"[full4d --plan] step total {step_total / 1e9:.3f} GB (with the dataset {plan['bytes']['total'] / 1e9:.3f} "
            f"GB) beside {name}'s peak {out['peak_allocated_bytes'] / 1e9:.3f} GB")
    roof = step_roofline(dim_in=4, batch_size=50_000, decoder="relu_plain", optimizer="adam_tcnn",
                         **{k: v for k, v in FULL4D.items()},
                         measured_steps_per_sec=runs["full4d_resident"]["steps_per_s"])
    log(f"[full4d roofline] {json.dumps(roof['floor_s'])}; measured {json.dumps(roof['measured'])}")
    paths.update(runs)
    paths["full4d_resident"]["roofline"] = roof
    return plan


def drive_tooling(torch, path: str, tmp: str, zero: dict, paths: dict) -> None:
    """The tooling around the launcher, each with the counters at 0 just
    before it and read just after: a ``--config_yaml`` run, a 2-D launcher
    run that writes ``pred.png`` (decoded here, equal to viridis of
    ``pred.T``), ``make_figures`` on protocol_tv's run directory, the sweep
    CLI (2 ``recon`` trials and 2 ``odd_frames`` trials with ``--ens_seeds
    2``, then both again from their logs, launching nothing), and a SIREN
    preset fit of a synthetic MNIST digit (kernels 5-6)."""
    from mri_interpolation_tpu_torch import figures, launcher
    from mri_interpolation_tpu_torch.configs import parse_config_txt
    from mri_interpolation_tpu_torch.encodings import HashGridEncoding
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.io import mnist, nifti, png
    from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction
    from mri_interpolation_tpu_torch.models import make_siren
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, sweep

    n = int(np.prod(VOLUME))
    yml = os.path.join(tmp, "run.yaml")
    with open(yml, "w") as f:
        f.write("# a run config: the flat section, then the reference schema's optimizer\nrun:\n  epochs: 1\n"
                "  batch_size: 20000\n  n_levels: 3\n  n_features_per_level: 2\n  interp_shapes: []\n"
                "  save_checkpoint: false\noptimizer:\n  _target_: FakeOptimizer\n  lr: 1.0e-2\n")
    summary, seconds, launches = counted(lambda: cli(launcher, [
        "--config_yaml", yml, "--image_path", path, "--output_root", os.path.join(tmp, "yaml")]))
    cfg = parse_config_txt(os.path.join(summary["run_dir"], "config.txt"))
    steps = n // 20_000
    want = {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps, "probe": 1}
    if (summary["steps"], cfg["n_levels"], cfg["lr"], cfg["interp_shapes"], launches) != (steps, "3", "0.01", "()",
                                                                                          want):
        fail(f"config_yaml: {summary['steps']} steps, config {cfg}, launches {launches}")
    paths["config_yaml"] = {"launches": launches, "wall_s": seconds, "psnr": summary["psnr"]}
    log(f"[config_yaml] launcher.main --config_yaml: {steps} steps, n_levels {cfg['n_levels']}, lr {cfg['lr']}, "
        f"PSNR {summary['psnr']:.3f} dB; launches {launches}; {seconds:.1f} s")

    frame_path = os.path.join(tmp, "frame_352x352.nii.gz")
    nifti.save(nifti.load(path).get_fdata(np.float32)[..., 0], frame_path)
    summary, seconds, launches = counted(lambda: cli(launcher, [
        "--image_path", frame_path, "--epochs", "1", "--interp_shapes", "()", "--output_root",
        os.path.join(tmp, "frame")]))
    steps = FRAME[0] * FRAME[1] // 10_000
    want = {**zero, "hash_encode_forward": steps, "hash_encode_table_grad": steps, "probe": 1}
    recon = nifti.load(os.path.join(summary["run_dir"], "pred.nii.gz")).get_fdata(np.float32)
    image = read_png(os.path.join(summary["run_dir"], "pred.png"))
    if launches != want or recon.shape != FRAME or not np.array_equal(image, png.colorize(recon.T)):
        fail(f"pred_png: launches {launches}, reconstruction {recon.shape}, pred.png {image.shape} equal to viridis of "
             f"pred.T: {image.shape == FRAME + (3,) and np.array_equal(image, png.colorize(recon.T))}")
    paths["pred_png"] = {"launches": launches, "wall_s": seconds, "psnr": summary["psnr"]}
    log(f"[pred_png] 2-D launcher run: {steps} steps, PSNR {summary['psnr']:.3f} dB, pred.png {image.shape} = "
        f"viridis of pred.T; launches {launches}; {seconds:.1f} s")

    run_dir = paths["protocol_tv"]["run_dir"]
    arts, seconds, launches = counted(lambda: figures.make_figures(run_dir))
    grid, lat, conv = (read_png(arts[k]) for k in ("grid", "latents", "convergence"))
    tiles = 3 * 352 + 4 * 4, 5 * 352 + 6 * 4
    if (launches != zero or grid.shape != tiles or lat.shape != (2 * 352 + 12, 8 * 352 + 36, 3)
            or conv.shape != (420, 720, 3) or open(arts["gif"], "rb").read(6) != b"GIF89a"):
        fail(f"figures: launches {launches}, grid {grid.shape}, latents {lat.shape}, convergence {conv.shape}")
    paths["figures"] = {"launches": launches, "wall_s": seconds,
                        "bytes": {k: os.path.getsize(v) for k, v in arts.items()}}
    log(f"[figures] make_figures on protocol_tv's run: {paths['figures']['bytes']}; {seconds:.1f} s")

    logs = {"recon": os.path.join(tmp, "sweep_recon.jsonl"), "odd_frames": os.path.join(tmp, "sweep_odd.jsonl")}
    argvs = {"recon": ["--image_path", path, "--trials", "2", "--epochs", "1", "--log_path", logs["recon"]],
             "odd_frames": ["--image_path", path, "--model_class", "warp_inr", "--objective", "odd_frames",
                            "--ens_seeds", "2", "--trials", "2", "--epochs", "1", "--log_path", logs["odd_frames"]]}
    even = n // VOLUME[-1] * ((VOLUME[-1] + 1) // 2) // 10_000  # 99 warp steps a seed
    recon_chunks = -(-n // (1 << 17))
    for objective, argv in argvs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            result, seconds, launches = counted(lambda: sweep.main(argv))
        scores = [t["score"] for t in result.trials]
        if objective == "recon":  # each trial: one epoch; the grid on kernel 1 unless every level is dense
            fwd = 0
            for t in result.trials:
                p = t["params"]
                enc = HashGridEncoding(dim=3, n_levels=p["n_levels"], n_features_per_level=p["n_features_per_level"],
                                       log2_hashmap_size=23, base_resolution=16, finest_resolution=max(VOLUME))
                fwd += n // 10_000 + (0 if enc.level_dense.all() else recon_chunks)
            want = {**zero, "hash_encode_forward": fwd, "hash_encode_table_grad": 2 * (n // 10_000)}
        else:  # 2 trials x 2 seeds: the even frames' steps and the reconstruction's chunks, kernel 1 per chunk
            want = {**zero, "hash_encode_forward": 4 * (even + recon_chunks), "hash_encode_table_grad": 4 * even}
        if len(scores) != 2 or not all(s is not None and math.isfinite(s) for s in scores) or launches != want:
            fail(f"sweep {objective}: trials {result.trials}, launches {launches} (expected {want})")
        with contextlib.redirect_stdout(io.StringIO()):
            again, rerun_s, rerun = counted(lambda: sweep.main(argv))
        if rerun != zero or again.trials != result.trials:
            fail(f"sweep {objective} rerun: launches {rerun}, trials {again.trials}")
        paths[f"sweep_{objective}"] = {"launches": launches, "wall_s": seconds, "trials": result.trials,
                                       "rerun_s": rerun_s, "rerun_launches": rerun}
        log(f"[sweep {objective}] 2 trials in {seconds:.1f} s: {[(t['params'], round(t['score'], 3)) for t in result.trials]}"
            f"; launches {launches}; the rerun from the log {rerun_s:.2f} s, launches {rerun}")

    coords, values = mnist.mnist_digit_dataset((2,), mode="single")
    model = make_siren(2, dim_hidden=128, n_layers=6)  # the SIREN preset's widths, lr and batch (one step an epoch)
    res, seconds, launches = counted(lambda: Trainer(TrainConfig(batch_size=4096, epochs=200, lr=1e-4)).fit(
        model, coords, values))
    recon, grid_s, grid_launches = counted(lambda: evaluate_grid(model, (28, 28), lo=-1.0))
    q = evaluate_reconstruction(recon, values.reshape(28, 28), data_range=2.0)
    launches = {k: launches[k] + grid_launches[k] for k in launches}
    want = {**zero, "fused_mlp_forward": 201, "fused_mlp_backward": 200}
    if res.steps != 200 or launches != want or not math.isfinite(q["psnr"]) or recon.shape != (28, 28):
        fail(f"mnist_siren: {res.steps} steps, launches {launches} (expected {want}), PSNR {q['psnr']}")
    paths["mnist_siren"] = {"launches": launches, "wall_s": seconds + grid_s, "psnr": q["psnr"],
                            "first_loss": float(res.losses[0]), "final_loss": res.final_loss}
    log(f"[mnist_siren] SIREN 2 -> 128 x 6 -> 1 on a synthetic 28x28 digit: 200 steps in {res.wall_time_s:.3f} s, "
        f"loss {res.losses[0]:.5f} -> {res.final_loss:.5f}, PSNR {q['psnr']:.3f} dB; launches {launches}")


def check_grid_routes(paths: dict) -> dict:
    """The flagship's and ngp's fitted models, reloaded from their runs'
    checkpoints, on the (352, 352, 30) grid by both routes: the separable
    path, and kernel 1 per chunk (reached through ``transform=lambda x: x``,
    which turns the separable path off as in the JAX package), held to atol
    1e-4 (the flagship: eval-mode BatchNorm divides by running deviations)
    and 1e-5 (ngp's relu decoder); each route's ``device_eval_seconds`` and
    wall (one ``evaluate_grid`` after it) and its kernel-1 launches (0 and 29);
    and ``transport="u16"`` within one step, (max - min) / 65535, of f32."""
    from mri_interpolation_tpu_torch.infer import device_eval_seconds, evaluate_grid
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import restore_checkpoint

    out = {}
    # (path, model flags, atol, kernel-5 launches a grid: the flagship's norm decoder is plain torch)
    for name, kw, atol, k5 in (("flagship", {}, 1e-4, 0), ("ngp", NGP, 1e-5, GRID_CHUNKS)):
        model = make_hash_mlp(3, **kw)
        model.load_state_dict(restore_checkpoint(os.path.join(paths[name]["run_dir"], "checkpoints"))["model"])
        routes, vols = {}, {}
        for route, transform, k1 in (("separable", None, 0), ("kernel 1 per chunk", lambda x: x, GRID_CHUNKS)):
            device_s = device_eval_seconds(model, GRID, transform=transform)
            reset_counts()
            t0 = time.perf_counter()
            vols[route] = evaluate_grid(model, GRID, transform=transform)
            wall = time.perf_counter() - t0
            launches = read_counts()
            if launches["hash_encode_forward"] != k1 or launches["fused_mlp_forward"] != k5:
                fail(f"grid routes {name} {route}: launches {launches}")
            routes[route] = {"device_s": device_s, "wall_s": wall, "device_voxels_per_s": np.prod(GRID) / device_s,
                             "voxels_per_s": np.prod(GRID) / wall}
        err = float(np.abs(vols["separable"] - vols["kernel 1 per chunk"]).max())
        if not math.isfinite(err) or err > atol:
            fail(f"grid routes {name}: the separable and per-chunk volumes differ by {err} > {atol}")
        f32 = vols["separable"]
        u16 = evaluate_grid(model, GRID, transport="u16")
        step = float(f32.max() - f32.min()) / 65535.0
        uerr = float(np.abs(u16 - f32).max())
        if not math.isfinite(uerr) or uerr > step:
            fail(f"grid routes {name}: u16 differs from f32 by {uerr} > one step {step}")
        out[name] = {"routes": routes, "max_abs_diff": err, "atol": atol, "u16_max_abs_err": uerr, "u16_step": step}
        for route, r in routes.items():
            log(f"[grid routes] {name} {route}: device {r['device_s'] * 1e3:.3f} ms "
                f"({r['device_voxels_per_s']:,.0f} voxels/s), wall {r['wall_s'] * 1e3:.3f} ms "
                f"({r['voxels_per_s']:,.0f} voxels/s)")
        log(f"[grid routes] {name}: routes differ by {err:.3e} (atol {atol:g}); u16 error {uerr:.3e} "
            f"(step {step:.3e})")
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
    MODELS[name] = model
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
    step; one epoch of 15 frames for the multi-frame models; protocol_tv's
    on the first 200,000 voxels, not its even frames), one (352, 352, 30)
    grid evaluation of the flagship, paths A and B, ngp, protocol_tv and
    hash_siren, and the 15 (352, 352) frame grids of the multi-frame
    HashMLP (per frame), each under
    torch.profiler (which slows the host, so the busy shares are lower
    bounds)."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid
    from mri_interpolation_tpu_torch.infer import registration as R
    from mri_interpolation_tpu_torch.io import dataset_from_array, normalize_intensity, synthetic_volume
    from mri_interpolation_tpu_torch.io import even_frame_training_set
    from mri_interpolation_tpu_torch.models import (make_hash_mlp, make_hash_siren, make_multi_hash_mlp,
                                                    make_multi_siren, make_psf_siren, make_siren, make_warp_inr)
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
    ngp = make_hash_mlp(3, **NGP)
    protocol = make_hash_mlp(3, dim_hidden=64, n_layers=2, decoder="relu_plain", temporal_tv=0.01, **PROTOCOL)
    hash_siren = make_hash_siren(3, dim_hidden=64, n_layers=4,
                                 **{k: v for k, v in HASH_SIREN.items() if k not in ("dim", "finest_resolution")})
    psf = make_psf_siren(3, dim_hidden=256, n_layers=5, coordinates_spacing=[0.5 / (s - 1) for s in VOLUME])
    warp = make_warp_inr(3, **WARP)
    full4d = make_hash_mlp(4, decoder="relu_plain", **FULL4D)
    ds4 = dataset_from_array(synthetic_volume(FULL4D_VOLUME, seed=0))
    warp_coords, warp_values = even_frame_training_set(img)
    warp_ds = types.SimpleNamespace(coords=warp_coords, values=warp_values)
    frame = normalize_intensity(synthetic_volume(REG_FRAME, seed=5))
    reg_a, reg_b = (torch.from_numpy(f).cuda() for f in (frame, moved(frame, 6.0)))
    reg_even = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img[..., ::2], -1, 0))).cuda()
    fit = lambda model, d, cfg, n: lambda: Trainer(cfg).fit(model, d.coords[:n], d.values[:n])  # noqa: E731
    phases = (
        ("flagship train_step", fit(flagship, ds, TrainConfig(epochs=1), 200_000), 20),
        ("path A train_step", fit(siren, zc, TrainConfig(batch_size=4096, lr=1e-4), 20 * 4096), 20),
        ("path B train_step", fit(tcnn, ds, TrainConfig(lr=1e-2, optimizer="adam_tcnn"), 200_000), 20),
        ("ngp train_step", fit(ngp, ds, TrainConfig(lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                                                    cosine_t_max=2), 200_000), 20),
        ("protocol_tv train_step", fit(protocol, ds, TrainConfig(lr=1e-2, optimizer="adam_tcnn", weight_decay=1e-5,
                                                                 lr_schedule="cosine", cosine_t_max=1), 200_000), 20),
        ("hash_siren train_step", fit(hash_siren, zc, TrainConfig(batch_size=20_000, lr=1e-4), 400_000), 20),
        ("psf_siren train_step", fit(psf, zc, TrainConfig(batch_size=4096, lr=1e-4), 20 * 4096), 20),
        ("warp_protocol train_step", fit(warp, warp_ds, TrainConfig(
            lr=1e-2, optimizer="adam_tcnn", weight_decay=1e-5, lr_schedule="cosine", cosine_t_max=1), 200_000), 20),
        ("full4d train_step (batch 50,000)", fit(full4d, ds4, TrainConfig(
            batch_size=50_000, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=30), 20 * 50_000), 20),
        ("flagship grid_eval_352x352x30 (separable)", lambda: evaluate_grid(flagship, GRID), 1),
        ("protocol_tv grid_eval_352x352x30 (separable)", lambda: evaluate_grid(protocol, GRID), 1),
        ("hash_siren grid_eval_352x352x30", lambda: evaluate_grid(hash_siren, GRID, lo=-1.0), 1),
        ("warp_protocol grid_eval_352x352x30", lambda: evaluate_grid(warp, GRID), 1),
        ("path A grid_eval_352x352x30", lambda: evaluate_grid(siren, GRID, lo=-1.0), 1),
        ("path B grid_eval_352x352x30", lambda: evaluate_grid(tcnn, GRID), 1),
        ("ngp grid_eval_352x352x30 (separable)", lambda: evaluate_grid(ngp, GRID), 1),
        ("multi_hash_mlp train_step", lambda: Trainer(TrainConfig(lr=5e-3)).fit_frames(
            multi_hash, frame_coords, frame_values), 15),
        ("multi_siren train_step", lambda: Trainer(TrainConfig(lr=1e-4)).fit_frames(
            multi_siren, 2 * frame_coords - 1, 2 * frame_values - 1), 15),
        ("multi_hash_mlp grid_eval_352x352 x15", lambda: [evaluate_grid(multi_hash, FRAME, frame_idx=t)
                                                          for t in range(15)], 15),
        ("registration pair stage step (352x352, control 32x32)", lambda: R._register_stage(
            reg_a, reg_b, torch.zeros(32, 32, 2, device=reg_a.device), REG_LR, 1e-2, 20), 20),
        ("registration group stage step (8 x 352x352, control 32x32)", lambda: R._register_group_stage(
            reg_even, torch.zeros(8, 32, 32, 2, device=reg_a.device), REG_LR, 1e-2, 1e-1, 20), 20),
    )
    for phase, fn, per in phases:
        kernels, wall_ms = profile_device(fn)
        busy = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[profile] {phase}: wall {wall_ms / per:.3f} ms, device busy {busy / per:.3f} ms "
            f"({100 * busy / wall_ms:.1f}% busy, profiler on)")
        for k, (ms, n) in top:
            log(f"    {ms / per:9.4f} ms  x{n / per:5.1f}  {k[:90]}")


EXPORT_CHUNK = 1 << 15  # the JAX export's default chunk: (352, 352, 30) in 114 chunks
EXPORT_FRAME = 7  # the multi-frame artifact's frame
BF16_ATOL = 5e-3  # bf16 tables against float32 (tests/test_infer.py:210,220)


def model_of_run(launcher, argv, run_dir):
    """The model a ``launcher.main(argv)`` run fitted, rebuilt from its flags
    and its checkpoint, and whether its grid is zero-centred."""
    import torch
    from mri_interpolation_tpu_torch import configs
    from mri_interpolation_tpu_torch.train import restore_checkpoint

    args = launcher.build_parser().parse_args(argv)
    cfg = configs.default_siren_config() if args.config_preset == "siren" else configs.default_hash_config()
    cfg = configs.override_from_args(cfg, args)
    model = launcher.build_model(cfg, 3, torch.device("cuda"))
    model.load_state_dict(restore_checkpoint(os.path.join(run_dir, "checkpoints"))["model"])
    return model, cfg.zero_centered


def serve(name: str, model, shape, directory: str, expected: dict, lo: float = 0.0, frame_idx=None,
          chunk=None, table_dtype=None) -> dict:
    """Export ``model``'s evaluator over ``shape``, write and load it, run it
    with the counters at 0 just before and read just after (it must launch
    ``expected``), and hold it to ``evaluate_grid``'s per-chunk route (on
    the model with its tables cast to ``table_dtype``, if given) at the
    same chunk size (default ``EXPORT_CHUNK``; atol 1e-6); then time one
    more call of each. Returns
    the volume and the numbers."""
    import torch
    from mri_interpolation_tpu_torch.infer import evaluate_grid, export_evaluator_bytes, load_evaluator, quantize_tables

    kw = {} if frame_idx is None else {"frame_idx": frame_idx}
    chunk = EXPORT_CHUNK if chunk is None else chunk
    t0 = time.perf_counter()
    blob = export_evaluator_bytes(model, shape, lo=lo, chunk_size=chunk, table_dtype=table_dtype, **kw)
    export_s = time.perf_counter() - t0
    path = os.path.join(directory, f"{name}.pt2")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(blob)
    write_s = time.perf_counter() - t0
    del blob
    t0 = time.perf_counter()
    fn = load_evaluator(path)
    load_s = time.perf_counter() - t0
    vol, first_s, launches = counted(fn)
    if launches != expected:
        fail(f"export {name}: the artifact launched {launches}; expected {expected}")
    served = model if table_dtype is None else quantize_tables(model, table_dtype)
    ref = evaluate_grid(served, shape, lo=lo, chunk_size=chunk, transform=lambda x: x, **kw)
    err = float(np.abs(vol - ref).max())
    if vol.shape != ref.shape or not math.isfinite(err) or err > 1e-6:
        fail(f"export {name}: artifact {vol.shape} against evaluate_grid {ref.shape}: max abs err {err} > 1e-6")
    _, wall_s, _ = counted(fn)
    _, grid_s, _ = counted(lambda: evaluate_grid(served, shape, lo=lo, chunk_size=chunk, transform=lambda x: x, **kw))
    del served
    out = {"shape": list(shape), "chunks": -(-int(np.prod(shape)) // chunk), "bytes": os.path.getsize(path),
           "export_s": export_s, "write_s": write_s, "load_s": load_s, "first_call_s": first_s, "wall_s": wall_s,
           "evaluate_grid_s": grid_s, "max_abs_err": err, "launches": launches, "path": path}
    log(f"[export] {name}: {out['chunks']} chunks of {chunk:,d}; export + serialise {export_s:.3f} s, write "
        f"{write_s:.3f} s, load {load_s:.3f} s, {out['bytes']:,d} bytes; grid wall {wall_s * 1e3:.3f} ms (first call "
        f"{first_s * 1e3:.3f} ms) against evaluate_grid's per-chunk route {grid_s * 1e3:.3f} ms; max abs err {err:.3e} "
        f"(atol 1e-6); launches {launches}")
    return {"vol": vol, **out}


def keep_served_models(paths: dict) -> None:
    """The flagship's, path A's and path B's fitted models, rebuilt from their
    runs' checkpoints into ``MODELS`` for the export phase, which runs after
    the run directories are gone; and each grid's ``lo``."""
    from mri_interpolation_tpu_torch import launcher
    from mri_interpolation_tpu_torch.models import make_hash_mlp
    from mri_interpolation_tpu_torch.train import restore_checkpoint

    flagship = make_hash_mlp(3)
    flagship.load_state_dict(restore_checkpoint(os.path.join(paths["flagship"]["run_dir"], "checkpoints"))["model"])
    MODELS["flagship"] = (flagship, 0.0)
    common = ["--image_path", "unused.nii.gz", "--epochs", "1", "--interp_shapes", str(GRID)]
    for name, argv in (("A", ["--config_preset", "siren", *common]), ("B", [*TCNN_FLAGS, *common])):
        model, zero_centered = model_of_run(launcher, argv, paths[name]["run_dir"])
        MODELS[name] = (model, -1.0 if zero_centered else 0.0)


def drive_export(torch, paths: dict, plan: dict, zero: dict) -> None:
    """The serving export (``infer.save_evaluator``'s archive, ``load_evaluator``)
    on the card: the flagship's, path A's and path B's fitted models on the
    (352, 352, 30) grid in 114 chunks, the multi-frame HashMLP at frame 7,
    and full4d_resident's model (12,134,251 rows x F = 4) on (352, 352, 6, 30)
    at float32 and with bf16 tables, each artifact held to ``evaluate_grid``
    and launching each of its kernels once a chunk; the flagship's also
    against the separable route (atol 1e-4, as the grid routes), the bf16
    volume within 5e-3 of the float32 one, and the full-4D files against the
    plan's serving bytes."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid

    n = -(-int(np.prod(GRID)) // EXPORT_CHUNK)
    total = dict(zero)
    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        for name, want in (("flagship", {"hash_encode_forward": n}), ("A", {"fused_mlp_forward": n}),
                           ("B", {"hash_encode_forward": n, "fused_mlp_forward": n})):
            model, lo = MODELS.pop(name)
            rows[name] = serve(name, model, GRID, tmp, {**zero, **want}, lo=lo)
            if name == "flagship":
                err = float(np.abs(rows[name]["vol"] - evaluate_grid(model, GRID)).max())
                if not math.isfinite(err) or err > 1e-4:
                    fail(f"export flagship: the artifact and the separable route differ by {err} > 1e-4")
                log(f"[export] flagship against the separable route: max abs diff {err:.3e} (atol 1e-4)")
        m = -(-int(np.prod(FRAME)) // EXPORT_CHUNK)
        rows["multi_hash_mlp"] = serve("multi_hash_mlp", MODELS.pop("multi_hash_mlp"), FRAME, tmp,
                                       {**zero, "hash_encode_forward": m, "fused_mlp_forward": m},
                                       frame_idx=EXPORT_FRAME)
        model = MODELS.pop("full4d_resident")
        k = -(-int(np.prod(FULL4D_GRID)) // (1 << 17))
        want = {**zero, "hash_encode_forward": k, "fused_mlp_forward": k}
        f32 = serve("full4d_f32", model, FULL4D_GRID, tmp, want, chunk=1 << 17)
        bf16 = serve("full4d_bf16", model, FULL4D_GRID, tmp, want, chunk=1 << 17, table_dtype=torch.bfloat16)
        rows.update(full4d_f32=f32, full4d_bf16=bf16)
        err = float(np.abs(bf16["vol"] - f32["vol"]).max())
        if not math.isfinite(err) or err > BF16_ATOL:
            fail(f"export full4d: bf16 tables move the volume by {err} > {BF16_ATOL}")
        serving, table = plan["serving"], plan["bytes"]["table"]
        over32, over16 = f32["bytes"] - serving["artifact_f32_bytes"], bf16["bytes"] - serving["artifact_bf16_table_bytes"]
        shrink = f32["bytes"] - bf16["bytes"]
        if over32 < 0 or over16 < 0 or shrink <= 0.4 * table:
            fail(f"export full4d: files {f32['bytes']:,d} / {bf16['bytes']:,d} bytes against the plan's "
                 f"{serving['artifact_f32_bytes']:,d} / {serving['artifact_bf16_table_bytes']:,d}; bf16 saves {shrink:,d} "
                 f"of 0.4 x {table:,d}")
        log(f"[export] full4d: bf16 tables move the volume by {err:.3e} (atol {BF16_ATOL}); files {f32['bytes']:,d} / "
            f"{bf16['bytes']:,d} bytes, {over32:,d} / {over16:,d} above the plan's serving bytes "
            f"({serving['artifact_f32_bytes']:,d} / {serving['artifact_bf16_table_bytes']:,d}); bf16 saves {shrink:,d} "
            f"bytes = {shrink / table:.3f} x the float32 table's {table:,d}")
        del model
        for row in rows.values():
            for key in total:
                total[key] += row["launches"][key]
            del row["vol"]
    MODELS.clear()
    paths["export"] = {"launches": total, "artifacts": rows}


def check_native_load(paths: dict, volumes) -> None:
    """The launcher's whole-volume load (``io.load_volume``) through the native
    codec against ``use_native=False`` (numpy) on each file: max |delta| of
    the coordinates and the values within 2^-23 of the largest magnitude
    (an ulp: the codec scales by a reciprocal and steps its grid by a
    product), shapes and pixdim equal; the seconds of each."""
    from mri_interpolation_tpu_torch.io import load_volume

    for path in volumes:
        t0 = time.perf_counter()
        fast = load_volume(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        slow = load_volume(path, use_native=False)
        numpy_s = time.perf_counter() - t0
        errs = {k: float(np.abs(getattr(fast, k) - getattr(slow, k)).max() / np.abs(getattr(slow, k)).max())
                for k in ("coords", "values")}
        if fast.shape != slow.shape or fast.pixdim != slow.pixdim or max(errs.values()) > 2.0**-23:
            fail(f"native load {path}: shapes {fast.shape} / {slow.shape}, pixdim {fast.pixdim} / {slow.pixdim}, "
                 f"max relative |delta| {errs} (limit 2^-23)")
        paths.setdefault("native_load", {"launches": {k: 0 for k in SOURCES}})[os.path.basename(path)] = {
            "native_s": native_s, "numpy_s": numpy_s, **errs}
        log(f"[native] load_volume {os.path.basename(path)} {fast.shape}: native codec {native_s:.3f} s, numpy "
            f"{numpy_s:.3f} s ({numpy_s / native_s:.2f}x); max |delta| / max |x|: coords {errs['coords']:.3e}, values "
            f"{errs['values']:.3e} (limit 2^-23 = {2.0**-23:.3e})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from mri_interpolation_tpu_torch import bench_kernels, launcher, native
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
    t0 = time.perf_counter()
    log(f"[build] native NIfTI codec (g++): {native.build()} in {time.perf_counter() - t0:.2f} s")
    probe_row = check_probe(torch, pr, dev)
    log(f"[build] probe kernel exact against 2 * x on {pr.PROBE_SHAPE}: kernel {probe_row['ms']} ms, "
        f"plain {probe_row['plain_ms']:.4f} ms, torch.mul {probe_row['library_ms']} ms")
    for who, st in probe_row["launch_stats"].items():
        if isinstance(st, dict):
            log(f"[build] {who}: {st['launches']} launches ({st['source']}): median {st['median_us']:.3f} us, "
                f"quartiles {st['p25_us']:.3f}-{st['p75_us']:.3f} us, range {st['min_us']:.3f}-{st['max_us']:.3f} us")
    log(f"[build] probe slower than torch.mul beyond the spread (its p25 > mul's p75): "
        f"{probe_row['launch_stats']['probe_slower_beyond_spread']}; than an empty kernel: "
        f"{probe_row['launch_stats']['probe_above_empty_beyond_spread']}; floor (byte bound or an empty launch) "
        f"{probe_row['launch_floor_ms'] * 1e3:.3f} us")

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
    for name, krows in check_ngp_hash_kernels(torch, he, dev).items():
        rows[name].extend(krows)
    for name, krows in check_slice_hash_kernels(torch, he, dev).items():
        rows[name].extend(krows)
    for name, krows in check_full4d_hash_kernels(torch, he, dev).items():
        rows[name].extend(krows)
    warp_rows, coord_grad_rows = check_warp_hash_kernels(torch, he, dev)
    for name, krows in warp_rows.items():
        rows[name].extend(krows)
    rows.update(check_fused_mlp(torch, fm, dev))
    for name, krows in check_grid_frames(torch, he, fm, dev).items():
        rows[name].extend(krows)
    rows["probe"] = [probe_row]
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    # 4. small fits, card vs CPU
    t0 = time.perf_counter()
    rels = small_fits(torch)
    rels.update(small_option_fits(torch))
    rels.update(small_fit_frames_match_cpu(torch))
    rels.update(small_zoo_fits(torch))
    rels.update({f"fit_streaming {k}": v for k, v in check_streaming_card_vs_cpu(torch).items()})
    log(f"[small fit] 10 steps each, card vs CPU loss curves, max rel diff (rtol {FIT_RTOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f" in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_registration_card_vs_cpu(torch)
    log(f"[registration] card vs CPU done in {time.perf_counter() - t0:.1f} s")

    # 5. main paths
    zero = {name: 0 for name in SOURCES}
    paths = {}
    img = dataset_from_array(synthetic_volume(VOLUME, seed=0)).image()
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
            185, 10_000, {**zero, "hash_encode_forward": 185, "hash_encode_table_grad": 185, "probe": 1})
        paths["A"] = drive_path(
            "path A", "launcher.main --config_preset siren",
            lambda: cli(launcher, ["--config_preset", "siren", "--output_root", os.path.join(tmp, "a"), *common]),
            453, 4096, {**zero, "fused_mlp_forward": 453 + CHUNKS, "fused_mlp_backward": 453, "probe": 1})
        paths["B"] = drive_path(
            "path B", "launcher.main with the tcnn flags",
            lambda: cli(launcher, [*TCNN_FLAGS, "--output_root", os.path.join(tmp, "b"), *common]),
            185, 10_000, {**zero, "hash_encode_forward": 185 + CHUNKS, "hash_encode_table_grad": 185,
                          "fused_mlp_forward": 185 + CHUNKS, "fused_mlp_backward": 185, "probe": 1})
        drive_ngp_paths(path, tmp, zero, paths)
        drive_held_out_paths(path, tmp, zero, paths)
        drive_slice_nine_paths(path, img, tmp, zero, paths)
        drive_slice_ten_paths(path, img, tmp, zero, paths)
        check_grid_routes(paths)
        t0 = time.perf_counter()
        plan = drive_full4d(torch, tmp, zero, paths)
        log(f"[full4d] done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        drive_tooling(torch, path, tmp, zero, paths)
        log(f"[tooling] done in {time.perf_counter() - t0:.1f} s")
        check_native_load(paths, [path, os.path.join(tmp, "synthetic_352x352x6x15.nii")])
        keep_served_models(paths)

    # the kernel bench: each timed call runs once to check, 3 times to warm up, ITERS times timed
    calls = 1 + 3 + bench_kernels.ITERS
    paths["bench"] = drive_bench({**zero, "probe": calls, "fused_mlp_forward": 3 * calls, "fused_mlp_backward": calls,
                                  "hash_encode_coarse_forward": 3 * calls, "hash_encode_coarse_table_grad": calls})

    # the multi-frame paths: 2 epochs x 15 frames, then one (352, 352) grid chunk per frame
    paths["multi_hash_mlp"] = drive_frames(
        "multi_hash_mlp", lambda: make_multi_hash_mlp(**MULTI_HASH), TrainConfig(epochs=2, lr=5e-3), img, False,
        {**zero, "hash_encode_forward": 30 + 15, "hash_encode_table_grad": 30, "fused_mlp_forward": 30 + 15,
         "fused_mlp_backward": 30})
    paths["multi_siren"] = drive_frames(
        "multi_siren", lambda: make_multi_siren(**MULTI_SIREN), TrainConfig(epochs=2, lr=1e-4), img, True,
        {**zero, "fused_mlp_forward": 2 * 30 + 2 * 15, "fused_mlp_backward": 2 * 30})

    # the serving export: artifacts of the fitted models, each launch counted
    t0 = time.perf_counter()
    drive_export(torch, paths, plan, zero)
    log(f"[export] done in {time.perf_counter() - t0:.1f} s")

    # 6. where the time goes: device time by kernel over short fits and grid evaluations
    t0 = time.perf_counter()
    profile_main_paths(torch)
    log(f"[profile] done in {time.perf_counter() - t0:.1f} s")
    for row in coord_grad_rows:
        log(f"[profile] warp coordinate gradient (phase 3), N={row['n']:,d}: {row['device_ms']:.4f} ms of device time "
            f"a call, {row['call_ms']:.4f} ms a call; one call a training step")

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
