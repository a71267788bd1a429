"""Occlusion-aware transfer probe, a measured negative result (port of
``scripts/occlusion_probe.py``).

The motion-transfer family resamples the two kept frames that bracket an
odd time along the warp INR's motion and blends them by the time fraction
tau. This probe asks whether a per-voxel choice between the two aligned
resamples (occlusion-aware side selection) recovers quality, on the ankle's
2-D+t even-frame protocol with the stacked protocol's deployment warp fits
(4 seeds):

- the oracle ceilings (the per-voxel best side, the per-voxel best tau:
  they read the odd frames, so they are context, never a result row);
- the ground-truth-free signals: the fixed-point inversion residual, the
  seeds' disagreement, the warp INR's own prediction as arbiter (and a soft
  projection onto it), and photometric gap-crossing error maps at the kept
  frames.

Every score is a PSNR against the odd frames in float64, rounded to 2
decimals; the resampling runs in float32 on the device without gradients.
The result goes into ``<out_dir>/results.json`` under ``"occlusion_probe"``
and ``<out_dir>/RESULTS.md`` is rendered again.

    python -m mri_interpolation_tpu_torch.experiments.occlusion_probe [--image_path P] [--cache_dir C]
        [--out_dir D] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..infer.registration import _base_grid, _sample
from ..train import TrainConfig
from ..train.stacking import _coords_for_frames, _fit_warp_memoized, _gaussian_smooth, load_cached_prediction
from . import common
from .render import write_results_md

__all__ = ["CFG", "SEEDS", "WK", "CACHE_DIR", "occlusion_probe", "main"]

# the exact deployment fits of the stacked protocol's primary warp family
CFG = TrainConfig(batch_size=10000, epochs=100, lr=1e-2, optimizer="adam_tcnn",
                  lr_schedule="cosine", cosine_t_max=100, weight_decay=1e-5)
SEEDS = (1337, 7, 23, 99)
WK = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
          dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
          warp_scale=0.05, residual_scale=0.05,
          base_resolution=(64, 64), finest_resolution=(352, 352),
          warp_w0=5.0, warp_accel=1.0, level_anneal_steps=600)
CACHE_DIR = "runs/stacked_cache_ep100_anneal"  # the stacked protocol's cache, whose deploy_warp is the INR arbiter


def occlusion_probe(image: np.ndarray, cfg: TrainConfig = CFG, seeds: Sequence[int] = SEEDS,
                    warp_kwargs: dict = WK, cache_dir: Optional[str] = CACHE_DIR,
                    device: DeviceLike = None) -> dict:
    """The probe on a 2-D+t ``image`` (X, Y, T): fit the warp INR on the even
    frames once per seed (``train.stacking._fit_warp_memoized``, whose memo
    and disk cache may return a fit without training), transport the
    bracketing kept frames to every odd time, and score the side-selection
    rules. The two INR-arbiter rows need ``cache_dir``'s ``deploy_warp``
    prediction and are left out without it. Returns the rounded PSNRs."""
    dev = resolve_device(device)
    even, odd = image[..., ::2], image[..., 1::2].astype(np.float64)
    t_full = image.shape[-1]
    t_keep = np.asarray([2 * j / (t_full - 1) for j in range(even.shape[-1])])
    t_odd = np.asarray([(2 * j + 1) / (t_full - 1) for j in range(t_full // 2)])
    spatial = even.shape[:-1]
    coords = _coords_for_frames(spatial, t_keep)
    values = np.moveaxis(even, -1, 0).reshape(-1, 1)
    models = [_fit_warp_memoized(cfg, s, coords, values, 3, warp_kwargs, dev) for s in seeds]
    grid = _base_grid(spatial, dev).reshape(-1, len(spatial))

    @torch.no_grad()
    def invert_and_sample(warp_field, t, k_src, tk_src, fp_iters=8):
        """Transport kept frame k_src to time t along the motion; returns
        (resample, fixed-point residual magnitude)."""
        t_col = torch.full((grid.shape[0], 1), t, dtype=torch.float32, device=dev)
        c = grid + warp_field(torch.cat([grid, t_col], dim=-1))
        tk_col = torch.full((c.shape[0], 1), tk_src, dtype=c.dtype, device=dev)
        y = c
        for _ in range(fp_iters):
            y = c - warp_field(torch.cat([y, tk_col], dim=-1))
        r = y + warp_field(torch.cat([y, tk_col], dim=-1)) - c
        resid = torch.sqrt((r ** 2).sum(-1)).cpu().numpy().reshape(spatial)
        frame = torch.as_tensor(np.asarray(even[..., k_src], np.float32), device=dev)
        f = _sample(frame, y.reshape(spatial + (len(spatial),))).cpu().numpy()
        return f, resid

    gapidx = np.asarray([min(max(int(np.searchsorted(t_keep, t) - 1), 0), len(t_keep) - 2) for t in t_odd])
    tau = np.asarray([(t - t_keep[j]) / (t_keep[j + 1] - t_keep[j]) for t, j in zip(t_odd, gapidx)], np.float32)

    T = len(t_odd)
    t0 = time.time()
    F1 = np.zeros((len(seeds),) + spatial + (T,), np.float32)
    F2 = np.zeros_like(F1)
    R1 = np.zeros_like(F1)
    R2 = np.zeros_like(F1)
    for si, model in enumerate(models):
        for ti, (t, j) in enumerate(zip(t_odd, gapidx)):
            F1[si, ..., ti], R1[si, ..., ti] = invert_and_sample(model.warp_field, float(t), j, float(t_keep[j]))
            F2[si, ..., ti], R2[si, ..., ti] = invert_and_sample(model.warp_field, float(t), j + 1,
                                                                 float(t_keep[j + 1]))
        print(f"seed {seeds[si]} resamples {time.time() - t0:.0f}s", flush=True)

    # photometric gap-crossing validity maps at the KEPT frames
    K = len(t_keep)
    EL = np.zeros(spatial + (K - 1,), np.float32)
    ER = np.zeros_like(EL)
    for j in range(K - 1):
        tr = np.mean([invert_and_sample(m.warp_field, float(t_keep[j]), j + 1, float(t_keep[j + 1]))[0]
                      for m in models], axis=0)
        tl = np.mean([invert_and_sample(m.warp_field, float(t_keep[j + 1]), j, float(t_keep[j]))[0]
                      for m in models], axis=0)
        ER[..., j] = np.abs(tr - even[..., j])
        EL[..., j] = np.abs(tl - even[..., j + 1])
    print(f"photometric maps {time.time() - t0:.0f}s", flush=True)

    def psnr(x):
        return float(-10 * np.log10(np.mean((x - odd) ** 2)))

    m1, m2 = F1.mean(0), F2.mean(0)
    lin = (1 - tau) * m1 + tau * m2
    probe = {"transfer_baseline": round(psnr(lin), 2)}

    # oracle ceilings (they read the odd frames: context only, never a result row)
    pick = np.where(np.abs(m1 - odd) <= np.abs(m2 - odd), m1, m2)
    probe["oracle_best_side"] = round(psnr(pick), 2)
    den = m1 - m2
    wstar = np.clip(np.where(np.abs(den) > 1e-8, (odd - m2) / np.where(np.abs(den) > 1e-8, den, 1.0), 0.5), 0, 1)
    probe["oracle_per_voxel_tau"] = round(psnr(wstar * m1 + (1 - wstar) * m2), 2)

    # ground-truth-free side-selection signals
    probe["pick_by_fp_residual"] = round(psnr(np.where(R1.mean(0) <= R2.mean(0), m1, m2)), 2)
    probe["pick_by_seed_sigma"] = round(psnr(np.where(F1.std(0) <= F2.std(0), m1, m2)), 2)
    warp_inr = load_cached_prediction(cache_dir, "deploy_warp")
    if warp_inr is not None:
        d1 = np.abs(m1 - warp_inr)
        d2 = np.abs(m2 - warp_inr)
        probe["pick_by_inr_arbiter"] = round(psnr(np.where(d1 <= d2, m1, m2)), 2)
        proj_w = np.clip(np.where(np.abs(den) > 1e-6, (warp_inr - m2) / np.where(np.abs(den) > 1e-6, den, 1.0), 0.5),
                         0, 1)
        proj = proj_w * m1 + (1 - proj_w) * m2
        probe["inr_projection_blend_075"] = round(psnr(0.25 * lin + 0.75 * proj), 2)
    ELs = np.stack([_gaussian_smooth(EL[..., j], 4.0) for j in gapidx], -1)
    ERs = np.stack([_gaussian_smooth(ER[..., j], 4.0) for j in gapidx], -1)
    w1 = (1 - tau) * np.exp(-ELs / 0.1)
    w2 = tau * np.exp(-ERs / 0.1)
    probe["photometric_soft"] = round(psnr((w1 * m1 + w2 * m2) / np.maximum(w1 + w2, 1e-12)), 2)
    return probe


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments.occlusion_probe")
    ap.add_argument("--image_path", default=common.SAMPLE)
    ap.add_argument("--cache_dir", default=CACHE_DIR, help="the stacked protocol's cache (its deploy_warp)")
    ap.add_argument("--out_dir", default=common.OUT_DIR)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    img = common.load_volume(args.image_path, slice_axes=common.SLICE).image()
    probe = occlusion_probe(img, cache_dir=args.cache_dir, device=dev)
    print(json.dumps(probe, indent=2))
    out = common.load_results(args.out_dir)
    out["occlusion_probe"] = probe
    common.save_results(out, args.out_dir)
    write_results_md(out, args.out_dir)
    print(f"wrote occlusion_probe into {args.out_dir}/results.json and RESULTS.md")
    return probe


if __name__ == "__main__":
    main()
