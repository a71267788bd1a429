"""The warp INR's held-out interpolation sweep (port of
``scripts/warp_sweep.py``): the motion-compensated model's levers on the
2-D+t even-frame protocol (temporal-acceleration and smoothness priors, the
residual, capacity, schedule length, coarse-to-fine, seed ensembles and
linear blends), written into ``<out_dir>/results.json`` under
``"warp_sweep"`` and rendered into ``<out_dir>/RESULTS.md``.

    python -m mri_interpolation_tpu_torch.experiments.warp_sweep [--fast] [--image_path P] [--out_dir D] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from ..device import resolve_device
from ..infer import linear_interpolate_volume
from ..metrics import evaluate_reconstruction
from ..models import make_warp_inr
from ..train import TrainConfig
from ..train.protocols import ensembled_warp_fit_eval, even_frame_fit_eval
from . import common
from .render import write_results_md

__all__ = ["BASE", "main"]

BASE = dict(dim_in=3, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
            base_resolution=(64, 64), finest_resolution=(352, 352),
            dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
            warp_w0=5.0, warp_scale=0.05, residual_scale=0.05)


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments.warp_sweep")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--image_path", default=common.SAMPLE)
    ap.add_argument("--out_dir", default=common.OUT_DIR)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    k = 0.1 if args.fast else 1.0
    dev = resolve_device(args.device)

    img = common.load_volume(args.image_path, slice_axes=common.SLICE).image()
    rows = []

    def tc(ep, seed=1337):
        return TrainConfig(batch_size=10000, epochs=ep, lr=1e-2, optimizer="adam_tcnn",
                           lr_schedule="cosine", cosine_t_max=ep, weight_decay=1e-5, seed=seed)

    def record(name, ep, q, t0):
        rows.append({"name": name, "epochs": ep,
                     "odd_psnr": round(q["odd"]["psnr"], 3),
                     "odd_ssim": round(q["odd"].get("ssim", float("nan")), 4),
                     "full_psnr": round(q["full"]["psnr"], 2),
                     "wall_s": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)

    def run(name, ep=100, seed=1337, **kw):
        ep = int(ep * k) or 2
        t0 = time.time()
        # the JAX trainer draws the init from the config's seed; the port's factory takes it
        _, q = even_frame_fit_eval(make_warp_inr(**{**BASE, **kw}, seed=seed, device=dev), img, tc(ep, seed),
                                   device=dev)
        record(name, ep, q, t0)

    run("base (residual 0.05)")
    run("base, 300 epochs", ep=300)
    run("+ warp_smooth 1e-2", warp_smooth=1e-2)
    run("+ warp_accel 1", warp_accel=1.0)
    run("+ warp_accel 3", warp_accel=3.0)
    run("+ warp_accel 1 + smooth 1e-2", warp_accel=1.0, warp_smooth=1e-2)
    run("F8 canonical", n_features_per_level=8)
    run("residual_w0 2", residual_w0=2.0)
    run("warp_hidden 128 + accel 1", warp_hidden=128, warp_accel=1.0)
    run("warp_scale 0.1 + accel + smooth", warp_scale=0.1, warp_accel=1.0, warp_smooth=1e-2)
    run("+ residual_accel 10 + accel 1", warp_accel=1.0, residual_accel=10.0)
    run("warp_t_scale 0.5 + accel 1", warp_t_scale=0.5, warp_accel=1.0)
    run("accel 1, 200 epochs", ep=200, warp_accel=1.0)
    run("base seed 7 (noise floor)", seed=7)
    # the coarse-to-fine curriculum on the canonical encoder
    run("+ anneal 600 + accel 1", warp_accel=1.0, level_anneal_steps=600)
    run("+ anneal 1800 + accel 1", warp_accel=1.0, level_anneal_steps=1800)

    # seed ensemble and linear blends of the best single config (accel 1)
    best = dict(BASE, warp_accel=1.0, level_anneal_steps=600)
    ep = int(100 * k) or 2
    for blend, name in ((0.0, "ENSEMBLE of 4 seeds (accel 1 + anneal 600)"),
                        (0.2, "ensemble + 0.2 linear blend")):
        t0 = time.time()
        q = ensembled_warp_fit_eval(lambda seed: make_warp_inr(**best, seed=seed, device=dev), img, tc(ep),
                                    seeds=(1337, 7, 23, 99), linear_blend=blend, device=dev)
        record(name, ep, q, t0)

    lin = linear_interpolate_volume(img[..., ::2], img.shape, device=dev)
    lq = evaluate_reconstruction(lin[..., 1::2], img[..., 1::2], device=dev)
    rows.append({"name": "classical linear interpolation", "epochs": 0,
                 "odd_psnr": round(lq["psnr"], 3),
                 "odd_ssim": round(lq.get("ssim", float("nan")), 4),
                 "full_psnr": float("nan"), "wall_s": 0.0})

    out = common.load_results(args.out_dir)
    out["warp_sweep"] = rows
    common.save_results(out, args.out_dir)
    write_results_md(out, args.out_dir)
    print(f"wrote warp_sweep into {args.out_dir}/results.json and RESULTS.md")
    return rows


if __name__ == "__main__":
    main()
