"""Motion-compensated temporal interpolation demo (port of
``examples/motion_interpolation.py``).

Builds a synthetic moving-blob sequence, trains the warp INR on the EVEN
frames only, and compares the held-out odd frames against classical linear
interpolation: the reference's even-frame protocol on content where motion
matters. Then the stacked fusion of the registration and linear families,
with its confidence map's calibration.

    python -m mri_interpolation_tpu_torch.examples.motion_interpolation [--epochs 80] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..infer import linear_interpolate_volume
from ..metrics import evaluate_reconstruction
from ..models import make_warp_inr
from ..train import TrainConfig
from ..train.protocols import even_frame_fit_eval
from ..train.stacking import _linear_family, _registration_family, stacked_interp_eval

__all__ = ["make_sequence", "main"]


def make_sequence(n: int = 32, T: int = 9) -> np.ndarray:
    """A Gaussian blob moving along x: (n, n, T) float32."""
    xs = np.linspace(0, 1, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    centers = np.linspace(0.25, 0.75, T)
    frames = [np.exp(-(((X - c) ** 2 + (Y - 0.5) ** 2) / 0.02)).astype(np.float32) for c in centers]
    return np.stack(frames, axis=-1)  # (n, n, T)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.examples.motion_interpolation")
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    vol = make_sequence()
    model = make_warp_inr(dim_in=3, n_levels=3, n_features_per_level=4, log2_hashmap_size=14,
                          base_resolution=(8, 8), finest_resolution=(32, 32),
                          dim_hidden=32, n_layers=2, warp_hidden=32, warp_layers=3,
                          warp_scale=0.3, device=dev)
    cfg = TrainConfig(batch_size=2048, epochs=args.epochs, lr=5e-3, optimizer="adam_tcnn",
                      lr_schedule="cosine", cosine_t_max=args.epochs, seed=0)
    _, q = even_frame_fit_eval(model, vol, cfg, device=dev)

    lin = linear_interpolate_volume(vol[..., ::2], vol.shape, device=dev)
    odd_lin = evaluate_reconstruction(lin[..., 1::2], vol[..., 1::2], device=dev)
    print(f"warp_inr  held-out odd-frame PSNR: {q['odd']['psnr']:.2f} dB")
    print(f"linear    held-out odd-frame PSNR: {odd_lin['psnr']:.2f} dB")
    assert q["odd"]["psnr"] > odd_lin["psnr"], "warp model should beat linear on moving content"
    print("motion interpolation beats linear interpolation — OK")

    # the stacked fusion of the registration and linear families (the warp families join on real data)
    fams = {"registration": _registration_family(ctrl_sizes=(4, 8), pyramid=(2, 1), steps=150, device=dev),
            "linear": _linear_family()}
    _, sq = stacked_interp_eval(vol, cfg, families=fams, device=dev)
    print(f"stacked   held-out odd-frame PSNR: {sq['odd']['psnr']:.2f} dB (weights {sq['weights']['global']})")
    # the fusion's confidence map (family disagreement; no ground truth used) ranks the true error
    cal = sq["uncertainty"]["calibration"]
    print(f"confidence map calibration: Spearman rho {cal['spearman_rho']:.3f} "
          f"(sigma_mean {sq['uncertainty']['sigma_mean']:.4f})")
    return {"warp_odd_psnr": q["odd"]["psnr"], "linear_odd_psnr": odd_lin["psnr"], "stacked_odd_psnr": sq["odd"]["psnr"],
            "spearman_rho": cal["spearman_rho"]}


if __name__ == "__main__":
    main()
