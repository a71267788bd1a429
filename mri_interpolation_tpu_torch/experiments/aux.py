"""``--aux``: the two-phase protocol and the sparse-acquisition
(undersampling) rows (port of ``scripts/experiments.py:473-528``,
``run_aux``)."""

from __future__ import annotations

import json

from ..device import DeviceLike, resolve_device
from ..infer import evaluate_grid
from ..metrics import evaluate_reconstruction
from ..models import make_hash_mlp, make_warp_inr
from ..train import TrainConfig
from ..train.protocols import two_phase_hash_fit, undersampled_fit_eval
from . import common

__all__ = ["run_aux"]


def run_aux(out: dict, k: float, image_path: str = common.SAMPLE, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    ds01 = common.load_volume(image_path, slice_axes=common.SLICE)
    img = ds01.image()

    # two-phase hash training (the reference's legacy protocol): pretrain on key frames {3, 7, 13}, then
    # decoder-FROZEN completion on the full data. The model trains in place, so phase 1's reconstruction is
    # taken between the phases.
    model = make_hash_mlp(dim_in=3, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                          base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                          dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev)
    recon = {}
    two_phase_hash_fit(
        model, ds01.coords, ds01.values, img.shape,
        pretrain_config=TrainConfig(batch_size=10000, epochs=int(15 * k) or 1, lr=5e-3),
        train_config=TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=5e-3), device=dev,
        between_phases=lambda m: recon.update(phase1=evaluate_grid(m, img.shape, device=dev)))
    q1 = evaluate_reconstruction(recon["phase1"], img, device=dev)
    q2 = evaluate_reconstruction(evaluate_grid(model, img.shape, device=dev), img, device=dev)
    two_phase = {"phase1_psnr": round(q1["psnr"], 2), "phase2_psnr": round(q2["psnr"], 2),
                 "phase2_ssim": round(q2.get("ssim", float("nan")), 4)}
    print(json.dumps({"two_phase": two_phase}), flush=True)

    # sparse-acquisition protocol: fit from 30% / 50% randomly kept voxels
    undersample = []
    ep = int(50 * k) or 2
    for pct in (50.0, 30.0):
        for name, model, tc in [
            ("hash_mlp (NGP 3L F4)",
             make_hash_mlp(dim_in=3, n_levels=3, n_features_per_level=4, log2_hashmap_size=23,
                           base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                           growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev),
             TrainConfig(batch_size=10000, epochs=ep, lr=1e-2, optimizer="adam_tcnn",
                         lr_schedule="cosine", cosine_t_max=ep)),
            ("warp_inr",
             make_warp_inr(dim_in=3, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                           base_resolution=(64, 64), finest_resolution=(352, 352),
                           dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
                           warp_w0=5.0, warp_scale=0.05, residual_scale=0.05, device=dev),
             TrainConfig(batch_size=10000, epochs=2 * ep, lr=1e-2, optimizer="adam_tcnn",
                         lr_schedule="cosine", cosine_t_max=2 * ep, weight_decay=1e-5)),
        ]:
            _, rep = undersampled_fit_eval(model, img, percentage=pct, config=tc, device=dev)
            row = {"name": name, "kept_pct": pct,
                   "psnr": round(rep["recon"]["psnr"], 2),
                   "ssim": round(rep["recon"].get("ssim", float("nan")), 4),
                   "zero_filled_psnr": round(rep["zero_filled"]["psnr"], 2)}
            print(json.dumps(row), flush=True)
            undersample.append(row)

    out["aux"] = {"two_phase": two_phase, "undersample": undersample}
