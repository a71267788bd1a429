"""``--full4d``: the full-volume 4-D fits through the launcher and the 4-D
even-frame protocol (port of ``scripts/experiments.py:392-470``,
``run_full4d``). The launcher's run directories go under
``<out_dir>/full4d``."""

from __future__ import annotations

import json
import os
import time

from .. import launcher
from ..configs import RunConfig
from ..device import DeviceLike, resolve_device
from ..infer import linear_interpolate_volume
from ..metrics import evaluate_reconstruction
from ..models import make_hash_mlp, make_warp_inr
from ..train import TrainConfig
from ..train.protocols import even_frame_fit_eval
from . import common

__all__ = ["run_full4d"]

_WARP4D = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2),
               finest_resolution=(352, 352, 6), dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
               warp_w0=5.0, warp_scale=0.05)


def run_full4d(out: dict, k: float, image_path: str = common.SAMPLE, out_dir: str = common.OUT_DIR,
               device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    fits = []
    for epochs in (int(30 * k) or 2, int(60 * k) or 3):
        cfg = RunConfig(
            image_path=image_path, model_class="hash_mlp", batch_size=50000, epochs=epochs,
            n_levels=5, n_features_per_level=4, growth="paper", decoder="relu_plain",
            optimizer="adam_tcnn", lr=1e-2, lr_schedule="cosine", cosine_t_max=epochs,
            output_root=os.path.join(out_dir, "full4d"), save_checkpoint=False,
            # the 2x temporal super-resolution grid for the 30-epoch recipe only (the launcher's default)
            interp_shapes=((352, 352, 30),) if epochs <= int(30 * k) else (),
        )
        t0 = time.time()
        summary = launcher.run(cfg, device=dev)
        fits.append({
            "name": f"full4d {epochs}ep recipe",
            "epochs": epochs,
            "psnr": round(summary["psnr"], 2),
            "ssim": round(summary.get("ssim", float("nan")), 4),
            "steady_steps_per_sec": round(summary["steady_steps_per_sec"], 1),
            "wall_s": round(time.time() - t0, 1),
        })
        print(json.dumps(fits[-1]), flush=True)
        out["full4d"] = {**out.get("full4d", {}), "fits": fits}
        common.save_results(out, out_dir)

    # 4-D even-frame protocol (train data[..., ::2], evaluate the held-out odd frames)
    img = common.load_volume(image_path).image()  # the whole (X, Y, Z, T) volume
    ep = int(30 * k) or 2
    protocol = []

    def tc(epochs):
        return TrainConfig(batch_size=50000, epochs=epochs, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                           cosine_t_max=epochs, weight_decay=1e-5)

    def run_proto(name, model, cfg):
        _, q = even_frame_fit_eval(model, img, cfg, device=dev)
        protocol.append(common.protocol_row(name, q))
        out["full4d"] = {**out.get("full4d", {}), "protocol": protocol}
        common.save_results(out, out_dir)

    run_proto("hash_mlp (t-res capped)",
              make_hash_mlp(dim_in=4, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                            base_resolution=(64, 64, 2, 2), finest_resolution=(352, 352, 6, 8),
                            growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev),
              tc(ep))
    run_proto("warp_inr (motion-compensated)", make_warp_inr(dim_in=4, **_WARP4D, device=dev), tc(2 * ep))
    run_proto("warp_inr (+ residual + accel prior)",
              make_warp_inr(dim_in=4, **_WARP4D, residual_scale=0.05, warp_accel=1.0, device=dev), tc(2 * ep))

    lin = linear_interpolate_volume(img[..., ::2], img.shape, device=dev)
    odd_lin = evaluate_reconstruction(lin[..., 1::2], img[..., 1::2], device=dev)
    protocol.append(common.protocol_row("classical linear interpolation", {"odd": odd_lin}, full=False))

    out["full4d"] = {**out.get("full4d", {}), "fits": fits, "protocol": protocol, "batch": 50000, "epochs": ep}
