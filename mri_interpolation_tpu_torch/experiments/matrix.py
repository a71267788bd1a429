"""The default subcommand: the 2-D+t model-zoo matrix, the even-frame
interpolation protocol and the profiler traces (port of
``scripts/experiments.py:85-378``, ``run_2dt``).

Every row keeps the JAX script's name, model and ``TrainConfig``; ``k``
scales the epoch budgets as there (``--fast`` is 0.2). The traces are
``torch.profiler`` Chrome traces under ``<out_dir>/traces/``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..infer import evaluate_grid, linear_interpolate_volume
from ..metrics import evaluate_reconstruction, param_count
from ..models import (make_freq_mlp, make_gabor_net, make_hash_mlp, make_hash_siren, make_mlp, make_modulated_siren,
                      make_multi_hash_mlp, make_multi_siren, make_psf_siren, make_rff_net, make_siren, make_warp_inr)
from ..train import TrainConfig, Trainer
from ..train.protocols import ensembled_warp_fit_eval, even_frame_fit_eval, registration_interp_eval
from ..utils import capture_trace
from . import common

__all__ = ["run_2dt"]

# the flagship geometry at F = 4 (rows 9, 11-12, the traces) and the warp INR of the protocol rows
_DENSE_F4 = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 5),
                 finest_resolution=(352, 352, 15), dim_hidden=64, n_layers=2)
_WARP = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64),
             finest_resolution=(352, 352), dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3, warp_w0=5.0,
             warp_scale=0.05)


def run_2dt(out: dict, k: float, image_path: str = common.SAMPLE, out_dir: str = common.OUT_DIR,
            device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    fit = lambda name, model, cfg, ds, **kw: common.fit_and_eval(name, model, cfg, ds, device=dev, **kw)  # noqa: E731
    ds01 = common.load_volume(image_path, slice_axes=common.SLICE)  # [0,1] coords/values
    ds11 = common.load_volume(image_path, zero_centered=True, slice_axes=common.SLICE)  # [-1,1]
    rows = []

    # 1. flagship HashMLP, canonical config (auto/dense storage)
    rows.append(fit(
        "hash_mlp (dense storage)",
        make_hash_mlp(dim_in=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                      base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                      dim_hidden=64, n_layers=2, device=dev),
        TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=5e-3), ds01))

    # 2. same, reference-exact hashed storage
    rows.append(fit(
        "hash_mlp (reference hashed)",
        make_hash_mlp(dim_in=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                      base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                      dim_hidden=64, n_layers=2, storage="hashed", device=dev),
        TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=5e-3), ds01))

    # 3. tcnn-style config (16 levels x 2 feats, per_level_scale 1.4, relu decoder)
    rows.append(fit(
        "hash_mlp (tcnn config)",
        make_hash_mlp(dim_in=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                      base_resolution=16, finest_resolution=None, per_level_scale=1.4,
                      dim_hidden=128, n_layers=2, decoder="relu_plain", device=dev),
        TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=1e-2, optimizer="adam_tcnn"), ds01))

    # 4. SIREN (test_script-scale: 352 wide)
    rows.append(fit(
        "siren 352x5", make_siren(dim_in=3, dim_hidden=352, n_layers=5, w0=30.0, device=dev),
        TrainConfig(batch_size=20000, epochs=int(50 * k) or 2, lr=1e-4), ds11, lo=-1.0, data_range=2.0))

    # 5. modulated siren
    rows.append(fit(
        "modulated_siren 256x4", make_modulated_siren(dim_in=3, dim_hidden=256, n_layers=4, device=dev),
        TrainConfig(batch_size=20000, epochs=int(30 * k) or 2, lr=1e-4), ds11, lo=-1.0, data_range=2.0))

    # 6. RFF net
    rows.append(fit(
        "rff_net 256f",
        make_rff_net(dim_in=3, dim_hidden=256, n_layers=4, n_frequencies=256, sigma=10.0, device=dev),
        TrainConfig(batch_size=20000, epochs=int(30 * k) or 2, lr=1e-4), ds01))

    # 7. FreqMLP (legacy 4D model, siren encoders + skip connection)
    rows.append(fit(
        "freq_mlp (siren enc)",
        make_freq_mlp(dim_in=3, dim_hidden=352, n_layers=4, encoder_type="siren", n_frequencies=352,
                      n_frequencies_t=15, skip_connections=(2,), device=dev),
        TrainConfig(batch_size=20000, epochs=int(30 * k) or 2, lr=1e-3, weight_decay=1e-5), ds01))

    # 8. Gabor / WIRE with the SIREN-scaled auto init
    rows.append(fit(
        "gabor 256x4", make_gabor_net(dim_in=3, dim_hidden=256, n_layers=4, device=dev),
        TrainConfig(batch_size=20000, epochs=int(50 * k) or 2, lr=3e-4), ds11, lo=-1.0, data_range=2.0))

    # 9. quality-tuned dense hash
    rows.append(fit(
        "hash_mlp (dense, F=4)", make_hash_mlp(dim_in=3, **_DENSE_F4, device=dev),
        TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=5e-3), ds01))

    # 10. the Instant-NGP-class rows: full-resolution dense levels (paper growth), tcnn Adam + cosine
    for F in (8, 4, 2):
        rows.append(fit(
            f"hash_mlp (TPU-native NGP: 3L F{F} paper+cosine)",
            make_hash_mlp(dim_in=3, n_levels=3, n_features_per_level=F, log2_hashmap_size=23,
                          base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                          growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev),
            TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=1e-2, optimizer="adam_tcnn",
                        lr_schedule="cosine", cosine_t_max=int(50 * k) or 2), ds01))

    # 11-12. decoder ablation at the flagship budget: the reference's "norm" decoder normalises the OUTPUT block
    # too; norm_proper normalises hidden blocks only
    for dec in ("norm_proper", "relu_plain"):
        rows.append(fit(
            f"hash_mlp (dense F=4, decoder={dec})", make_hash_mlp(dim_in=3, **_DENSE_F4, decoder=dec, device=dev),
            TrainConfig(batch_size=10000, epochs=int(50 * k) or 2, lr=5e-3), ds01))

    # 13. ReLU MLP, the reference test_script's config
    rows.append(fit(
        "mlp 352x8 (test_script config)", make_mlp(dim_in=3, dim_hidden=352, n_layers=8, device=dev),
        TrainConfig(batch_size=20000, epochs=int(50 * k) or 2, lr=1e-4), ds01))

    # 14. PSF-SIREN: slice-profile objective (125x coordinate expansion)
    spacing = tuple(0.5 / max(s - 1, 1) for s in ds11.shape[:3])
    rows.append(fit(
        "psf_siren 256x5 (5^3 PSF)",
        make_psf_siren(dim_in=3, dim_hidden=256, n_layers=5, coordinates_spacing=spacing, n_sample=5, device=dev),
        TrainConfig(batch_size=4096, epochs=int(10 * k) or 1, lr=1e-4), ds11, lo=-1.0, data_range=2.0))

    # 15. HashSirenNet: all-dense 2D..3D levels under log2 17
    rows.append(fit(
        "hash_siren 64x4 (10L dense)",
        make_hash_siren(dim_in=3, dim_hidden=64, n_layers=4, n_levels=10, log2_hashmap_size=17,
                        base_resolution=16, per_level_scale=1.4, device=dev),
        TrainConfig(batch_size=20000, epochs=int(30 * k) or 2, lr=1e-4), ds11, lo=-1.0, data_range=2.0))

    # 16/17. multi-frame models: one whole frame per step
    img2d = ds01.image()
    T = img2d.shape[-1]
    xs_ = np.linspace(0, 1, img2d.shape[0], dtype=np.float32)
    ys_ = np.linspace(0, 1, img2d.shape[1], dtype=np.float32)
    X_, Y_ = np.meshgrid(xs_, ys_, indexing="ij")
    coords2d = np.stack([X_.reshape(-1), Y_.reshape(-1)], axis=-1)
    frame_values = np.stack([img2d[..., t].reshape(-1, 1) for t in range(T)], axis=0)

    def fit_frames_row(name, model, cfg, coords, vals, lo, unmap):
        t0 = time.time()
        res = Trainer(cfg).fit_frames(model, coords, vals, device=dev)
        vols = [evaluate_grid(model, img2d.shape[:2], lo=lo, frame_idx=t, device=dev) for t in range(T)]
        recon = unmap(np.stack(vols, axis=-1))
        q = evaluate_reconstruction(recon, img2d, data_range=1.0, device=dev)
        row = {"name": name, "params": param_count(model), "epochs": cfg.epochs,
               "batch": coords.shape[-2], "steady_steps_per_sec": round(res.steady_steps_per_sec, 1),
               "voxel_evals_per_sec": round(res.steady_steps_per_sec * coords.shape[-2], 0),
               "final_loss": round(res.final_loss, 6), "psnr": round(q["psnr"], 2),
               "ssim": round(q.get("ssim", float("nan")), 4), "wall_s": round(time.time() - t0, 1)}
        print(json.dumps(row), flush=True)
        rows.append(row)

    fit_frames_row("multi_siren 128x4 (15 frame encoders)",
                   make_multi_siren(dim_in=2, dim_hidden=128, n_layers=4, n_frames=T, device=dev),
                   TrainConfig(batch_size=coords2d.shape[0], epochs=int(150 * k) or 2, lr=1e-4),
                   coords2d * 2.0 - 1.0, frame_values * 2.0 - 1.0, -1.0, lambda v: (v + 1.0) / 2.0)
    fit_frames_row("multi_hash_mlp (15 frame encoders, 10L dense)",
                   make_multi_hash_mlp(dim_in=2, n_frames=T, n_levels=10, n_features_per_level=2,
                                       log2_hashmap_size=17, base_resolution=16, per_level_scale=1.4,
                                       dim_hidden=64, n_layers=2, device=dev),
                   TrainConfig(batch_size=coords2d.shape[0], epochs=int(100 * k) or 2, lr=5e-3),
                   coords2d, frame_values, 0.0, lambda v: v)

    # --- even-frame interpolation protocol: INR variants against the classical baseline (train on
    # data[..., ::2], evaluate the held-out odd frames)
    img = ds01.image()
    ep = int(50 * k) or 2
    protocol = []

    def run_proto(name, model, tc):
        _, q = even_frame_fit_eval(model, img, tc, device=dev)
        protocol.append(common.protocol_row(name, q))

    def warp_tc(epochs):
        return TrainConfig(batch_size=10000, epochs=epochs, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                           cosine_t_max=epochs, weight_decay=1e-5)

    # a) time resolution capped at the trained frame grid
    run_proto("hash_mlp (t-res capped)",
              make_hash_mlp(dim_in=3, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                            base_resolution=(64, 64, 2), finest_resolution=(352, 352, 7),
                            dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev),
              warp_tc(ep))
    # b) full time resolution + temporal-TV table prior
    run_proto("hash_mlp (full t-res + temporal TV)",
              make_hash_mlp(dim_in=3, n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                            base_resolution=(64, 64, 2), finest_resolution=(352, 352, 15),
                            growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain",
                            temporal_tv=0.01, device=dev),
              warp_tc(ep))
    # c) motion-compensated warp INR (canonical anatomy + smooth deformation)
    run_proto("warp_inr (motion-compensated)", make_warp_inr(dim_in=3, **_WARP, device=dev), warp_tc(2 * ep))
    # d) + appearance residual + temporal-acceleration prior (the warp sweep's winner)
    run_proto("warp_inr (+ residual + accel prior)",
              make_warp_inr(dim_in=3, **_WARP, residual_scale=0.05, warp_accel=1.0, device=dev), warp_tc(2 * ep))
    # e) seed ensemble of (d); each fit draws its init from its seed
    q = ensembled_warp_fit_eval(
        lambda seed: make_warp_inr(dim_in=3, **_WARP, residual_scale=0.05, warp_accel=1.0, seed=seed, device=dev),
        img, warp_tc(2 * ep), seeds=(1337, 7, 23, 99), device=dev)
    protocol.append(common.protocol_row("warp_inr ensemble (4 seeds)", q))
    # f) pairwise symmetric registration: held-out frames as motion-compensated midpoints of the observed
    # neighbours
    _, reg_q = registration_interp_eval(img, device=dev)
    protocol.append(common.protocol_row("registration midpoint (pairwise)", reg_q, full=False))

    even = img[..., ::2]
    lin = linear_interpolate_volume(even, img.shape, device=dev)
    odd_lin = evaluate_reconstruction(lin[..., 1::2], img[..., 1::2], device=dev)
    protocol.append(common.protocol_row("classical linear interpolation", {"odd": odd_lin}, full=False))

    out["rows"] = rows
    out["protocol"] = protocol

    # --- profiler traces of a training step of the flagship (dense F=4, relu_plain) and the NGP F8 config
    xb = torch.as_tensor(ds01.coords[:10000]).to(dev)
    yb = torch.as_tensor(ds01.values[:10000]).to(dev)
    for tag, model in [
        ("flagship_dense_f4", make_hash_mlp(dim_in=3, **_DENSE_F4, decoder="relu_plain", device=dev)),
        ("tpu_native_ngp_3l_f8", make_hash_mlp(
            dim_in=3, n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(64, 64, 5),
            finest_resolution=(352, 352, 15), growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain",
            device=dev)),
    ]:
        def step(model=model):
            model.zero_grad(set_to_none=True)
            torch.mean((model(xb) - yb) ** 2).backward()

        step()  # kernel builds and warm-up outside the trace
        capture_trace(step, os.path.join(out_dir, "traces", tag), iters=3)
        print(f"trace: {os.path.join(out_dir, 'traces', tag)}", flush=True)

    # the inference trace: the grid-aligned separable path and the copy to the host
    infer_model = make_hash_mlp(dim_in=3, **_DENSE_F4, decoder="relu_plain", device=dev)
    evaluate_grid(infer_model, ds01.shape, device=dev)  # warm-up
    trace_dir = os.path.join(out_dir, "traces", "grid_eval_fastpath")
    capture_trace(evaluate_grid, trace_dir, infer_model, ds01.shape, device=dev, iters=3)
    print(f"trace: {trace_dir}", flush=True)
