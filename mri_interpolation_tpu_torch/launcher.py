"""The launcher: load -> fit -> reconstruct -> interpolate -> report.

Port of ``mri_interpolation_tpu/launcher.py``: load a NIfTI volume and take
its training set: every voxel; with ``even_frames_only`` the even frames,
their time coordinate remapped to their place in the whole volume; with
``undersample_pct`` a random share of those voxels (``utils.create_rn_mask``
seeded by ``seed``). Build the configured model (the PSF SIREN gets the
half-voxel spacing ``0.5 / max(s - 1, 1)`` of the first three axes; hash
resolution tuples of another rank than the encoded axes, all of the
volume's for the hash models and its spatial ones for the warp INR, are
derived from their sizes), or
resume it from ``checkpoint_path``: parameters and buffers, with a fresh
optimizer and schedule. Fit it with ``Trainer.fit`` (per-step losses into
``scalars.jsonl``; every ``eval_every_epochs`` epochs the PSNR of a strided
subsample of at most ~100k training voxels; every
``checkpoint_every_epochs`` epochs a checkpoint with the optimizer state).
Reconstruct the volume on its own grid (``pred.nii.gz``; with
``save_latents`` and an encode/decode split, the encoder's features too,
``latents.nii.gz``), score PSNR/SSIM against the whole volume (with
``even_frames_only`` also ``odd_*`` against the held-out odd frames),
evaluate each ``interp_shapes`` grid (``interpolation{shape}.nii.gz``,
rank-adapted to the volume), and write ``config.txt``, ``metrics.json`` and
the final checkpoint (``train/checkpoint.py``) into a versioned run
directory. Before a run it checks the kernels' build with the probe kernel
(``ops.probe.check_build``). Everything runs on ``cuda`` unless
``device="cpu"`` (``--device cpu``) is passed.

Usage:
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        [--config_preset siren] [--enco_config_path cfg.json] [--epochs 10] ...
    # resume from a run's checkpoints (its latest step)
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        --checkpoint_path runs/version_0/checkpoints ...
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import configs
from .configs import RunConfig
from .device import DeviceLike, resolve_device
from .utils.imaging import create_rn_mask

__all__ = ["build_parser", "run", "main", "make_run_dir", "build_model"]

_HASH_MODELS = ("hash_mlp", "HashMLP", "hash_siren", "HashSirenNet", "TcnnHashMLP")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--enco_config_path", type=str, default=None,
                        help="path to a tcnn-style JSON encoding config")
    parser.add_argument("--config_yaml", type=str, default=None,
                        help="YAML run configs are not ported yet (ROADMAP.md, queue 1)")
    parser.add_argument("--config_preset", type=str, default="hash", choices=["hash", "siren"],
                        help="base config preset")
    parser.add_argument("--plan", action="store_true",
                        help="the capacity plan is not ported yet (ROADMAP.md, queue 1)")
    parser.add_argument("--device", type=str, default=None,
                        help="device to run on: cuda (the default) or cpu")
    configs.add_config_flags(parser, RunConfig())
    return parser


def make_run_dir(root: str) -> str:
    """Versioned run dir: root/version_N."""
    os.makedirs(root, exist_ok=True)
    existing = [int(d.split("_")[1]) for d in os.listdir(root)
                if d.startswith("version_") and d.split("_")[1].isdigit()]
    path = os.path.join(root, f"version_{max(existing) + 1 if existing else 0}")
    os.makedirs(path)
    return path


def build_model(cfg: RunConfig, dim_in: int, device: torch.device, coordinates_spacing=None):
    """The configured model on ``device``; each factory gets only the keyword
    arguments its signature takes (``coordinates_spacing`` among them, where
    given)."""
    from .models import get_model_factory

    factory = get_model_factory(cfg.model_class)
    accepted = inspect.signature(factory).parameters
    kwargs = {**cfg.model_kwargs(), "dim_in": dim_in}
    if coordinates_spacing is not None:
        kwargs["coordinates_spacing"] = coordinates_spacing
    return factory(**{k: v for k, v in kwargs.items() if k in accepted}, device=device)


def _check_ported(cfg: RunConfig) -> None:
    for name in ("shard_tables", "data_parallel", "tb_events"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md, queue 1")
    if cfg.stream_shard_voxels > 0:
        raise NotImplementedError("stream_shard_voxels is not ported yet: ROADMAP.md, queue 1")


def _make_eval_fn(coords: np.ndarray, values: np.ndarray, zero_centered: bool, device: torch.device):
    """``eval_fn(model) -> {"psnr": dB}`` on every ``max(1, N // 100_000)``-th
    training voxel, all of them in one forward (the JAX launcher's)."""
    from .infer import predict_batched

    stride = max(1, len(coords) // 100_000)
    ev_c = np.ascontiguousarray(coords[::stride])
    ev_v = np.ascontiguousarray(values[::stride])
    data_range = 2.0 if zero_centered else 1.0

    def eval_fn(m):
        y = predict_batched(m, ev_c, chunk_size=len(ev_c), device=device)
        mse = float(np.mean((y - ev_v) ** 2))
        return {"psnr": 10.0 * np.log10(data_range**2 / max(mse, 1e-12))}

    return eval_fn


def run(cfg: RunConfig, run_dir: Optional[str] = None, device: DeviceLike = None) -> dict:
    """Execute the pipeline; returns the summary also written to metrics.json."""
    from .infer import evaluate_grid, has_split
    from .io import even_frame_split, even_frame_training_set, load_volume, nifti
    from .metrics import evaluate_reconstruction
    from .ops.probe import check_build
    from .train import TrainConfig, Trainer, restore_checkpoint, save_checkpoint

    dev = resolve_device(device)
    _check_ported(cfg)
    check_build(dev)
    cfg = dataclasses.replace(cfg)
    run_dir = run_dir or make_run_dir(cfg.output_root)

    # ----- data
    slice_axes = None
    if cfg.slice_z is not None:
        slice_axes = (slice(None), slice(None), cfg.slice_z, slice(None))
    ds = load_volume(cfg.image_path, zero_centered=cfg.zero_centered, slice_axes=slice_axes)
    full_image = ds.image()
    if cfg.even_frames_only:
        train_coords, train_values = even_frame_training_set(full_image, cfg.zero_centered)
    else:
        train_coords, train_values = ds.coords, ds.values
    if cfg.undersample_pct > 0.0:
        _, kept = create_rn_mask((len(train_values),), cfg.undersample_pct, key=cfg.seed)
        train_coords = np.ascontiguousarray(train_coords[kept])
        train_values = np.ascontiguousarray(train_values[kept])
    dim_in = ds.dim_in
    cfg.dim_in = dim_in
    # Resolution tuples whose rank differs from the encoded axes' are derived
    # from the volume's shape with the reference's base:finest ratio (~1/5.5);
    # the warp INR encodes the spatial axes alone (time drives its deformation).
    encoded = None
    if cfg.model_class in _HASH_MODELS:
        encoded = tuple(ds.shape)
    elif cfg.model_class == "warp_inr":
        encoded = tuple(ds.shape[:-1])
    base = cfg.base_resolution
    if encoded is not None and isinstance(base, (tuple, list)) and len(base) != len(encoded):
        cfg.finest_resolution = tuple(int(s) for s in encoded)
        cfg.base_resolution = tuple(max(2, round(s / 5.5)) for s in encoded)
    spacing = tuple(0.5 / max(s - 1, 1) for s in ds.shape[:3])  # the PSF's half-voxel extents
    model = build_model(cfg, dim_in, dev, coordinates_spacing=spacing)

    # ----- resume: parameters and buffers; the optimizer and schedule start afresh
    if cfg.checkpoint_path:
        model.load_state_dict(restore_checkpoint(cfg.checkpoint_path)["model"])

    # ----- fit
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    tc = TrainConfig(
        batch_size=cfg.batch_size, epochs=cfg.epochs, lr=cfg.lr, weight_decay=cfg.weight_decay,
        seed=cfg.seed, optimizer=cfg.optimizer, lr_schedule=cfg.lr_schedule,
        cosine_t_max=cfg.cosine_t_max, accumulate_grad_batches=cfg.accumulate_grad_batches,
        loss=cfg.loss, log_jsonl=os.path.join(run_dir, "scalars.jsonl"),
        checkpoint_dir=ckpt_dir if cfg.save_checkpoint else None,
        checkpoint_every_epochs=cfg.checkpoint_every_epochs, eval_every_epochs=cfg.eval_every_epochs,
        remat=cfg.remat,
    )
    eval_fn = None
    if cfg.eval_every_epochs > 0:
        eval_fn = _make_eval_fn(train_coords, train_values, cfg.zero_centered, dev)
    result = Trainer(tc).fit(model, train_coords, train_values, device=dev, eval_fn=eval_fn)

    # ----- reconstruction + quality
    lo = -1.0 if cfg.zero_centered else 0.0
    data_range = 2.0 if cfg.zero_centered else 1.0
    latents = None
    t0 = time.perf_counter()
    if cfg.save_latents and has_split(model):
        recon, latents = evaluate_grid(model, ds.shape, lo=lo, device=dev, return_latents=True)
    else:
        recon = evaluate_grid(model, ds.shape, lo=lo, device=dev)
    recon_s = time.perf_counter() - t0
    if latents is not None:
        nifti.save(latents.astype(np.float32), os.path.join(run_dir, "latents.nii.gz"), pixdim=ds.pixdim)
    nifti.save(recon.astype(np.float32), os.path.join(run_dir, "pred.nii.gz"), pixdim=ds.pixdim)
    quality = evaluate_reconstruction(recon, full_image, data_range=data_range, device=dev)
    if cfg.even_frames_only:  # the held-out odd frames
        _, odd = even_frame_split(full_image)
        _, odd_pred = even_frame_split(recon)
        odd_q = evaluate_reconstruction(odd_pred[..., :odd.shape[-1]], odd, data_range=data_range, device=dev)
        quality = {**quality, **{f"odd_{k}": v for k, v in odd_q.items()}}

    # ----- dense-grid interpolation
    interp_shapes = [tuple(s) for s in cfg.interp_shapes]
    for i, shape in enumerate(interp_shapes):
        if len(shape) != dim_in:
            # keep the volume's grid, double the temporal axis
            interp_shapes[i] = tuple(ds.shape[:-1]) + (2 * ds.shape[-1],)
    interp_s = {}
    for shape in dict.fromkeys(interp_shapes):
        t0 = time.perf_counter()
        interp = evaluate_grid(model, shape, lo=lo, device=dev)
        interp_s[str(shape)] = time.perf_counter() - t0
        nifti.save(interp.astype(np.float32),
                   os.path.join(run_dir, f"interpolation{tuple(shape)}.nii.gz"), pixdim=ds.pixdim)

    # ----- provenance + metrics + checkpoint
    configs.export_to_txt(cfg, run_dir + os.sep)
    summary = {
        "model": model.name,
        "device": str(dev),
        "param_count": sum(p.numel() for p in model.parameters()),
        "steps": result.steps,
        "batch_size": min(cfg.batch_size, len(train_values)),
        "train_voxels": len(train_values),
        "final_loss": result.final_loss,
        "train_wall_s": result.wall_time_s,
        "train_hook_s": result.hook_time_s,
        "steady_steps_per_sec": result.steady_steps_per_sec,
        "recon_eval_s": recon_s,
        "interp_eval_s": interp_s,
        **quality,
        **({"coordinates_spacing": list(spacing)} if "coordinates_spacing" in getattr(model, "hparams", {}) else {}),
        "run_dir": run_dir,
    }
    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if cfg.save_checkpoint:
        save_checkpoint(ckpt_dir, result.steps, model.state_dict())
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """CLI entry: preset -> JSON config -> flags -> :func:`run`; prints the
    summary as JSON and returns it."""
    args = build_parser().parse_args(argv)
    if args.config_yaml:
        raise NotImplementedError("--config_yaml is not ported yet: ROADMAP.md, queue 1")
    if args.plan:
        raise NotImplementedError("--plan is not ported yet: ROADMAP.md, queue 1")
    cfg = configs.default_siren_config() if args.config_preset == "siren" else configs.default_hash_config()
    if args.enco_config_path:
        cfg = configs.apply_enco_config(cfg, configs.load_json_config(args.enco_config_path))
    cfg = configs.override_from_args(cfg, args)
    summary = run(cfg, device=args.device)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
