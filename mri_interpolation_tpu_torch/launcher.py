"""The launcher: load -> fit -> reconstruct -> interpolate -> report.

Port of the default branch of ``mri_interpolation_tpu/launcher.py``: load a
NIfTI volume, fit the configured model with ``Trainer.fit``, reconstruct the
volume on its own grid (``pred.nii.gz``), score PSNR/SSIM, evaluate each
``interp_shapes`` grid (``interpolation{shape}.nii.gz``, rank-adapted to the
volume), and write ``config.txt``, ``metrics.json`` and a ``torch.save``
checkpoint into a versioned run directory. Before a run it checks the
kernels' build with the probe kernel (``ops.probe.check_build``). Everything
runs on ``cuda`` unless ``device="cpu"`` (``--device cpu``) is passed.

Usage:
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        [--config_preset siren] [--enco_config_path cfg.json] [--epochs 10] ...
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

__all__ = ["build_parser", "run", "main", "make_run_dir", "build_model"]

_HASH_MODELS = ("hash_mlp", "HashMLP", "TcnnHashMLP")


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


def build_model(cfg: RunConfig, dim_in: int, device: torch.device):
    """The configured model on ``device``; each factory gets only the keyword
    arguments its signature takes."""
    from .models import get_model_factory

    factory = get_model_factory(cfg.model_class)
    accepted = inspect.signature(factory).parameters
    kwargs = {k: v for k, v in {**cfg.model_kwargs(), "dim_in": dim_in}.items() if k in accepted}
    return factory(**kwargs, device=device)


def _check_ported(cfg: RunConfig) -> None:
    for name in ("shard_tables", "data_parallel", "even_frames_only"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md, queue 1")
    if cfg.stream_shard_voxels > 0:
        raise NotImplementedError("stream_shard_voxels is not ported yet: ROADMAP.md, queue 1")
    if cfg.undersample_pct > 0.0:
        raise NotImplementedError("undersample_pct is not ported yet: ROADMAP.md, queue 1")


def run(cfg: RunConfig, run_dir: Optional[str] = None, device: DeviceLike = None) -> dict:
    """Execute the pipeline; returns the summary also written to metrics.json."""
    from .infer import evaluate_grid
    from .io import load_volume, nifti
    from .metrics import evaluate_reconstruction
    from .ops.probe import check_build
    from .train import TrainConfig, Trainer

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
    dim_in = ds.dim_in
    cfg.dim_in = dim_in
    # Resolution tuples that do not match the volume's rank are derived from
    # its shape with the reference's base:finest ratio (~1/5.5).
    if cfg.model_class in _HASH_MODELS:
        base = cfg.base_resolution
        if isinstance(base, (tuple, list)) and len(base) != dim_in:
            cfg.finest_resolution = tuple(int(s) for s in ds.shape)
            cfg.base_resolution = tuple(max(2, round(s / 5.5)) for s in ds.shape)
    model = build_model(cfg, dim_in, dev)

    # ----- fit
    tc = TrainConfig(
        batch_size=cfg.batch_size, epochs=cfg.epochs, lr=cfg.lr, weight_decay=cfg.weight_decay,
        seed=cfg.seed, optimizer=cfg.optimizer, lr_schedule=cfg.lr_schedule,
        cosine_t_max=cfg.cosine_t_max, accumulate_grad_batches=cfg.accumulate_grad_batches,
        loss=cfg.loss,
    )
    result = Trainer(tc).fit(model, ds.coords, ds.values, device=dev)

    # ----- reconstruction + quality
    lo = -1.0 if cfg.zero_centered else 0.0
    data_range = 2.0 if cfg.zero_centered else 1.0
    t0 = time.perf_counter()
    recon = evaluate_grid(model, ds.shape, lo=lo, device=dev)
    recon_s = time.perf_counter() - t0
    nifti.save(recon.astype(np.float32), os.path.join(run_dir, "pred.nii.gz"), pixdim=ds.pixdim)
    quality = evaluate_reconstruction(recon, ds.image(), data_range=data_range, device=dev)

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
        "batch_size": min(cfg.batch_size, len(ds)),
        "final_loss": result.final_loss,
        "train_wall_s": result.wall_time_s,
        "steady_steps_per_sec": result.steady_steps_per_sec,
        "recon_eval_s": recon_s,
        "interp_eval_s": interp_s,
        **quality,
        "run_dir": run_dir,
    }
    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if cfg.save_checkpoint:
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save({"step": result.steps, "model": model.state_dict()},
                   os.path.join(ckpt_dir, f"step_{result.steps}.pt"))
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
