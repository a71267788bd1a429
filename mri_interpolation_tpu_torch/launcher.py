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
``checkpoint_every_epochs`` epochs a checkpoint with the optimizer state),
or with ``stream_shard_voxels`` > 0 out of core with
``Trainer.fit_streaming`` (that many voxels on the device at a time; the
whole grid, so not with ``even_frames_only`` or ``undersample_pct``). In a
process group of more than one rank (``torchrun``: the launcher joins the
group its environment describes, NCCL on the card, gloo with ``--device
cpu``) it takes the JAX launcher's parallel branches, in its order:
``shard_tables`` (``parallel.ShardedHashTrainer``; not with streaming or a
level anneal), then streaming with ``data_parallel``
(``DataParallelTrainer.fit_streaming``), then ``data_parallel``
(``DataParallelTrainer.fit``); at world size 1 both flags fall through to
the single-device fits, as the JAX launcher does on one device. Rank 0
alone evaluates the fitted model and writes the run directory; the other
ranks return the fit's summary. Reconstruct the volume on its own grid (``pred.nii.gz``,
and ``pred.png`` for a 2-D volume; with ``save_latents`` and an
encode/decode split, the encoder's features too, ``latents.nii.gz``), score
PSNR/SSIM against the whole volume (with ``even_frames_only`` also
``odd_*`` against the held-out odd frames), evaluate each ``interp_shapes``
grid (``interpolation{shape}.nii.gz``, rank-adapted to the volume), with
``tb_events`` export ``scalars.jsonl`` as a TensorBoard event file under
``tb/``, and write ``config.txt``, ``metrics.json`` and the final
checkpoint (``train/checkpoint.py``) into a versioned run directory. Before
a run it checks the kernels' build with the probe kernel
(``ops.probe.check_build``). Everything runs on ``cuda`` unless
``device="cpu"`` (``--device cpu``) is passed. ``--plan`` prints the
capacity plan (``plan.py``) for the configuration and runs nothing.

``pred.png`` differs from the JAX package's matplotlib figure: the pixels
of ``recon.T`` (row 0 at the top, as ``imshow`` draws it) min-max onto
matplotlib's viridis table (``io/png.py``), with no axes or margins.

Usage:
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        [--config_preset siren] [--config_yaml run.yaml] [--enco_config_path cfg.json] [--epochs 10] ...
    # resume from a run's checkpoints (its latest step)
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        --checkpoint_path runs/version_0/checkpoints ...
    # out of core, 4,194,304 voxels on the device at a time
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz --stream_shard_voxels 4194304 ...
    # data-parallel over two CPU processes (gloo)
    torchrun --nproc_per_node 2 -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz \
        --device cpu --data_parallel true ...
    # the capacity plan alone, for 4 cards of 80 GB
    python -m mri_interpolation_tpu_torch.launcher --image_path vol.nii.gz --plan --plan_devices 4 ...
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

__all__ = ["build_parser", "run", "main", "make_run_dir", "build_model", "plan_from_config"]

_HASH_MODELS = ("hash_mlp", "HashMLP", "hash_siren", "HashSirenNet", "TcnnHashMLP")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--enco_config_path", type=str, default=None,
                        help="path to a tcnn-style JSON encoding config")
    parser.add_argument("--config_yaml", type=str, default=None,
                        help="path to a hydra-style YAML run config (configs.load_yaml_config)")
    parser.add_argument("--config_preset", type=str, default="hash", choices=["hash", "siren"],
                        help="base config preset")
    parser.add_argument("--plan", action="store_true",
                        help="don't run: print the capacity plan (per-level table bytes, step residency, "
                             "sharding layout, scaling-path recommendations) for this config")
    parser.add_argument("--plan_devices", type=int, default=1, help="device count the --plan sharding assumes")
    parser.add_argument("--plan_hbm_gb", type=float, default=80.0,
                        help="per-card memory budget --plan checks against (H100: 80)")
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


def _check_branches(cfg: RunConfig, world: int) -> None:
    """The refusals of the branch the JAX launcher takes at this world
    size, before any file is read."""
    if cfg.shard_tables and world > 1:
        if cfg.stream_shard_voxels > 0:
            raise ValueError("--stream_shard_voxels does not compose with --shard_tables")
        if cfg.level_anneal_steps > 0:
            raise ValueError("--level_anneal_steps does not compose with --shard_tables")
    elif cfg.stream_shard_voxels > 0 and (cfg.even_frames_only or cfg.undersample_pct > 0):
        raise ValueError("--stream_shard_voxels streams the FULL volume grid; it does not compose with "
                         "--even_frames_only / --undersample_pct")


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
    from .io import even_frame_split, even_frame_training_set, load_volume, nifti, png
    from .metrics import evaluate_reconstruction
    from .ops.probe import check_build
    from .parallel import mesh as pmesh
    from .train import TrainConfig, Trainer, restore_checkpoint, save_checkpoint

    pmesh.init_from_env(device)
    world = pmesh.world_size()
    mesh = pmesh.make_mesh(device=device) if world > 1 else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    _check_branches(cfg, world)
    check_build(dev)
    cfg = dataclasses.replace(cfg)
    if writer:
        run_dir = run_dir or make_run_dir(cfg.output_root)
    if mesh is not None:  # every rank reports rank 0's run directory
        shared = [run_dir]
        torch.distributed.broadcast_object_list(shared, src=0, group=mesh.group)
        run_dir = shared[0]

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
    # a single-device fit on every rank of a group: rank 0 alone writes the scalars and checkpoints
    single = tc if writer else dataclasses.replace(tc, log_jsonl=None, checkpoint_dir=None)
    stream = dict(shard_voxels=cfg.stream_shard_voxels, lo=-1.0 if cfg.zero_centered else 0.0,
                  value_range=False, eval_fn=eval_fn)  # the dataset's values are already normalised
    if cfg.shard_tables and mesh is not None:  # the table sharded over the ranks
        from .parallel import ShardedHashTrainer

        result = ShardedHashTrainer(tc, mesh=mesh).fit(model, train_coords, train_values, eval_fn=eval_fn)
        if writer:  # the fitted table is on the host: rank 0 reconstructs with the whole model, as JAX's launcher
            model.to(dev)
    elif cfg.stream_shard_voxels > 0:  # out of core
        if cfg.data_parallel and mesh is not None:
            from .parallel import DataParallelTrainer

            result = DataParallelTrainer(tc, mesh=mesh).fit_streaming(model, full_image, **stream)
        else:
            result = Trainer(single).fit_streaming(model, full_image, device=dev, **stream)
    elif cfg.data_parallel and mesh is not None:
        from .parallel import DataParallelTrainer

        result = DataParallelTrainer(tc, mesh=mesh).fit(model, train_coords, train_values, eval_fn=eval_fn)
    else:
        result = Trainer(single).fit(model, train_coords, train_values, device=dev, eval_fn=eval_fn)
    if not writer:
        return {"model": model.name, "device": str(dev), "rank": mesh.rank, "world_size": world,
                "steps": result.steps, "final_loss": result.final_loss, "train_wall_s": result.wall_time_s,
                "run_dir": run_dir}

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
    if recon.ndim == 2:
        png.write_png(os.path.join(run_dir, "pred.png"), png.colorize(recon.T))
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
    if cfg.tb_events:  # a TensorBoard view of the scalars stream
        from .train.tb_events import export_scalars_jsonl

        export_scalars_jsonl(os.path.join(run_dir, "scalars.jsonl"), os.path.join(run_dir, "tb"))
    configs.export_to_txt(cfg, run_dir + os.sep)
    summary = {
        "model": model.name,
        "device": str(dev),
        "world_size": world,
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
        **({"stream": {"shard_voxels": cfg.stream_shard_voxels, "host_synth_s": result.host_synth_s.tolist(),
                       "h2d_s": result.h2d_s.tolist(), "shard_wait_s": result.shard_wait_s.tolist(),
                       "epoch_s": result.epoch_times_s.tolist()}} if cfg.stream_shard_voxels > 0 else {}),
        "run_dir": run_dir,
    }
    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if cfg.save_checkpoint:
        save_checkpoint(ckpt_dir, result.steps, model.state_dict())
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """CLI entry: preset -> YAML config -> JSON config -> flags ->
    :func:`run` (or, with ``--plan``, :func:`plan_from_config`, touching no
    device); prints the summary or the plan as JSON and returns it."""
    args = build_parser().parse_args(argv)
    cfg = configs.default_siren_config() if args.config_preset == "siren" else configs.default_hash_config()
    if args.config_yaml:
        cfg = configs.load_yaml_config(args.config_yaml, base=cfg)
    if args.enco_config_path:
        cfg = configs.apply_enco_config(cfg, configs.load_json_config(args.enco_config_path))
    cfg = configs.override_from_args(cfg, args)
    if args.plan:
        plan = plan_from_config(cfg, n_devices=args.plan_devices, hbm_bytes=args.plan_hbm_gb * 1e9)
        print(json.dumps(plan, indent=2))
        return plan
    summary = run(cfg, device=args.device)
    if "rank" not in summary:  # rank 0 prints; the other ranks of a group return their fit's summary
        print(json.dumps(summary, indent=2))
    return summary


def plan_from_config(cfg: RunConfig, n_devices: int = 1, hbm_bytes: float = 80e9) -> dict:
    """Capacity plan (``plan.plan_run``) for a launcher config: the volume's
    shape from the NIfTI header alone, reduced as :func:`run` reduces it
    (``slice_z``, the even frames, the undersampled share) and the
    resolution tuples rank-adapted as there; no voxel is read and no device
    touched."""
    from .io import nifti
    from .plan import plan_run

    vol_shape = None
    if cfg.image_path and os.path.exists(cfg.image_path):
        vol_shape = nifti.peek_shape(cfg.image_path)
    if vol_shape and cfg.slice_z is not None and len(vol_shape) == 4:
        vol_shape = vol_shape[:2] + vol_shape[3:]
    if vol_shape and cfg.even_frames_only:
        vol_shape = vol_shape[:-1] + (-(-vol_shape[-1] // 2),)
    dim_in = cfg.dim_in or (len(vol_shape) if vol_shape else 3)
    base_res, finest_res = cfg.base_resolution, cfg.finest_resolution
    if vol_shape and isinstance(base_res, (tuple, list)) and len(base_res) != dim_in:
        finest_res = tuple(int(s) for s in vol_shape)
        base_res = tuple(max(2, round(s / 5.5)) for s in vol_shape)
    return plan_run(
        dim_in=dim_in, n_levels=cfg.n_levels, n_features_per_level=cfg.n_features_per_level,
        log2_hashmap_size=cfg.log2_hashmap_size, base_resolution=base_res, finest_resolution=finest_res,
        per_level_scale=cfg.per_level_scale, growth=cfg.growth, dim_hidden=cfg.dim_hidden, n_layers=cfg.n_layers,
        dim_out=cfg.dim_out, decoder=cfg.decoder, batch_size=cfg.batch_size, volume_shape=vol_shape,
        row_fraction=cfg.undersample_pct / 100.0 if cfg.undersample_pct > 0 else 1.0,
        n_devices=n_devices, optimizer=cfg.optimizer, remat=cfg.remat, hbm_bytes=hbm_bytes)


if __name__ == "__main__":
    main()
