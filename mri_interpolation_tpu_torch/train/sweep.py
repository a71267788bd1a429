"""Hyperparameter search over run configurations (port of
``mri_interpolation_tpu/train/sweep.py``): deterministic random search over
any trial function, with a crash-safe JSONL trial log that a killed sweep
resumes, re-running nothing. Trials run one after another in one process.

Space grammar (plain data, JSON-serializable):

    {"lr": ("log", 1e-4, 1e-1),        # log-uniform float
     "dim_hidden": ("int", 32, 128),   # uniform integer (inclusive)
     "sigma": ("lin", 1.0, 20.0),      # uniform float
     "decoder": ["norm", "relu_plain"]}  # categorical (list)

Usage (library):

    from mri_interpolation_tpu_torch.train.sweep import sweep

    def trial(params):
        model = make_hash_mlp(3, dim_hidden=params["dim_hidden"], ...)
        Trainer(TrainConfig(lr=params["lr"], ...)).fit(model, c, v)
        return psnr_of(model)        # higher is better

    result = sweep(trial, space, n_trials=16, log_path="runs/sweep.jsonl")

Usage (CLI; reconstruction PSNR of the flagship HashMLP family, on the
card unless ``--device cpu``):

    python -m mri_interpolation_tpu_torch.train.sweep \
        --image_path vol.nii.gz --slice_z 3 --trials 8 --epochs 10 \
        --space '{"lr": ["log", 1e-3, 3e-2], "n_levels": ["int", 2, 6]}'

Usage (CLI; held-out odd-frame PSNR of the seed-ensembled warp INR):

    python -m mri_interpolation_tpu_torch.train.sweep \
        --image_path vol.nii.gz --slice_z 3 --model_class warp_inr \
        --objective odd_frames --ens_seeds 4 --trials 12 --epochs 100 \
        --log_path runs/sweep_warp.jsonl

The models of a trial are initialised from ``seed=1337`` (the trainer's
default seed, from which the JAX package draws its inits), or from each
ensemble seed; the CLI prints ``{"best": ..., "n_trials": ...}`` and
returns the ``SweepResult``.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

__all__ = ["sample_space", "sweep", "SweepResult", "main"]


def _is_range_spec(spec) -> bool:
    """A 3-element ``[kind, lo, hi]`` with NUMERIC bounds is a range spec;
    anything else (including a categorical whose first element happens to be
    'log'/'lin'/'int', e.g. a mode-name choice) is a categorical list."""
    return (len(spec) == 3 and spec[0] in ("log", "lin", "int")
            and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                    for v in spec[1:]))


def _sample_one(rng: np.random.Generator, spec) -> object:
    """Sample one value from a space entry (see module docstring grammar)."""
    if isinstance(spec, list) and not _is_range_spec(spec):
        return spec[int(rng.integers(len(spec)))]
    kind, lo, hi = spec
    if kind == "log":
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if kind == "lin":
        return float(rng.uniform(lo, hi))
    if kind == "int":
        return int(rng.integers(int(lo), int(hi) + 1))
    raise ValueError(f"unknown space spec {spec!r}")


def sample_space(space: Mapping[str, object], trial_idx: int,
                 seed: int = 0) -> Dict[str, object]:
    """Deterministic sample for trial ``trial_idx``: the (seed, index) pair
    fully determines the draw (numpy's ``default_rng((seed, trial_idx))``,
    as in the JAX package), so a resumed sweep, of either package,
    re-proposes identical parameters for every trial index and the resume
    check can match on index alone."""
    rng = np.random.default_rng((seed, trial_idx))
    return {k: _sample_one(rng, spec) for k, spec in sorted(space.items())}


@dataclass
class SweepResult:
    trials: List[dict] = field(default_factory=list)

    @property
    def best(self) -> Optional[dict]:
        done = [t for t in self.trials if t.get("score") is not None]
        return max(done, key=lambda t: t["score"]) if done else None


def sweep(
    trial_fn: Callable[[Dict[str, object]], float],
    space: Mapping[str, object],
    n_trials: int = 16,
    seed: int = 0,
    log_path: Optional[str] = None,
    resume: bool = True,
) -> SweepResult:
    """Run ``n_trials`` of deterministic random search, maximizing
    ``trial_fn``'s return value (use ``-loss`` to minimize).

    ``log_path``: JSONL trial log, one line per finished trial
    ``{"trial": i, "params": {...}, "score": s}``. With ``resume=True``
    (default), already-logged trial indices are skipped on restart — a
    crashed 16-trial sweep re-runs only the missing trials (sampling is a
    pure function of (seed, index), so the skipped trials' parameters are
    provably the ones already logged). A trial that raises is logged with
    ``score: null`` and the exception's text, and the sweep continues: one
    diverged fit must not lose the other fifteen. The log's lines are the
    JAX package's, so a sweep started by one package resumes in the other.
    """
    result = SweepResult()
    done_idx = set()
    if log_path and resume and os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                result.trials.append(rec)
                done_idx.add(rec["trial"])
    log_f = open(log_path, "a") if log_path else None
    try:
        for i in range(n_trials):
            if i in done_idx:
                continue
            params = sample_space(space, i, seed)
            rec = {"trial": i, "params": params}
            try:
                rec["score"] = float(trial_fn(params))
            except Exception as e:  # logged as a failed trial, and the sweep goes on (see the docstring)
                rec["score"] = None
                rec["error"] = repr(e)[:300]
            result.trials.append(rec)
            if log_f is not None:
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
    finally:
        if log_f is not None:
            log_f.close()
    result.trials.sort(key=lambda t: t["trial"])
    return result


# ---------------------------------------------------------------------------
# CLI: PSNR objectives on a volume
#
# --objective recon       reconstruction PSNR of the full fitted volume
# --objective odd_frames  train on the even frames, score the held-out odd
#                         ones (train.protocols.even_frame_fit_eval /
#                         ensembled_warp_fit_eval)
# --model_class hash_mlp | warp_inr

_WARP_SPACE = {
    "lr": ["log", 3e-3, 3e-2],
    "warp_accel": ["lin", 0.0, 3.0],
    "level_anneal_steps": ["int", 0, 1800],
    "residual_scale": ["lin", 0.0, 0.15],
}

_HASH_SPACE = {
    "lr": ["log", 1e-3, 3e-2],
    "n_levels": ["int", 3, 6],
    "n_features_per_level": [1, 2, 4],
    "dim_hidden": [32, 64, 128],
}


def main(argv: Optional[Sequence[str]] = None) -> SweepResult:
    ap = argparse.ArgumentParser(description="deterministic random search over model hyperparameters")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--slice_z", type=int, default=None, help="take one z slice of a 4D volume (2D+t workload)")
    ap.add_argument("--model_class", default="hash_mlp", choices=["hash_mlp", "warp_inr"])
    ap.add_argument("--objective", default="recon", choices=["recon", "odd_frames"])
    ap.add_argument("--ens_seeds", type=int, default=1,
                    help="with odd_frames: seed-ensemble width per trial (the headline warp rows are 4-seed "
                         "ensembles)")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_path", default="runs/sweep.jsonl")
    ap.add_argument("--space", default=None,
                    help="JSON space spec (module-docstring grammar); default: a per-model-class space over its "
                         "measured levers")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..infer import evaluate_grid
    from ..io import load_volume
    from ..metrics import evaluate_reconstruction
    from ..models import make_hash_mlp, make_warp_inr
    from .protocols import ensembled_warp_fit_eval, even_frame_fit_eval
    from .trainer import TrainConfig, Trainer

    dev = resolve_device(args.device)
    slice_axes = None
    if args.slice_z is not None:
        slice_axes = (slice(None), slice(None), args.slice_z, slice(None))
    ds = load_volume(args.image_path, slice_axes=slice_axes)
    img = ds.image()
    if args.space is not None:
        space = json.loads(args.space)
    else:
        space = _WARP_SPACE if args.model_class == "warp_inr" else _HASH_SPACE

    def make_model(params, seed=1337):
        if args.model_class == "warp_inr":
            # the stacked protocol's base (train/stacking.py default_interp_families), the levers on top
            return make_warp_inr(
                dim_in=ds.coords.shape[-1], n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                base_resolution=tuple(min(64, s) for s in ds.shape[:-1]), finest_resolution=tuple(ds.shape[:-1]),
                dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
                warp_w0=float(params.get("warp_w0", 5.0)), warp_scale=0.05,
                warp_accel=float(params.get("warp_accel", 1.0)), warp_smooth=float(params.get("warp_smooth", 0.0)),
                residual_scale=float(params.get("residual_scale", 0.05)),
                level_anneal_steps=int(params.get("level_anneal_steps", 0)), seed=seed, device=dev)
        return make_hash_mlp(
            dim_in=ds.coords.shape[-1], n_levels=int(params.get("n_levels", 4)),
            n_features_per_level=int(params.get("n_features_per_level", 1)),
            log2_hashmap_size=int(params.get("log2_hashmap_size", 23)), base_resolution=16,
            finest_resolution=max(ds.shape), dim_hidden=int(params.get("dim_hidden", 64)),
            n_layers=int(params.get("n_layers", 2)), seed=seed, device=dev)

    def config(params, seed=1337):
        if args.model_class == "warp_inr":
            return TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=float(params.get("lr", 1e-2)),
                               seed=seed, optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=args.epochs,
                               weight_decay=1e-5)
        return TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=float(params.get("lr", 5e-3)),
                           seed=seed)

    def trial(params):
        if args.objective == "odd_frames":
            if args.ens_seeds > 1:
                seeds = (1337, 7, 23, 99, 3, 17, 41, 71)[:args.ens_seeds]
                q = ensembled_warp_fit_eval(lambda seed: make_model(params, seed), img, config(params),
                                            seeds=seeds, device=dev)
            else:
                _, q = even_frame_fit_eval(make_model(params), img, config(params), device=dev)
            return q["odd"]["psnr"]
        model = make_model(params)
        Trainer(config(params)).fit(model, ds.coords, ds.values, device=dev)
        recon = evaluate_grid(model, ds.shape, device=dev)
        return evaluate_reconstruction(recon, img, data_range=1.0, device=dev)["psnr"]

    result = sweep(trial, space, n_trials=args.trials, seed=args.seed, log_path=args.log_path)
    print(json.dumps({"best": result.best, "n_trials": len(result.trials)}))
    return result


if __name__ == "__main__":
    main()
