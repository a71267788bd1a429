"""What every subcommand of the experiment matrix shares (port of
``scripts/experiments.py:56-79``, ``:385-389`` and ``:1408-1413``): the
workload's volume and slice, ``fit_and_eval`` (one result row), and the
results file under ``--out_dir``.

The JAX script reads a fixed path and writes ``results.json`` and
``RESULTS.md`` at the repository root, which hold its TPU record. The port
reads ``--image_path`` (default :data:`SAMPLE`, the sample volume's file
name) and writes under ``--out_dir`` (default :data:`OUT_DIR`), nowhere
else.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from ..device import DeviceLike, resolve_device
from ..infer import evaluate_grid
from ..io import volume as _volume
from ..metrics import evaluate_reconstruction, param_count
from ..train import Trainer

__all__ = ["SAMPLE", "SLICE", "OUT_DIR", "RESULTS_JSON", "RESULTS_MD", "load_volume", "fit_and_eval", "protocol_row",
           "save_results", "load_results", "describe_device"]

SAMPLE = "sample_ankle_dyn_mri.nii.gz"  # the reference's sample volume, in the working directory unless --image_path
SLICE = (slice(None), slice(None), 3, slice(None))
OUT_DIR = "runs/results_torch"
RESULTS_JSON = "results.json"
RESULTS_MD = "RESULTS.md"


def load_volume(path: str, zero_centered: bool = False, slice_axes=None):
    """``io.load_volume``, raising ``FileNotFoundError`` that names
    ``path`` when it is missing (there is no synthetic fallback)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no volume at {path!r}; pass --image_path")
    return _volume.load_volume(path, zero_centered=zero_centered, slice_axes=slice_axes)


def fit_and_eval(name, model, cfg, ds, lo: float = 0.0, data_range: float = 1.0, device: DeviceLike = None) -> dict:
    """Fit ``model`` on ``ds`` with ``cfg`` on ``device``, reconstruct the
    whole grid, score it; print and return the row."""
    dev = resolve_device(device)
    t0 = time.time()
    res = Trainer(cfg).fit(model, ds.coords, ds.values, device=dev)
    recon = evaluate_grid(model, ds.shape, lo=lo, device=dev)
    q = evaluate_reconstruction(recon, ds.image(), data_range=data_range, device=dev)
    row = {
        "name": name,
        "params": param_count(model),
        "epochs": cfg.epochs,
        "batch": cfg.batch_size,
        "steady_steps_per_sec": round(res.steady_steps_per_sec, 1),
        "voxel_evals_per_sec": round(res.steady_steps_per_sec * min(cfg.batch_size, len(ds)), 0),
        "final_loss": round(res.final_loss, 6),
        "psnr": round(q["psnr"], 2),
        "ssim": round(q.get("ssim", float("nan")), 4),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(row), flush=True)
    return row


def protocol_row(name: str, q: dict, full: bool = True) -> dict:
    """A held-out-frame row from a protocol's ``{"odd": ..., "full": ...}``
    scores (``full``: with the whole volume's PSNR); printed and returned."""
    row = {"name": name, "odd_psnr": round(q["odd"]["psnr"], 2), "odd_ssim": round(q["odd"].get("ssim", float("nan")), 4)}
    if full:
        row["full_psnr"] = round(q["full"]["psnr"], 2)
    print(json.dumps(row), flush=True)
    return row


def save_results(out: dict, out_dir: str = OUT_DIR) -> None:
    """Write ``out`` to ``out_dir/results.json`` (after every stage of a
    long subcommand, so that a failed stage keeps the finished ones)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, RESULTS_JSON), "w") as f:
        json.dump(out, f, indent=2)


def load_results(out_dir: str = OUT_DIR) -> dict:
    path = os.path.join(out_dir, RESULTS_JSON)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def describe_device(device: DeviceLike = None) -> str:
    """The device the rows are measured on: ``nvidia-smi``'s name and power
    limit of the card (``torch.cuda.get_device_name`` where nvidia-smi does
    not answer), or ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
        lines = done.stdout.strip().splitlines() if done.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    return lines[0].strip() if lines else torch.cuda.get_device_name(dev)

