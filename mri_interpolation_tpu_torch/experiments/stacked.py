"""``--stacked``, ``--stacked4d`` and ``--oracle``: the LOO-stacked fusion
rows and the fusion oracles (port of ``scripts/experiments.py:538-750``:
``run_stacked``, ``_per_family_scores``, ``run_stacked4d``,
``run_oracle``), through the port's ``train/stacking.py``.

Every family prediction is cached under ``runs/stacked*_cache*`` (relative
to the working directory, as in the JAX script), so a run reads the
committed caches where they exist and computes only what is missing. The
``--oracle`` subcommand fits nothing: it reads the caches' deployment
predictions and scores linear fusions of them against the held-out frames
(cheating upper bounds, never a result row).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..device import DeviceLike, resolve_device
from ..io.volume import even_frame_split
from ..metrics import evaluate_reconstruction
from ..train import TrainConfig
from ..train.stacking import (DEFAULT_STACK_2DT, DEFAULT_STACK_4D, cached_family_names, default_interp_families,
                              fusion_oracles, load_cached_prediction, slice4d_families, slice_affine_norm,
                              stacked_interp_eval)
from . import common

__all__ = ["run_stacked", "run_stacked4d", "run_oracle", "per_family_scores"]


def _protocol_config(batch: int, epochs: int) -> TrainConfig:
    return TrainConfig(batch_size=batch, epochs=epochs, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                       cosine_t_max=epochs, weight_decay=1e-5)


def _entry(q: dict, label: str) -> dict:
    row = common.protocol_row(label, q)
    print(json.dumps({"global_weights": q["weights"]["global"]}), flush=True)
    return {"row": row, "weights": q["weights"]["global"], "spatial": q["weights"].get("spatial"),
            "robust": q["weights"].get("robust"), "uncertainty": q["uncertainty"]}


def run_stacked(out: dict, k: float, anneal: bool = False, ens_seeds: int = 0, spatial: str = "off",
                robust: str = "off", z4d: bool = False, image_path: str = common.SAMPLE,
                device: DeviceLike = None) -> None:
    """The 2-D+t stacked row. ``ens_seeds``: the warp ensemble's width (N
    seeds, a fresh cache directory ``_sN``, stored under ``stacked_sN``);
    ``spatial``: ``"nested"`` adds the nested-LOO per-voxel weighting
    (default ``"off"``, the committed rows' protocol); ``robust``:
    ``"median_nested"`` shrinks toward the per-voxel family median;
    ``z4d``: merge the through-plane families (the 4-D protocol's motion
    families at z = 3, served from the 4-D cache where the time grids
    align)."""
    dev = resolve_device(device)
    ds01 = common.load_volume(image_path, slice_axes=common.SLICE)
    img = ds01.image()
    ep = int(100 * k) or 2
    cfg = _protocol_config(10000, ep)
    seeds = (1337, 7, 23, 99) if k >= 1.0 else (1337,)
    if ens_seeds:
        seeds = (1337, 7, 23, 99, 3, 17, 41, 71)[:ens_seeds]
    # the level-anneal curriculum on the warp families' canonical encoder, in a fresh cache directory
    warp_kwargs = {"level_anneal_steps": 600} if anneal else {}
    cache = (f"runs/stacked_cache_ep{ep}" + ("_anneal" if anneal else "")
             + (f"_s{len(seeds)}" if ens_seeds else ""))
    label = "LOO-stacked fusion (warp/registration/linear families)"
    if anneal:
        label += " [annealed warp]"
    if ens_seeds:
        label += f" [{len(seeds)}-seed ensembles]"
    if spatial != "off":
        label += " [nested spatial]"
    if robust != "off":
        label += " [median-shrink nested]"
    families = None
    if z4d:
        # the pruned 2-D roster plus the three through-plane winners, the 4-D side with run_stacked4d's
        # config, seeds, anisotropic base resolution and annealed-warp cache
        ep4 = int(60 * k) or 2
        cfg4 = _protocol_config(50000, ep4)
        vol4d = common.load_volume(image_path).image()
        families = default_interp_families(cfg, img.shape, seeds, include=DEFAULT_STACK_2DT, device=dev,
                                           **warp_kwargs)
        families.update(slice4d_families(
            cfg4, vol4d, z=common.SLICE[2], seeds=(1337, 7) if k >= 1.0 else (1337,),
            cache4d_dir=f"runs/stacked4d_cache_ep{ep4}_anneal",
            slice_norm=slice_affine_norm(vol4d, img, common.SLICE[2]), device=dev,
            base_resolution=(64, 64, 2), level_anneal_steps=600))
        label += " [z4d]"
    _, q = stacked_interp_eval(img, cfg, seeds=seeds, cache_dir=cache, families=families, spatial=spatial,
                               robust=robust, device=dev, **warp_kwargs)
    key = f"stacked_s{len(seeds)}" if ens_seeds else ("stacked_z4d" if z4d else "stacked")
    out[key] = {**_entry(q, label), "per_family": per_family_scores(img, cache, dev)}


def per_family_scores(img: np.ndarray, cache_dir: str, device: DeviceLike = None) -> dict:
    """Each family's cached deployment prediction scored against the
    held-out odd frames (rows the stacked run's cache gives for free)."""
    _, odd_img = even_frame_split(img)
    scores = {}
    for name in cached_family_names(cache_dir):
        pred = load_cached_prediction(cache_dir, f"deploy_{name}")
        if pred is None or pred.shape != odd_img.shape:
            continue
        qf = evaluate_reconstruction(pred, odd_img, data_range=1.0, device=device)
        scores[name] = {"odd_psnr": round(qf["psnr"], 2), "odd_ssim": round(qf.get("ssim", float("nan")), 4)}
    return scores


def run_stacked4d(out: dict, k: float, classical_only: bool = False, anneal: bool = False, spatial: str = "off",
                  robust: str = "off", image_path: str = common.SAMPLE, device: DeviceLike = None) -> None:
    """The 4-D stacked row on the whole (X, Y, Z, T) volume: one warp family
    x 2 seeds (and warp_transfer, which reuses its fits), both registration
    families, cubic and linear. ``classical_only`` drops the warp families
    and is stored under its own key."""
    dev = resolve_device(device)
    img = common.load_volume(image_path).image()
    ep = int(60 * k) or 2
    cfg = _protocol_config(50000, ep)
    seeds = (1337, 7) if k >= 1.0 else (1337,)
    include = DEFAULT_STACK_4D
    label = "LOO-stacked fusion (warp/registration/linear families)"
    if classical_only:
        include = include[4:]
        label = "LOO-stacked fusion (classical families only, no warp)"
    warp_kwargs = {"level_anneal_steps": 600} if anneal else {}
    cache = f"runs/stacked4d_cache_ep{ep}" + ("_anneal" if anneal else "")
    if anneal and not classical_only:
        label += " [annealed warp]"
    if spatial != "off":
        label += " [nested spatial]"
    if robust != "off":
        label += " [median-shrink nested]"
    _, q = stacked_interp_eval(img, cfg, seeds=seeds, include=include, base_resolution=(64, 64, 2),
                               cache_dir=cache, spatial=spatial, robust=robust, device=dev, **warp_kwargs)
    key = "stacked_classical" if classical_only else "stacked"
    entry = _entry(q, label)
    if not classical_only:
        entry["per_family"] = per_family_scores(img, cache, dev)
    out["full4d"] = {**out.get("full4d", {}), key: entry}


def run_oracle(out: dict, image_path: str = common.SAMPLE) -> None:
    """The fusion oracles of each committed cache that exists, on the CPU
    (cache reads and least squares; no fit)."""
    oracles = {}
    for key, cache, slice_axes in (
            ("2dt", "runs/stacked_cache_ep100_anneal", common.SLICE),
            ("2dt_s8", "runs/stacked_cache_ep100_anneal_s8", common.SLICE),
            ("4d", "runs/stacked4d_cache_ep60_anneal", None)):
        if not os.path.isdir(cache):
            continue
        img = common.load_volume(image_path, slice_axes=slice_axes).image()
        _, odd_img = even_frame_split(img)
        # cached_family_names drops crash leftovers; the shape check drops a truncated or mismatched array
        preds = {}
        for n in cached_family_names(cache):
            p = load_cached_prediction(cache, f"deploy_{n}")
            if p is not None and p.shape == odd_img.shape:
                preds[n] = p
        names = sorted(preds)
        if not names:
            continue
        deploy = np.stack([preds[n] for n in names]).astype(np.float64)
        o = {name: round(v, 2) for name, v in fusion_oracles(deploy, odd_img.astype(np.float64)).items()}
        o["n_families"] = len(names)
        oracles[key] = o
        print(json.dumps({f"oracle_{key}": o}), flush=True)
    out["fusion_oracles"] = oracles
