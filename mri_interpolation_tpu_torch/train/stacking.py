"""Stacked temporal interpolation: honest fusion of decorrelated predictors.

Port of ``mri_interpolation_tpu/train/stacking.py``. The fusion itself
(simplex weights, LOO folds, the spatial and robust selectors, uncertainty,
oracles) is numpy, copied as it stands; the families run on ``device``
(``cuda`` unless ``"cpu"``): the warp INR's fits and grids (the hash-encode
kernels on the card), the motion transfer and the registrations
(``infer/registration.py``). The prediction cache (``cache_dir``) keeps the
JAX package's layout, so either package reads the other's. The warp-fit
disk layer stores ``state_dict``s (``torch.save``) under
``MRI_TORCH_WARP_FIT_CACHE`` (default ``runs/warp_fit_cache_torch``), apart
from the JAX package's pickles.

The even-frame protocol (reference hash_experimentation.py:313-317) asks for
held-out odd frames from observed even frames. The framework has several
predictor FAMILIES with decorrelated errors:

- ``warp``          motion-compensated warp-INR ensemble (models/warp.py),
                    temporal-acceleration prior on (favors smooth motion)
- ``warp_noaccel``  same, prior off + higher temporal frequency — better at
                    motion extrema, worse elsewhere
- ``warp_distill``  warp-INR ensemble trained WITH pseudo-labels at the
                    unobserved times from the registration teacher
- ``warp_distill_fused``  second-generation distill: same mechanism, but the
                    pseudo-label teacher is the equal-weight fusion of the
                    transfer/group-registration/cubic families (+0.54 dB
                    better anchor than the pairwise registration teacher at
                    the LOO fold positions; the transfer member reuses the
                    warp fits, so the teacher costs inference only)
- ``warp_distill_fused2``  third-generation distill (round 4): the teacher
                    widened to five members (both transfer refinements,
                    both registrations, cubic) — measured +0.29 dB better
                    pseudo-labels at the deployment times; see RESULTS.md
                    for the measured family row
- ``warp_transfer`` the warp-INR's MOTION applied to the observed frames'
                    APPEARANCE (infer/registration.py:motion_transfer_at) —
                    not capped by the INR's own reconstruction error
- ``warp_transfer_cubic``  same aligned resamples, cubic Hermite appearance
                    blend (adds intensity-trajectory curvature)
- ``warp_transfer_res``  same + the INR's residual-field contrast-drift
                    correction (all transfer variants reuse the warp
                    family's fits through the in-process fit memo)
- ``warp_transfer_avg``  consensus-motion transfer: the seeds' deformation
                    fields are averaged pointwise and ONE transfer runs
                    along the mean motion (+ residual correction) — sharper
                    than averaging four independently-resampled intensities
- ``warp_transfer_res_cubic``  cubic appearance + residual drift correction
                    combined (each refinement measured separately first)
- ``registration``  pairwise symmetric registration midpoint
                    (infer/registration.py) — data-space appearance
- ``registration_group``  group temporal registration: one coherent motion
                    trajectory over all kept frames, cubic-Hermite sampled
                    at the eval times (captures curvature the pairwise
                    midpoint cannot)
- ``cubic``         data-space non-uniform cubic Hermite (Catmull-Rom)
                    across kept frames — models intensity-trajectory
                    curvature, which every motion family ignores (they all
                    cross-fade appearance linearly)
- ``linear``        classical cross-fade (the reference's interp.py baseline)
- ``z4d_*``         through-plane families (``slice4d_families``, round 5):
                    the 4D protocol's motion families trained on the even
                    frames of ALL z-slices and deployed at one z slice —
                    the information a 2D fit cannot have by construction

Not every family ships by default: the round-5 subset search kept
``DEFAULT_INTERP_INCLUDE`` (2D-only), ``DEFAULT_STACK_2DT`` +
``DEFAULT_STACK_Z4D`` (the 9-family 2D+t headline stack, 26.44 dB) and
``DEFAULT_STACK_4D``; every measured-and-pruned family remains
constructible via ``include=`` / ``include="all"``.

Their fusion weights must NOT be tuned on the held-out odd frames. This
module selects them honestly by leave-one-even-frame-out (LOO) validation:
hold out each interior EVEN frame, fit every family on the rest, predict the
held-out frame, and fit simplex-constrained per-position weights on those
fold errors (shrunk toward the global weights; interpolated from even fold
positions to the odd deployment positions). The deployment fusion then uses
only even-frame information end to end.

A family is a callable ``family(train_frames, t_keep, t_eval) -> pred`` with
``train_frames (spatial..., len(t_keep))``, normalized frame times ``t_keep``
/ ``t_eval`` in [0, 1], returning ``(spatial..., len(t_eval))`` as numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.volume import even_frame_split, make_mgrid
from ..metrics import evaluate_reconstruction
from ..models import make_warp_inr
from .trainer import TrainConfig, Trainer

__all__ = [
    "DEFAULT_INTERP_INCLUDE",
    "DEFAULT_STACK_2DT",
    "DEFAULT_STACK_Z4D",
    "DEFAULT_STACK_4D",
    "default_interp_families",
    "slice4d_families",
    "slice_affine_norm",
    "simplex_lstsq",
    "loo_fold_predictions",
    "stacked_fuse",
    "stacked_interp_eval",
    "stacked_temporal_upsample",
    "fusion_uncertainty",
    "uncertainty_calibration",
    "spatial_weight_field",
    "fusion_oracles",
    "load_cached_prediction",
    "has_cached_prediction",
    "cached_family_names",
]

FamilyFn = Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]

# Default family rosters (round-5 pruning). Selected by
# a cache-driven subset search over the committed fold/deploy predictions
# (scored via the honest nested-LOO protocol — see CHANGES.md round 5):
# three rounds of measurement left 7+ families at zero global LOO weight,
# and dropping them costs nothing (2D+t head-to-head: slim set 26.445 dB vs
# 26.427 all-23) while cutting protocol wall-clock (8 fewer 100-epoch warp
# fits per protocol run). Every pruned family remains constructible via
# ``include=`` / ``include="all"``; their negative results stay documented
# in RESULTS.md.
#
# The 2D-only default (no 4D volume available):
DEFAULT_INTERP_INCLUDE = (
    "warp_distill", "warp_distill_fused", "warp_distill_fused2",
    "warp_transfer", "registration", "registration_group",
    "registration_cubic", "cubic")
# The 2D members of the z4d headline stack (run with DEFAULT_STACK_Z4D):
DEFAULT_STACK_2DT = (
    "warp_distill", "warp_distill_fused2", "warp_transfer",
    "registration", "registration_cubic", "cubic")
# The through-plane members (slice4d_families 4D names, measured winners):
DEFAULT_STACK_Z4D = ("warp_transfer", "warp_distill_fused", "registration")
# The 4D protocol's default roster (the 10-family all-cache variant scores
# LOWER — 26.59 vs 26.67 — so the transfer-res additions stay non-default):
DEFAULT_STACK_4D = (
    "warp", "warp_transfer", "warp_transfer_avg", "warp_distill_fused",
    "registration", "registration_group", "cubic", "linear")

# The warp and warp_transfer families train IDENTICAL models (same kwargs,
# same seeds, same kept-frame data) and differ only in how predictions are
# synthesized (INR evaluation vs motion transfer of the observed frames).
# Within one protocol run, memoize the fits so the pair costs one ensemble,
# not two. State dicts are stored on the HOST so the memo holds host RAM,
# not device memory; capacity 16 covers 4 seeds x a few datasets in flight.
_FIT_MEMO: dict = {}
_FIT_MEMO_MAX = 16

# Disk layer under the in-process memo: fitted warp state dicts are saved
# (torch.save) under this directory, keyed by the same exhaustive key (training-set sha1 +
# seed + every hyperparameter + TrainConfig). New transfer DEPLOYMENTS of an
# already-measured ensemble (appearance blends, residual correction, motion
# averaging) then cost inference only — not a 28-fit protocol re-run. Set the
# env var to "" to disable, or to another directory to relocate.
_FIT_DISK_DIR = os.environ.get("MRI_TORCH_WARP_FIT_CACHE", "runs/warp_fit_cache_torch")


def _fit_warp_memoized(config: TrainConfig, seed: int, coords, values,
                       dim_in: int, warp_kwargs: dict, device: torch.device):
    """Train (or recall) a warp INR on (coords, values) on ``device``:
    ``make_warp_inr(dim_in, seed=seed, **warp_kwargs)`` fitted with
    ``replace(config, seed=seed)``. Returns the fitted model. Keyed on the
    training set bytes, the seed, and every hyperparameter — distill
    variants differ in coords/values and miss naturally."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(coords).tobytes())
    h.update(np.ascontiguousarray(values).tobytes())
    key = (h.hexdigest(), int(seed), int(dim_in),
           repr(sorted(warp_kwargs.items())),
           repr(dataclasses.replace(config, seed=seed)))
    model = make_warp_inr(dim_in, seed=seed, device=device, **warp_kwargs)
    if key in _FIT_MEMO:
        host = _FIT_MEMO.pop(key)
        _FIT_MEMO[key] = host                        # refresh LRU order
        model.load_state_dict(host)
        return model
    disk_path = (os.path.join(_FIT_DISK_DIR,
                              hashlib.sha1(repr(key).encode()).hexdigest() + ".pt")
                 if _FIT_DISK_DIR else None)
    if disk_path is not None and os.path.exists(disk_path):
        host = torch.load(disk_path, map_location="cpu", weights_only=True)
        model.load_state_dict(host)
    else:
        Trainer(dataclasses.replace(config, seed=seed)).fit(model, coords, values, device=device)
        host = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        if disk_path is not None:
            os.makedirs(_FIT_DISK_DIR, exist_ok=True)
            tmp = disk_path + ".tmp"
            torch.save(host, tmp)
            os.replace(tmp, disk_path)              # atomic: crash-safe cache
    _FIT_MEMO[key] = host
    while len(_FIT_MEMO) > _FIT_MEMO_MAX:
        _FIT_MEMO.pop(next(iter(_FIT_MEMO)))
    return model


def _coords_for_frames(spatial_shape, t_vals):
    grid = make_mgrid(spatial_shape, 0.0, 1.0).reshape(-1, len(spatial_shape))
    return np.concatenate([
        np.concatenate([grid, np.full((grid.shape[0], 1), t, np.float32)], axis=1)
        for t in t_vals])


def _fused_teacher_family(config: TrainConfig, seeds: Sequence[int],
                          wide: bool = False, device: DeviceLike = None,
                          **warp_kwargs) -> FamilyFn:
    """Equal-weight fusion of decorrelated predictors, used as the
    pseudo-label TEACHER for the distill families.

    Default (``warp_distill_fused``'s teacher): motion transfer (INR motion
    + data appearance + residual drift correction) + group temporal
    registration + intensity-space cubic Hermite. On the ankle protocol
    each member scores ~24.7-26.0 held-out vs the pairwise registration
    teacher's 25.0, and their errors decorrelate, so the plain average is a
    materially better anchor at the unobserved mid-times.

    ``wide=True`` (``warp_distill_fused2``'s teacher, round 4): five
    members — the two transfer refinements (residual, residual+cubic
    appearance), group registration, pairwise registration, cubic.
    Measured +0.29 dB over the three-member teacher at the deployment
    times on the committed 2D+t cache (mean5 26.13 vs 25.84).

    Self-contained: everything is computed from the (train_frames, t_keep)
    the family is called with, so LOO-fold honesty is preserved by
    construction (no weights learned anywhere). The transfer members reuse
    the ``warp`` family's fits through the fit memo / disk cache, so inside
    a protocol run this teacher costs inference only."""
    members = [
        _warp_transfer_family(config, seeds, use_residual=True,
                              device=device, **warp_kwargs),
        _registration_group_family(device=device),
        _cubic_family(),
    ]
    if wide:
        members.insert(1, _warp_transfer_family(
            config, seeds, use_residual=True, appearance="cubic",
            device=device, **warp_kwargs))
        members.insert(3, _registration_family(device=device))

    def family(train_frames, t_keep, t_eval):
        preds = [f(train_frames, t_keep, t_eval) for f in members]
        return np.mean(preds, axis=0)

    return family


def _warp_family(config: TrainConfig, seeds: Sequence[int], eval_shape,
                 distill: bool = False, distill_ratio: float = 0.25,
                 distill_teacher: str = "registration",
                 device: DeviceLike = None, **warp_kwargs) -> FamilyFn:
    """Seed-ensembled warp-INR family. ``eval_shape`` is the full-volume
    shape whose last axis defines the t grid the INR is evaluated on
    (t_eval values must lie on it).

    ``distill_teacher`` selects the pseudo-label source when ``distill``:
    ``"registration"`` (pairwise symmetric registration midpoints — the
    first-generation family) or ``"fused"`` (the equal-weight
    transfer/group-registration/cubic fusion — measured +0.54 dB better at
    the LOO fold positions on the ankle protocol; see
    ``_fused_teacher_family``)."""
    from ..infer import evaluate_grid

    dev = resolve_device(device)
    t_n = eval_shape[-1]

    def family(train_frames, t_keep, t_eval):
        spatial = train_frames.shape[:-1]
        coords = _coords_for_frames(spatial, t_keep)
        values = np.moveaxis(train_frames, -1, 0).reshape(-1, 1)
        if distill:
            if distill_teacher == "fused":
                teacher = _fused_teacher_family(config, seeds, device=dev,
                                                **warp_kwargs)
            elif distill_teacher == "fused2":
                teacher = _fused_teacher_family(config, seeds, wide=True,
                                                device=dev, **warp_kwargs)
            else:
                teacher = _registration_family(device=dev)
            mids = 0.5 * (np.asarray(t_keep[:-1]) + np.asarray(t_keep[1:]))
            ps_pred = teacher(train_frames, t_keep, mids)
            ps_c = _coords_for_frames(spatial, mids)
            ps_v = np.moveaxis(ps_pred, -1, 0).reshape(-1, 1)
            rng = np.random.default_rng(0)
            idx = rng.choice(ps_c.shape[0], int(distill_ratio * ps_c.shape[0]),
                             replace=False)
            coords = np.concatenate([coords, ps_c[idx]])
            values = np.concatenate([values, ps_v[idx]])
        recons = []
        for seed in seeds:
            model = _fit_warp_memoized(
                config, seed, coords, values, len(spatial) + 1, warp_kwargs, dev)
            recons.append(evaluate_grid(model, eval_shape, device=dev))
        mean = np.mean(recons, axis=0)
        idxs = [int(round(t * (t_n - 1))) for t in np.asarray(t_eval)]
        return np.stack([mean[..., i] for i in idxs], axis=-1)

    return family


def _warp_transfer_family(config: TrainConfig, seeds: Sequence[int],
                          appearance: str = "linear",
                          use_residual: bool = False,
                          average_motion: bool = False,
                          device: DeviceLike = None,
                          **warp_kwargs) -> FamilyFn:
    """INR motion + DATA appearance: train the same warp-INR ensemble as the
    ``warp`` family, but synthesize eval frames by motion-transferring the
    OBSERVED bracketing frames along each seed's learned deformation field
    (infer/registration.py:motion_transfer_at) instead of evaluating the
    INR's own reconstruction. Decorrelated from ``warp`` exactly where the
    INR's appearance error dominates (the INR family's quality is capped by
    its ~27 dB full-volume reconstruction; the transferred appearance is the
    data itself).

    ``average_motion``: fuse the seeds in MOTION space instead of intensity
    space — average the ensemble's displacement fields (and residual fields)
    pointwise and run ONE transfer along the consensus motion. Averaging
    transferred intensities blurs wherever the seeds' motions disagree (each
    resample lands on a slightly different data pixel); averaging the small,
    smooth fields first keeps the single resample sharp."""
    from ..infer.registration import motion_transfer_at

    dev = resolve_device(device)

    def family(train_frames, t_keep, t_eval):
        spatial = train_frames.shape[:-1]
        coords = _coords_for_frames(spatial, t_keep)
        values = np.moveaxis(train_frames, -1, 0).reshape(-1, 1)
        fits = [_fit_warp_memoized(config, seed, coords, values, len(spatial) + 1, warp_kwargs, dev)
                for seed in seeds]
        rs = fits[0].hparams["residual_scale"]

        def transfer(warp_fn, res_fn):
            return motion_transfer_at(
                train_frames, t_keep, t_eval, warp_fn,
                appearance=appearance, residual_field=res_fn,
                residual_scale=rs, device=dev)

        if average_motion:
            def warp_mean(x):
                return torch.stack([m.warp_field(x) for m in fits]).mean(dim=0)

            res_mean = None
            if use_residual:
                def res_mean(x):
                    return torch.stack([m.residual_field(x) for m in fits]).mean(dim=0)

            return transfer(warp_mean, res_mean)

        preds = [transfer(m.warp_field, m.residual_field if use_residual else None) for m in fits]
        return np.mean(preds, axis=0)

    return family


def _registration_family(device: DeviceLike = None, **reg_kwargs) -> FamilyFn:
    from ..infer.registration import register_pair, synthesize_frame

    dev = resolve_device(device)

    def family(train_frames, t_keep, t_eval):
        t_keep = np.asarray(t_keep, np.float64)
        out = []
        cache = {}
        for t in np.asarray(t_eval, np.float64):
            j = int(np.searchsorted(t_keep, t) - 1)
            j = min(max(j, 0), len(t_keep) - 2)
            a, b = train_frames[..., j], train_frames[..., j + 1]
            if j not in cache:
                cache[j] = register_pair(a, b, device=dev, **reg_kwargs)
            tau = float((t - t_keep[j]) / (t_keep[j + 1] - t_keep[j]))
            out.append(synthesize_frame(a, b, cache[j], tau=tau, device=dev).cpu().numpy())
        return np.stack(out, axis=-1)

    return family


def _registration_group_family(device: DeviceLike = None, **reg_kwargs) -> FamilyFn:
    """Group temporal registration: one coherent motion trajectory over the
    kept frames, sampled at the eval times by cubic Hermite interpolation of
    the per-knot fields (infer/registration.py:group_synthesize_at). Unlike
    the pairwise family, trajectory curvature across neighbors informs the
    in-gap motion."""
    from ..infer.registration import group_synthesize_at

    dev = resolve_device(device)

    def family(train_frames, t_keep, t_eval):
        return group_synthesize_at(train_frames, t_keep, t_eval, device=dev, **reg_kwargs)

    return family


def _cubic_family() -> FamilyFn:
    """Per-voxel non-uniform cubic Hermite over the kept frames
    (finite-difference tangents; the uniform case is Catmull-Rom, exact on
    quadratic intensity trajectories) — infer/classical.py's
    ``cubic_interpolate_frames``. Same spline machinery as the group
    registration's trajectory interpolation (infer/registration.py:
    group_synthesize_at) but applied in INTENSITY space — it captures
    brightness curvature in time, which the motion families cannot (they
    cross-fade appearance linearly between the bracketing frames)."""
    from ..infer.classical import cubic_interpolate_frames

    def family(train_frames, t_keep, t_eval):
        return cubic_interpolate_frames(train_frames, t_keep, t_eval)

    return family


def _linear_family() -> FamilyFn:
    def family(train_frames, t_keep, t_eval):
        t_keep = np.asarray(t_keep, np.float64)
        out = []
        for t in np.asarray(t_eval, np.float64):
            j = int(np.searchsorted(t_keep, t) - 1)
            j = min(max(j, 0), len(t_keep) - 2)
            tau = float((t - t_keep[j]) / (t_keep[j + 1] - t_keep[j]))
            out.append((1 - tau) * train_frames[..., j] + tau * train_frames[..., j + 1])
        return np.stack(out, axis=-1)

    return family


def default_interp_families(
    config: TrainConfig,
    eval_shape: Sequence[int],
    seeds: Sequence[int] = (1337, 7, 23, 99),
    include: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
    **warp_kwargs,
) -> Dict[str, FamilyFn]:
    """The measured family set for the ankle workload (see RESULTS.md), on
    ``device``.

    ``include=None`` (default) returns ``DEFAULT_INTERP_INCLUDE`` — the
    pruned roster the subset search kept (round 5; headline within 0.005 dB
    of the full set at a fraction of the fit budget). ``include="all"``
    returns every family ever measured (the zero-weight ones included);
    a sequence of names selects exactly those.

    ``warp_kwargs`` forwards to every warp-INR family; ``warp_w0`` /
    ``warp_accel`` override the primary families' defaults (5.0 / 1.0) but
    NOT ``warp_noaccel``'s — that family is DEFINED by accel off + higher
    temporal frequency (6.0 / 0.0), its identity in the fusion."""
    base = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23,
                dim_hidden=64, n_layers=2, warp_hidden=64, warp_layers=3,
                warp_scale=0.05, residual_scale=0.05)
    base.update(warp_kwargs)
    spatial = tuple(eval_shape[:-1])
    base.setdefault("base_resolution", tuple(min(64, s) for s in spatial))
    base.setdefault("finest_resolution", spatial)
    primary = {"warp_w0": base.pop("warp_w0", 5.0),
               "warp_accel": base.pop("warp_accel", 1.0), **base}
    noaccel = {"warp_w0": 6.0, "warp_accel": 0.0, **base}
    dev = resolve_device(device)
    primary["device"] = noaccel["device"] = dev
    fams = {
        "warp": _warp_family(config, seeds, eval_shape, **primary),
        "warp_noaccel": _warp_family(config, seeds, eval_shape, **noaccel),
        "warp_distill": _warp_family(config, seeds, eval_shape, distill=True,
                                     **primary),
        # second-generation distill: pseudo-labels from the equal-weight
        # transfer/group/cubic fusion instead of the pairwise registration
        # (measured +0.54 dB better teacher at the fold positions); new fits
        # (the pseudo-labels change the training bytes), but the teacher
        # itself reuses the warp fits through the memo
        "warp_distill_fused": _warp_family(config, seeds, eval_shape,
                                           distill=True,
                                           distill_teacher="fused",
                                           **primary),
        # third-generation distill (round 4): the wide five-member teacher
        # (+0.29 dB better pseudo-labels at the deployment times, measured
        # from the committed cache — see _fused_teacher_family(wide=True))
        "warp_distill_fused2": _warp_family(config, seeds, eval_shape,
                                            distill=True,
                                            distill_teacher="fused2",
                                            **primary),
        "warp_transfer": _warp_transfer_family(config, seeds, **primary),
        # same fits again (memo): motion-aligned CUBIC appearance — adds the
        # intensity-curvature modelling of the cubic family on top of the
        # transfer's motion compensation
        "warp_transfer_cubic": _warp_transfer_family(
            config, seeds, appearance="cubic", **primary),
        # same fits again: transfer + the INR's contrast-drift correction
        # (residual_field delta; zero at kept times)
        "warp_transfer_res": _warp_transfer_family(
            config, seeds, use_residual=True, **primary),
        # same fits again: consensus-motion transfer — average the seeds'
        # deformation/residual fields, resample ONCE (motion-space fusion
        # stays sharp where intensity-space fusion blurs on disagreement)
        "warp_transfer_avg": _warp_transfer_family(
            config, seeds, use_residual=True, average_motion=True, **primary),
        # same fits again: cubic appearance + residual drift correction —
        # the two independently-measured transfer refinements combined
        "warp_transfer_res_cubic": _warp_transfer_family(
            config, seeds, use_residual=True, appearance="cubic", **primary),
        "registration": _registration_family(device=dev),
        "registration_group": _registration_group_family(device=dev),
        "registration_cubic": _registration_group_family(device=dev, appearance="cubic"),
        "cubic": _cubic_family(),
        "linear": _linear_family(),
    }
    if include is None:
        include = DEFAULT_INTERP_INCLUDE
    if include != "all":
        fams = {name: fams[name] for name in include}
    return fams


def slice_affine_norm(volume4d: np.ndarray, slice2d: np.ndarray,
                      z: int) -> Tuple[float, float]:
    """The exact affine map from the 4D volume's normalization to the z-slice
    protocol's normalization.

    ``load_volume`` min-max normalizes AFTER slicing (io/volume.py), so the
    2D+t protocol's intensities are ``(raw - min_s)/(max_s - min_s)`` while
    the 4D protocol's are ``(raw - min_4)/(max_4 - min_4)`` — the two scales
    differ whenever the volume's extrema live off the slice. Both are affine
    in raw intensity, so a single (a, b) with
    ``slice_norm = a * volume_norm[:, :, z, :] + b`` maps between them
    EXACTLY; it is solved from the two normalized arrays' extrema and
    verified against every voxel (a failed assert means the inputs are not
    the same data)."""
    x = np.asarray(volume4d[:, :, z, :], np.float64)
    y = np.asarray(slice2d, np.float64)
    span = x.max() - x.min()
    if span <= 0:
        raise ValueError("slice is constant under the 4D normalization")
    a = (y.max() - y.min()) / span
    b = y.min() - a * x.min()
    np.testing.assert_allclose(a * x + b, y, atol=1e-5)
    return float(a), float(b)


def slice4d_families(
    config4d: TrainConfig,
    volume4d: np.ndarray,
    z: int,
    seeds: Sequence[int] = (1337, 7),
    include: Sequence[str] = DEFAULT_STACK_Z4D,
    cache4d_dir: Optional[str] = None,
    slice_norm: Optional[Tuple[float, float]] = None,
    device: DeviceLike = None,
    **warp_kwargs,
) -> Dict[str, FamilyFn]:
    """Through-plane (z-context) families for the 2D+t protocol.

    The occlusion analysis concluded that through-plane content change is
    invisible from a single 2D slice BY CONSTRUCTION (RESULTS.md), and the
    4D protocol — whose families see all z — scores higher held-out. These
    families feed that context into the 2D+t stack: each wraps a 4D family
    (``default_interp_families`` on the full (X, Y, Z, T) volume), trains
    it on the EVEN frames of all z-slices, and deploys its ``z``-slice
    prediction as a 2D+t family named ``z4d_<name>``.

    Honesty: only even-frame information enters — the wrapper selects
    frames by the protocol's ``t_keep`` (asserting they are even) and never
    reads the 4D volume's odd frames — so LOO fold/weight selection stays
    valid. ``slice_norm`` maps the 4D normalization onto the slice
    protocol's (``slice_affine_norm``); identity when omitted.

    Intensity-space families (linear/cubic) are pointwise in (x, y, z) and
    slice to exactly their 2D counterparts, so only motion families belong
    here — the ones whose 3D deformation fields carry through-plane
    information a 2D fit cannot have. The default ``include`` is
    ``DEFAULT_STACK_Z4D``, the three the round-5 subset search kept
    (z4d_warp / z4d_warp_transfer_avg / z4d_registration_group and both
    transfer-res refinements measured in and pruned at zero weight).

    Cache reuse: with ``cache4d_dir`` pointing at the committed 4D protocol
    cache, fold/deploy calls whose time grids match the 4D protocol's are
    served from disk (the 2D+t and 4D protocols share the frame axis, so
    every LOO fold aligns); anything else recomputes the 4D family live.
    Reference protocol: hash_experimentation.py:313-317."""
    fams4d = default_interp_families(config4d, volume4d.shape, seeds,
                                     include=include, device=device, **warp_kwargs)
    a, b = slice_norm if slice_norm is not None else (1.0, 0.0)
    T = volume4d.shape[-1]
    n_even = (T + 1) // 2

    def make(name, f4):
        def family(train_frames, t_keep, t_eval):
            keep_idx = [int(round(t * (T - 1))) for t in np.asarray(t_keep)]
            assert all(i % 2 == 0 for i in keep_idx), \
                f"z4d families are even-frame-only (got frames {keep_idx})"
            assert train_frames.shape[-1] == len(keep_idx)
            train4d = volume4d[..., keep_idx]
            te = np.asarray(t_eval)
            eval_idx = [int(round(t * (T - 1))) for t in te]
            key = None
            if cache4d_dir is not None:
                if (len(keep_idx) == n_even and len(eval_idx) == T // 2
                        and all(i % 2 == 1 for i in eval_idx)):
                    key = f"deploy_{name}"
                elif (len(eval_idx) == 1 and eval_idx[0] % 2 == 0
                      and eval_idx[0] not in keep_idx):
                    # the 4D protocol's LOO fold k holds out kept frame k —
                    # same time grid, so the cached prediction is this call
                    key = f"fold{eval_idx[0] // 2}_{name}"
            if key is not None:
                # mirror the 4D protocol's cache layout: fold entries are
                # stored squeezed (loo_fold_predictions stores [..., 0])
                squeeze = key.startswith("fold")
                pred4d = _cached_call(
                    cache4d_dir, key,
                    lambda: (f4(train4d, t_keep, te)[..., 0] if squeeze
                             else f4(train4d, t_keep, te)))
                if squeeze:
                    pred4d = pred4d[..., None]
            else:
                pred4d = np.asarray(f4(train4d, t_keep, te))
            return (a * pred4d[:, :, z, :] + b).astype(np.float32)

        return family

    return {f"z4d_{name}": make(name, f) for name, f in fams4d.items()}


def simplex_lstsq(preds: np.ndarray, target: np.ndarray,
                  iters: int = 500, lr: float = 0.5) -> np.ndarray:
    """min_w ||sum_f w_f preds_f - target||^2, w >= 0, sum w = 1.

    Tiny projected-gradient solve (F is ~5); deterministic, no scipy.
    ``preds``: (F, N), ``target``: (N,).
    """
    F = preds.shape[0]
    w = np.full((F,), 1.0 / F)
    G = preds @ preds.T / preds.shape[1]          # (F, F)
    b = preds @ target / preds.shape[1]           # (F,)
    scale = max(np.trace(G) / F, 1e-12)
    for _ in range(iters):
        grad = (G @ w - b) / scale
        w = w - lr * grad
        # project onto the simplex (Duchi et al. 2008)
        u = np.sort(w)[::-1]
        css = np.cumsum(u) - 1.0
        rho = np.nonzero(u - css / (np.arange(F) + 1) > 0)[0][-1]
        w = np.maximum(w - css[rho] / (rho + 1.0), 0.0)
    return w


def load_cached_prediction(cache_dir: Optional[str], key: str):
    """Load one cached family prediction, or None if absent.

    Two on-disk layouts are supported: the legacy raw fp32 ``<key>.npy``
    (rounds 2-3) and the artifact-policy fp16 ``<key>.npz`` (round 4+ —
    half the bytes before zip deflate; the ~1e-4 relative quantization is
    ~80 dB below the ~26 dB signals being fused). ``.npz`` wins when both
    exist. Crash leftovers (``*.tmp.npy``) are never readable here."""
    if cache_dir is None:
        return None
    path_z = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path_z):
        with np.load(path_z) as z:
            return z["pred"].astype(np.float32)
    path = os.path.join(cache_dir, key + ".npy")
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    return None


def has_cached_prediction(cache_dir: Optional[str], key: str) -> bool:
    if cache_dir is None:
        return False
    return (os.path.exists(os.path.join(cache_dir, key + ".npz"))
            or os.path.exists(os.path.join(cache_dir, key + ".npy")))


def cached_family_names(cache_dir: Optional[str]) -> list:
    """Family names with a deploy-time prediction in ``cache_dir``.

    Filters crash leftovers (``deploy_x.tmp.npy`` would otherwise yield a
    bogus family 'x.tmp' whose truncated array poisons np.stack)."""
    import glob

    if cache_dir is None or not os.path.isdir(cache_dir):
        return []
    names = set()
    for p in glob.glob(os.path.join(cache_dir, "deploy_*.np[yz]")):
        base = os.path.basename(p)
        stem = base[len("deploy_"):base.rfind(".")]
        if stem.endswith(".tmp"):
            continue
        names.add(stem)
    return sorted(names)


def _cached_call(cache_dir: Optional[str], key: str, fn):
    """Disk-memoized family prediction: the full stacked protocol is ~80
    warp-INR fits; a transient device error mid-run must not lose them.
    Reads both cache layouts; writes NEW entries as compressed fp16 ``.npz``
    (artifact policy, README) via tmp-file + atomic rename."""
    if cache_dir is None:
        return fn()
    hit = load_cached_prediction(cache_dir, key)
    if hit is not None:
        return hit
    out = np.asarray(fn())
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, pred=out.astype(np.float16))
    os.replace(tmp, path)
    # Return the quantized round-trip, not the fresh fp32: a fresh run and a
    # cache-replayed run must publish bit-identical numbers.
    return out.astype(np.float16).astype(np.float32)


def loo_fold_predictions(
    train_frames: np.ndarray,
    t_keep: np.ndarray,
    families: Mapping[str, FamilyFn],
    cache_dir: Optional[str] = None,
) -> Tuple[list, list]:
    """Hold out each interior kept frame; fit every family on the rest and
    predict it. Returns (folds, names): folds is a list of
    ``(held_position, preds (F, spatial...), target (spatial...))``."""
    names = list(families)
    folds = []
    n = train_frames.shape[-1]
    for k in range(1, n - 1):
        keep = [j for j in range(n) if j != k]
        sub = train_frames[..., keep]
        tk = np.asarray([t_keep[j] for j in keep])
        te = np.asarray([t_keep[k]])
        preds = np.stack([
            _cached_call(cache_dir, f"fold{k}_{name}",
                         lambda name=name: families[name](sub, tk, te)[..., 0])
            for name in names
        ])
        folds.append((t_keep[k], preds, train_frames[..., k]))
    return folds, names


def stacked_interp_eval(
    image: np.ndarray,
    config: TrainConfig,
    families: Optional[Mapping[str, FamilyFn]] = None,
    seeds: Sequence[int] = (1337, 7, 23, 99),
    shrink: float = 0.5,
    loo: bool = True,
    cache_dir: Optional[str] = None,
    spatial: object = "off",
    robust: object = "off",
    device: DeviceLike = None,
    **warp_kwargs,
) -> Tuple[np.ndarray, dict]:
    """Even-frame protocol scored for the LOO-stacked fusion (families and
    metrics on ``device``).

    1. fit every family on ALL even frames; predict the odd times;
    2. (``loo=True``) run the LOO folds, solve global + per-position simplex
       weights on fold errors, shrink per-position toward global, interpolate
       even fold positions -> odd deployment positions;
    3. fuse and score. No odd-frame ground truth enters steps 1-2.

    Returns (reconstruction, {"full": ..., "odd": ..., "weights": {...}}).
    """
    train_img, odd_img = even_frame_split(image)
    t_full = image.shape[-1]
    n_even = train_img.shape[-1]
    t_keep = np.asarray([2 * j / (t_full - 1) for j in range(n_even)])
    t_odd = np.asarray([(2 * j + 1) / (t_full - 1) for j in range(odd_img.shape[-1])])
    dev = resolve_device(device)
    if families is None:
        families = default_interp_families(config, image.shape, seeds, device=dev, **warp_kwargs)

    fused_odd, weights = stacked_fuse(train_img, t_keep, t_odd, families,
                                      shrink=shrink, loo=loo, cache_dir=cache_dir,
                                      spatial=spatial, robust=robust)
    deploy, w_new = weights.pop("_components")
    recon = np.zeros(image.shape, np.float32)
    recon[..., ::2] = train_img
    recon[..., 1::2] = fused_odd
    full_q = evaluate_reconstruction(recon, image, data_range=1.0, device=dev)
    odd_q = evaluate_reconstruction(fused_odd, odd_img, data_range=1.0, device=dev)
    # confidence map + its calibration against the true held-out error —
    # sigma itself uses no odd-frame information (family disagreement only)
    sigma = fusion_uncertainty(deploy, w_new)
    calib = uncertainty_calibration(sigma, fused_odd - odd_img)
    uncertainty = {"sigma_mean": float(sigma.mean()),
                   "sigma_p95": float(np.percentile(sigma, 95.0)),
                   "calibration": calib}
    return recon, {"full": full_q, "odd": odd_q, "weights": weights,
                   "uncertainty": uncertainty}


def _gaussian_smooth(a: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur over every axis of ``a``
    (``scipy.ndimage.gaussian_filter`` in float64)."""
    if sigma <= 0:
        return np.asarray(a, np.float64)
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(np.asarray(a, np.float64), sigma)


def _proj_field(w: np.ndarray) -> np.ndarray:
    """Clip-and-renormalize (..., F) onto the simplex along the last axis."""
    w = np.maximum(w, 0.0)
    return w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-12)


def spatial_weight_field(folds: Sequence[Tuple[float, np.ndarray, np.ndarray]],
                         sigma: float, temp: float = 2.0) -> np.ndarray:
    """Per-VOXEL family weights from the pooled LOO fold errors.

    Average each family's squared fold error over the folds, blur with a
    wide Gaussian (``sigma`` in voxels — the field must carry regional
    competence, not pixel noise), and softmin across families. Uses only
    kept-frame information, so fusing with it stays honest. Returns
    (spatial..., F) simplex weights.
    """
    m = np.mean([(p - t[None]) ** 2 for _, p, t in folds], axis=0)  # (F, sp)
    sm = np.stack([_gaussian_smooth(e, sigma) for e in m])
    w = np.exp(-sm / (temp * max(sm.mean(), 1e-30)))
    return _proj_field(np.moveaxis(w, 0, -1))


def _heldout_temporal_weights(folds, shrink: float) -> list:
    """Per-held-fold temporal weights built from the OTHER folds only —
    stacked_fuse's shrink-then-interpolate layout evaluated at the held
    position. Shared by the nested-LOO selectors (spatial field, median
    shrink): every candidate is scored against weights the held fold never
    influenced."""
    F = folds[0][1].shape[0]
    nfold = len(folds)
    pos = np.asarray([t for t, _, _ in folds])
    w_fold = np.stack([simplex_lstsq(p.reshape(F, -1), t.reshape(-1))
                       for _, p, t in folds])
    wt_h = []
    for j in range(nfold):
        others = [i for i in range(nfold) if i != j]
        wg = simplex_lstsq(
            np.concatenate([folds[i][1].reshape(F, -1) for i in others], axis=1),
            np.concatenate([folds[i][2].reshape(-1) for i in others]))
        wp = np.stack([shrink * wg + (1 - shrink) * w_fold[i] for i in others])
        wt = np.stack([np.interp([pos[j]], pos[others], wp[:, f])[0]
                       for f in range(F)])
        wt_h.append(_proj_field(wt))
    return wt_h


_MEDIAN_SHRINK_CANDIDATES = (0.0, 0.25, 0.5, 0.75, 1.0)


def _heldout_fused_preds(folds, shrink: float,
                         spatial_params=None) -> list:
    """Per-held-fold FUSED prediction built from the other folds only — the
    same estimator ``stacked_fuse`` will deploy (temporal weights, plus the
    spatial softmin field when ``spatial_params=(sigma, temp, ss)`` kept
    one). Shared by the nested median-shrink selector so lam is scored
    against the predictor actually shipped, not the temporal-only one."""
    wt_h = _heldout_temporal_weights(folds, shrink)
    nfold = len(folds)
    sig, temp, ss = spatial_params if spatial_params else (0.0, 0.0, 0.0)
    sm_all = None
    if sig > 0.0:
        errs = [np.asarray((p - t[None]) ** 2, np.float64) for _, p, t in folds]
        sm_all = np.stack(
            [np.stack([_gaussian_smooth(e, sig) for e in fe]) for fe in errs])
    out = []
    for j, (_, p_h, _) in enumerate(folds):
        if sig > 0.0:
            sm = sm_all[[i for i in range(nfold) if i != j]].mean(axis=0)
            ws = _proj_field(np.moveaxis(
                np.exp(-sm / (temp * max(sm.mean(), 1e-30))), 0, -1))
            w = _proj_field((1 - ss) * ws + ss * wt_h[j])
            out.append(np.einsum("f...,...f->...", p_h, w))
        else:
            out.append(np.einsum("f...,f->...", p_h, wt_h[j]))
    return out


def _select_median_shrink_nested(folds, shrink: float,
                                 lams=_MEDIAN_SHRINK_CANDIDATES,
                                 spatial_params=None) -> float:
    """Pick the shrink-toward-median weight by nested leave-one-fold-out.

    The solved simplex weights minimize SQUARED error pooled over folds,
    which makes the fused estimate sensitive to whichever family is the
    per-voxel outlier at deployment; the per-voxel MEDIAN of the family
    predictions is robust to exactly that. ``(1-lam)*fused + lam*median``
    interpolates between them; lam is selected on the held folds only (the
    lam=0 baseline competes, so the blend is kept only when the folds say
    it transfers). ``spatial_params``: the (sigma, temp, ss) the spatial
    selection kept (or None) — the held-fold predictor lam is scored
    against then includes the same spatial field the deployment fusion
    will, so selection and deployment see the same estimator. Measured
    round 4 on the ankle 2D+t cache: folds select lam>0 and the held-out
    headline moves +0.08-0.10 dB; no odd-frame data is touched."""
    if len(folds) < 2:
        return 0.0
    fused_h = _heldout_fused_preds(folds, shrink, spatial_params)
    best, best_mse = 0.0, np.inf
    for lam in lams:
        se, n = 0.0, 0
        for j, (_, p_h, tgt_h) in enumerate(folds):
            med_h = np.median(p_h, axis=0)
            pred = (1.0 - lam) * fused_h[j] + lam * med_h
            se += float(np.sum((pred - tgt_h) ** 2))
            n += tgt_h.size
        if se / n < best_mse:
            best, best_mse = float(lam), se / n
    return best


# Candidate (sigma, temp, spatial_shrink) grid for the nested-LOO spatial
# selection, plus the temporal-only baseline (sigma 0 disables the field).
# The grid was widened in round 5 (sigma 64, temp 8, ss 0.65/0.8) after the
# z4d-family run selected (32, 4, 0.5) — every knob at the old grid's edge.
_SPATIAL_CANDIDATES = ((0.0, 0.0, 0.0),) + tuple(
    (sig, temp, ss)
    for sig in (8.0, 16.0, 32.0, 64.0)
    for temp in (1.0, 2.0, 4.0, 8.0)
    for ss in (0.2, 0.35, 0.5, 0.65, 0.8))


def _select_spatial_nested(folds, shrink: float) -> Tuple[float, float, float]:
    """Pick (sigma, temp, spatial_shrink) by nested leave-one-fold-out: hold
    each fold out, build the spatial field + temporal weights from the
    REMAINING folds, predict the held (even) frame, accumulate MSE. The
    temporal-only baseline competes as candidate (0,0,0), so the field is
    kept only when the folds themselves say it transfers; no odd-frame data
    is touched. With fewer than two folds there is nothing to nest — the
    temporal-only baseline is returned."""
    if len(folds) < 2:
        return (0.0, 0.0, 0.0)
    F = folds[0][1].shape[0]
    nfold = len(folds)
    wt_h = _heldout_temporal_weights(folds, shrink)
    # smoothed per-fold error fields, computed once per sigma and averaged
    # over the candidate's training folds (blur is linear, so the subset
    # mean of blurred fields equals the blurred subset mean)
    errs = [np.asarray((p - t[None]) ** 2, np.float64) for _, p, t in folds]
    sm_cache: Dict[float, np.ndarray] = {}
    n_total = sum(t.size for _, _, t in folds)
    # temporal-only baseline (the (0,0,0) candidate)
    base_se = sum(
        float(np.sum((np.einsum("f...,f->...", p_h, wt_h[j]) - tgt_h) ** 2))
        for j, (_, p_h, tgt_h) in enumerate(folds))
    best, best_mse = (0.0, 0.0, 0.0), base_se / n_total
    # Candidate loop factored by (sigma, temp): the softmin field ws does
    # not depend on the blend weight ss, so build it once per (sigma, temp,
    # fold) and reuse across the ss grid (3x fewer full-field exps/projs —
    # this search is the wall-clock bulk of a cache-driven 4D refresh).
    sigs = sorted({s for s, _, _ in _SPATIAL_CANDIDATES if s > 0.0})
    temps = sorted({t for s, t, _ in _SPATIAL_CANDIDATES if s > 0.0})
    sss = sorted({x for s, _, x in _SPATIAL_CANDIDATES if s > 0.0})
    for sig in sigs:
        if sig not in sm_cache:
            sm_cache[sig] = np.stack(
                [np.stack([_gaussian_smooth(e, sig) for e in fe]) for fe in errs])
        for temp in temps:
            se = {ss: 0.0 for ss in sss}
            for j, (_, p_h, tgt_h) in enumerate(folds):
                sm = sm_cache[sig][[i for i in range(nfold) if i != j]].mean(axis=0)
                # max with tiny: all-zero fold errors (synthetic caches)
                # would otherwise divide 0/0 into a nan field
                ws = _proj_field(np.moveaxis(
                    np.exp(-sm / (temp * max(sm.mean(), 1e-30))), 0, -1))
                for ss in sss:
                    w = _proj_field((1 - ss) * ws + ss * wt_h[j])
                    pred = np.einsum("f...,...f->...", p_h, w)
                    se[ss] += float(np.sum((pred - tgt_h) ** 2))
            for ss in sss:
                if se[ss] / n_total < best_mse:
                    best, best_mse = (sig, temp, ss), se[ss] / n_total
    return best


def fusion_oracles(deploy: np.ndarray, target: np.ndarray) -> dict:
    """CHEATING upper bounds for linear fusion of ``deploy`` (F, spatial...,
    T) against ground truth — the headroom analysis, never a result row.

    Returns PSNRs for: the global simplex oracle, the per-time simplex
    oracle, the per-time unconstrained least-squares oracle (the ceiling of
    ANY honest weight schedule that is constant per frame), and the
    per-voxel best-single-family oracle (the ceiling of per-voxel
    selection). On the ankle caches the honest stacked rows sit within
    ~0.35 dB of the per-time oracle — fusion is saturated; further held-out
    gains require better base families (see RESULTS.md)."""
    F = deploy.shape[0]
    T = deploy.shape[-1]

    def _psnr(x):
        return float(-10.0 * np.log10(np.mean((x - target) ** 2)))

    w = simplex_lstsq(deploy.reshape(F, -1), target.reshape(-1))
    out = {"global_simplex": _psnr(np.einsum("f...,f->...", deploy, w))}
    per_t = np.empty_like(target)
    for ti in range(T):
        wt = simplex_lstsq(deploy[..., ti].reshape(F, -1),
                           target[..., ti].reshape(-1))
        per_t[..., ti] = np.einsum("f...,f->...", deploy[..., ti], wt)
    out["per_time_simplex"] = _psnr(per_t)
    for ti in range(T):
        A = deploy[..., ti].reshape(F, -1).T
        wt, *_ = np.linalg.lstsq(A, target[..., ti].reshape(-1), rcond=None)
        per_t[..., ti] = (A @ wt).reshape(target.shape[:-1])
    out["per_time_unconstrained"] = _psnr(per_t)
    pick = ((deploy - target[None]) ** 2).argmin(axis=0)
    out["per_voxel_best_family"] = _psnr(
        np.take_along_axis(deploy, pick[None], 0)[0])
    return out


def stacked_fuse(
    train_frames: np.ndarray,
    t_keep: np.ndarray,
    t_new: np.ndarray,
    families: Mapping[str, FamilyFn],
    shrink: float = 0.5,
    loo: bool = True,
    cache_dir: Optional[str] = None,
    spatial: object = "off",
    robust: object = "off",
) -> Tuple[np.ndarray, dict]:
    """Fuse the families' predictions at ``t_new`` with honestly-selected
    weights: every family is deployed on all kept frames; simplex weights are
    solved on the LOO fold errors (global + per-position, shrunk, then
    interpolated from the fold positions to ``t_new``). Only kept-frame
    information is used end to end. Returns (fused (spatial..., len(t_new)),
    weights dict).

    ``spatial``: per-voxel weighting on top of the temporal schedule.
    ``"off"`` (default) keeps the temporal-only weights; ``"nested"`` runs
    the nested leave-one-fold-out selection (``_select_spatial_nested``) —
    the temporal-only baseline competes, so this can only be picked when the
    folds themselves say the field transfers; a ``(sigma, temp,
    spatial_shrink)`` tuple forces those hyperparameters. Either way the
    field comes from ``spatial_weight_field`` (pooled fold errors), so no
    ``t_new`` ground truth is consulted.

    ``robust``: shrink the fused estimate toward the per-voxel MEDIAN of the
    family predictions (robust to the per-voxel outlier family that squared
    -error weights cannot defend against). ``"median_nested"`` selects the
    shrink weight by nested LOO (``_select_median_shrink_nested``; lam=0
    competes); a float forces it. Requires the LOO fold path."""
    names = list(families)
    deploy = np.stack([
        _cached_call(cache_dir, f"deploy_{n}",
                     lambda n=n: families[n](train_frames, t_keep, t_new))
        for n in names
    ])

    if loo and train_frames.shape[-1] >= 3:
        folds, _ = loo_fold_predictions(train_frames, t_keep, families, cache_dir)
        all_p = np.concatenate([p.reshape(len(names), -1) for _, p, _ in folds], axis=1)
        all_t = np.concatenate([t.reshape(-1) for _, _, t in folds])
        w_global = simplex_lstsq(all_p, all_t)
        pos, w_pos = [], []
        for t_held, p, t in folds:
            wk = simplex_lstsq(p.reshape(len(names), -1), t.reshape(-1))
            pos.append(t_held)
            w_pos.append(shrink * w_global + (1.0 - shrink) * wk)
        pos = np.asarray(pos)
        w_pos = np.stack(w_pos)                     # (n_folds, F)
        # interpolate weights to the deployment positions, then re-project
        w_new = np.stack([
            np.interp(t_new, pos, w_pos[:, f]) for f in range(len(names))
        ], axis=-1)
        w_new = _proj_field(w_new)
        weights = {"global": dict(zip(names, map(float, w_global))),
                   "per_position": {float(t): dict(zip(names, map(float, w)))
                                    for t, w in zip(t_new, w_new)}}
        spatial_kept = None
        if spatial != "off":
            if spatial == "nested":
                sig, temp, ss = _select_spatial_nested(folds, shrink)
            else:
                sig, temp, ss = spatial
            weights["spatial"] = {"sigma": float(sig), "temp": float(temp),
                                  "spatial_shrink": float(ss)}
            if sig > 0.0:
                spatial_kept = (sig, temp, ss)
            if sig > 0.0:
                ws = spatial_weight_field(folds, sig, temp)  # (spatial..., F)
                sp = ws.shape[:-1]
                w_new = _proj_field(
                    (1 - ss) * ws[..., None, :]
                    + ss * w_new.reshape((1,) * len(sp) + w_new.shape))
                # w_new is now a (spatial..., T, F) FIELD; the einsum and
                # fusion_uncertainty below broadcast over either layout.
                # Re-record per_position from the field's spatial mean so the
                # reported schedule describes the fusion actually applied
                # (the pre-blend temporal weights alone no longer do).
                w_mean = w_new.reshape(-1, *w_new.shape[-2:]).mean(axis=0)
                weights["per_position"] = {
                    float(t): dict(zip(names, map(float, w)))
                    for t, w in zip(t_new, w_mean)}
        if robust != "off":
            lam = (_select_median_shrink_nested(folds, shrink,
                                                spatial_params=spatial_kept)
                   if robust == "median_nested" else float(robust))
            weights["robust"] = {"mode": "median_shrink", "lam": lam}
    else:
        if spatial != "off" or robust != "off":
            import warnings

            warnings.warn(
                "stacked_fuse: spatial=%r/robust=%r requested but the LOO "
                "fold path is inactive (loo=False or <3 kept frames) — both "
                "need fold errors to exist, so they are ignored"
                % (spatial, robust), stacklevel=2)
        w_new = np.full((len(t_new), len(names)), 1.0 / len(names))
        weights = {"global": dict(zip(names, [1.0 / len(names)] * len(names)))}

    fused = _weighted_fuse(deploy, w_new)
    lam = weights.get("robust", {}).get("lam", 0.0)
    if lam > 0.0:
        fused = (1.0 - lam) * fused + lam * np.median(deploy, axis=0)
    # private channel for the uncertainty map (fusion_uncertainty needs the
    # per-family predictions + per-position weights); every public caller
    # pops it before returning weights to users (tested not to leak)
    weights["_components"] = (deploy, w_new)
    return fused, weights


def _weighted_fuse(preds: np.ndarray, w: np.ndarray) -> np.ndarray:
    """sum_f w_f(t[, x]) preds_f — ``w`` is either (T, F) per-time weights or
    a (spatial..., T, F) per-voxel field."""
    if w.ndim == 2:
        return np.einsum("f...t,tf->...t", preds, w)
    return np.einsum("f...t,...tf->...t", preds, w)


def fusion_uncertainty(preds: np.ndarray, weights: np.ndarray,
                       eps: float = 0.1) -> np.ndarray:
    """Per-voxel predictive uncertainty of the stacked estimator: the
    weight-weighted standard deviation of the family predictions around the
    fused mean. Needs NO ground truth — the signal is family DISAGREEMENT,
    available wherever the fusion itself is (including deployment-time
    temporal super-resolution of an observed sequence).

    ``preds``: (F, spatial..., T) family predictions; ``weights``: (T, F)
    per-position simplex weights, or a (spatial..., T, F) per-voxel field
    (the ``spatial=`` fusion layout). Returns (spatial..., T) >= 0.

    The sigma weights are floored toward uniform,
    ``w_eff = (1-eps) w + eps/F``: the LOO solver routinely returns one-hot
    weights (a single dominant family), under which a purely weight-weighted
    variance is identically zero — certainty by fiat, not by agreement. On
    the real ankle cache the weighted and uniform variants calibrate almost
    identically (Spearman 0.886 vs 0.863 vs held-out |error|), so the floor
    costs nothing and keeps the map informative in the one-hot regime.

    Voxels where the motion families and the intensity families agree get
    ~0; regions where they diverge (fast motion, through-plane effects) get
    large sigma. ``uncertainty_calibration`` quantifies how well this tracks
    the true error on the held-out protocol.

    Approximation note: when the deployed fusion also applies a
    median-shrink blend (``robust=``, lam > 0), sigma describes the
    weighted-mean component only — the median blend moves the point
    estimate WITHIN the family envelope whose spread sigma measures, so
    the disagreement scale (what the calibration validates) is unchanged,
    but sigma is not the exact second moment of the shipped estimator.
    """
    preds = np.asarray(preds, np.float32)
    w = np.asarray(weights, np.float32)
    F = w.shape[-1]
    w = (1.0 - eps) * w + eps / F
    fused = _weighted_fuse(preds, w)
    var = _weighted_fuse((preds - fused[None]) ** 2, w)
    return np.sqrt(np.maximum(var, 0.0))


def uncertainty_calibration(sigma: np.ndarray, err: np.ndarray,
                            n_bins: int = 10) -> dict:
    """How well does predicted sigma track the actual |error|?

    Returns Pearson r (on |err| vs sigma), Spearman rho (rank corr, robust
    to the heavy-tailed error distribution), and a risk-coverage curve: for
    each retention fraction (keeping the LOWEST-sigma voxels), the RMSE over
    the retained set — a monotonically increasing curve means the map is
    usable for triage (e.g. "trust the synthesized frame except the flagged
    5%%")."""
    s = np.asarray(sigma, np.float64).reshape(-1)
    e = np.abs(np.asarray(err, np.float64).reshape(-1))

    def _pearson(a, b):
        a = a - a.mean()
        b = b - b.mean()
        den = np.sqrt((a * a).sum() * (b * b).sum())
        return float((a * b).sum() / den) if den > 0 else 0.0

    def _rank(x):
        order = np.argsort(x, kind="stable")
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(x))
        return r

    order = np.argsort(s, kind="stable")
    e_sorted = e[order]
    cum_sq = np.cumsum(e_sorted ** 2)
    coverage, rmse = [], []
    for frac in np.linspace(0.1, 1.0, n_bins):
        k = max(int(round(frac * len(e_sorted))), 1)
        coverage.append(float(frac))
        rmse.append(float(np.sqrt(cum_sq[k - 1] / k)))
    return {
        "pearson_r": _pearson(s, e),
        "spearman_rho": _pearson(_rank(s), _rank(e)),
        "risk_coverage": {"coverage": coverage, "rmse": rmse},
    }


def stacked_temporal_upsample(
    frames: np.ndarray,
    t_factor: int = 2,
    config: Optional[TrainConfig] = None,
    families: Optional[Mapping[str, FamilyFn]] = None,
    seeds: Sequence[int] = (1337, 7, 23, 99),
    shrink: float = 0.5,
    cache_dir: Optional[str] = None,
    return_uncertainty: bool = False,
    spatial: object = "off",
    robust: object = "off",
    device: DeviceLike = None,
    **warp_kwargs,
) -> Tuple[np.ndarray, dict]:
    """Temporal super-resolution of an OBSERVED sequence — the deployable
    counterpart of the even-frame protocol (no ground truth required):
    synthesize the ``t_factor``-upsampled time grid, observed frames passing
    through untouched, in-between frames fused across the predictor families
    with weights selected by LOO over the observed frames.

    Returns (upsampled (spatial..., t_factor*(T-1)+1), weights dict); with
    ``return_uncertainty=True``, (upsampled, weights, sigma) where sigma is
    the per-voxel family-disagreement confidence map (zero at the observed
    frames, which pass through untouched) — see ``fusion_uncertainty``.
    """
    frames = np.asarray(frames, np.float32)
    T = frames.shape[-1]
    if T < 3:
        raise ValueError("need at least 3 frames for honest weight selection")
    t_up = t_factor * (T - 1) + 1
    t_keep = np.linspace(0.0, 1.0, T)
    new_idx = [i for i in range(t_up) if i % t_factor != 0]
    t_new = np.asarray([i / (t_up - 1) for i in new_idx])
    if config is None:
        config = TrainConfig(batch_size=10000, epochs=100, lr=1e-2,
                             optimizer="adam_tcnn", lr_schedule="cosine",
                             cosine_t_max=100, weight_decay=1e-5)
    if families is None:
        families = default_interp_families(
            config, frames.shape[:-1] + (t_up,), seeds, device=device, **warp_kwargs)
    fused, weights = stacked_fuse(frames, t_keep, t_new, families,
                                  shrink=shrink, cache_dir=cache_dir,
                                  spatial=spatial, robust=robust)
    deploy, w_new = weights.pop("_components")
    out = np.zeros(frames.shape[:-1] + (t_up,), np.float32)
    out[..., ::t_factor] = frames
    out[..., new_idx] = fused
    if return_uncertainty:
        sigma = np.zeros_like(out)
        sigma[..., new_idx] = fusion_uncertainty(deploy, w_new)
        return out, weights, sigma
    return out, weights


def _main(argv=None):
    """CLI: honest stacked temporal super-resolution of a NIfTI volume.

    python -m mri_interpolation_tpu_torch.train.stacking vol.nii.gz --factor 2 \\
        --out vol_sr.nii.gz [--slice_z 3] [--families warp,registration,linear] \\
        [--device cpu]
    """
    import argparse
    import json

    from ..io import load_volume
    from ..io.nifti import save as nifti_save

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("image")
    ap.add_argument("--out", default="stacked_sr.nii.gz")
    ap.add_argument("--factor", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=10000)
    ap.add_argument("--seeds", default="1337,7,23,99")
    ap.add_argument("--families", default=None,
                    help="comma-separated subset of the default families")
    ap.add_argument("--slice_z", type=int, default=None,
                    help="take one z slice of a 4D volume (2D+t workload)")
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--uncertainty_out", default=None,
                    help="also write the per-voxel confidence map (family "
                         "disagreement sigma) as a NIfTI volume")
    ap.add_argument("--device", default=None, help="device to run on: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    slice_axes = None
    if args.slice_z is not None:
        slice_axes = (slice(None), slice(None), args.slice_z, slice(None))
    ds = load_volume(args.image, slice_axes=slice_axes)
    cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=1e-2,
                      optimizer="adam_tcnn", lr_schedule="cosine",
                      cosine_t_max=args.epochs, weight_decay=1e-5)
    include = tuple(args.families.split(",")) if args.families else None
    res = stacked_temporal_upsample(
        ds.image(), t_factor=args.factor, config=cfg,
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        include=include, cache_dir=args.cache_dir,
        return_uncertainty=args.uncertainty_out is not None, device=args.device)
    out, weights = res[0], res[1]
    nifti_save(out, args.out)
    rec = {"out": args.out, "shape": list(out.shape),
           "global_weights": weights["global"]}
    if args.uncertainty_out is not None:
        nifti_save(res[2], args.uncertainty_out)
        rec["uncertainty_out"] = args.uncertainty_out
        rec["sigma_mean"] = float(res[2].mean())
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    _main()
