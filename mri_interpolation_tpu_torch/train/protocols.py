"""Named training protocols (port of ``mri_interpolation_tpu/train/protocols.py``).

- ``key_frame_subset``: the rows of a C-ordered (coords, values) set that
  belong to given time frames;
- ``two_phase_hash_fit``: fit on key frames, then freeze every parameter
  outside the encoder and fit on all the data;
- ``even_frame_fit_eval``: train on the even frames (time remapped to their
  place in the whole volume), reconstruct the whole grid, score the held-out
  odd frames;
- ``undersampled_fit_eval``: fit from a random share of the voxels
  (``utils.create_rn_mask``), reconstruct the whole grid, score it beside
  the zero-filled baseline;
- ``ensembled_warp_fit_eval``: the even-frame protocol fitted once per
  seed, the full-grid reconstructions averaged (and optionally blended with
  the linear baseline), then scored;
- ``registration_interp_eval``: the even-frame protocol for the pairwise
  registration interpolator (``infer/registration.py``), which fits no
  network.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..infer import evaluate_grid, linear_interpolate_volume
from ..io.volume import even_frame_split, even_frame_training_set, flat_coords
from ..metrics import evaluate_reconstruction
from ..models.core import Model
from ..utils.imaging import create_rn_mask
from .trainer import TrainConfig, Trainer, TrainResult

__all__ = ["key_frame_subset", "two_phase_hash_fit", "even_frame_fit_eval", "undersampled_fit_eval",
           "ensembled_warp_fit_eval", "registration_interp_eval"]


def registration_interp_eval(image: np.ndarray, device: DeviceLike = None, **reg_kwargs) -> Tuple[np.ndarray, dict]:
    """The even-frame protocol scored for the pairwise registration
    interpolator: the even frames pass through, each odd frame is the
    motion-compensated midpoint of its neighbours
    (``motion_compensated_upsample(..., **reg_kwargs)`` on ``device``).
    Returns (reconstruction, {"full": metrics, "odd": metrics})."""
    from ..infer.registration import motion_compensated_upsample

    dev = resolve_device(device)
    train_img, _ = even_frame_split(image)
    recon = motion_compensated_upsample(train_img, image.shape[-1], device=dev, **reg_kwargs)
    full_q, odd_q = _scores(recon, image, 1.0, dev)
    return recon, {"full": full_q, "odd": odd_q}


def key_frame_subset(coords: np.ndarray, values: np.ndarray, image_shape: Sequence[int],
                     key_frames: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of (coords, values) in the given time frames: time is the last
    axis of ``image_shape`` and the rows are C-ordered over it, so frame f
    owns every row with index % T == f."""
    t = int(image_shape[-1])
    mask = np.isin(np.arange(len(values)) % t, list(key_frames))
    return coords[mask], values[mask]


def two_phase_hash_fit(model: Model, coords: np.ndarray, values: np.ndarray, image_shape: Sequence[int],
                       key_frames: Sequence[int] = (3, 7, 13), pretrain_config: Optional[TrainConfig] = None,
                       train_config: Optional[TrainConfig] = None, device: DeviceLike = None,
                       between_phases: Optional[Callable[[Model], None]] = None) -> Tuple[TrainResult, TrainResult]:
    """Phase 1 fits ``model`` on the key frames; phase 2, with a fresh
    optimizer, every parameter outside ``encoder.`` frozen (the trainer's
    freeze mask), on all the data. Returns (phase 1, phase 2).
    ``between_phases(model)`` runs after phase 1: the JAX function returns
    phase 1's parameters, where the port trains one model in place."""
    pretrain_config = pretrain_config or TrainConfig(batch_size=5000, epochs=10, lr=5e-3)
    train_config = train_config or TrainConfig(batch_size=10000, epochs=10, lr=5e-3)
    dev = resolve_device(device)
    kc, kv = key_frame_subset(coords, values, image_shape, key_frames)
    phase1 = Trainer(pretrain_config).fit(model, kc, kv, device=dev)
    if between_phases is not None:
        between_phases(model)
    freeze = lambda named: {k: k.startswith("encoder.") for k in named}  # noqa: E731  (True: trainable)
    phase2 = Trainer(train_config, freeze_mask_fn=freeze).fit(model, coords, values, device=dev)
    return phase1, phase2


def _scores(recon: np.ndarray, image: np.ndarray, data_range: float, dev) -> Tuple[dict, dict]:
    """The quality of ``recon`` on the whole volume and on its odd frames."""
    _, odd = even_frame_split(image)
    full_q = evaluate_reconstruction(recon, image, data_range=data_range, device=dev)
    odd_q = evaluate_reconstruction(recon[..., 1::2][..., :odd.shape[-1]], odd, data_range=data_range, device=dev)
    return full_q, odd_q


def even_frame_fit_eval(model: Model, image: np.ndarray, config: TrainConfig, zero_centered: bool = False,
                        device: DeviceLike = None) -> Tuple[TrainResult, dict]:
    """Train on the even frames, reconstruct the whole grid, score it.
    Returns (result, {"full": metrics, "odd": metrics})."""
    dev = resolve_device(device)
    lo = -1.0 if zero_centered else 0.0
    coords, values = even_frame_training_set(image, zero_centered)
    result = Trainer(config).fit(model, coords, values, device=dev)
    recon = evaluate_grid(model, image.shape, lo=lo, device=dev)
    full_q, odd_q = _scores(recon, image, 2.0 if zero_centered else 1.0, dev)
    return result, {"full": full_q, "odd": odd_q}


def undersampled_fit_eval(model: Model, image: np.ndarray, percentage: float, config: TrainConfig,
                          zero_centered: bool = False, mask_seed: int = 0, device: DeviceLike = None
                          ) -> Tuple[TrainResult, dict]:
    """Fit from the ``percentage``% of the voxels that
    ``create_rn_mask(image.shape, percentage, key=mask_seed)`` keeps,
    reconstruct the whole grid, and score it against the volume beside the
    zero-filled baseline (kept voxels as they are, the rest at the
    background level). Returns (result, {"recon": metrics, "zero_filled":
    metrics, "kept_fraction": f})."""
    dev = resolve_device(device)
    lo = -1.0 if zero_centered else 0.0
    data_range = 2.0 if zero_centered else 1.0
    mask, kept = create_rn_mask(image.shape, percentage, key=mask_seed)
    coords = flat_coords(image.shape, lo=lo)[kept]
    values = image.reshape(-1, 1)[kept]
    result = Trainer(config).fit(model, coords, values, device=dev)
    recon = evaluate_grid(model, image.shape, lo=lo, device=dev)
    mask = mask.reshape(image.shape)
    zero_filled = image * mask + lo * (1.0 - mask)
    return result, {
        "recon": evaluate_reconstruction(recon, image, data_range=data_range, device=dev),
        "zero_filled": evaluate_reconstruction(zero_filled, image, data_range=data_range, device=dev),
        "kept_fraction": float(len(kept)) / float(np.prod(image.shape)),
    }


def ensembled_warp_fit_eval(make_model: Callable[[int], Model], image: np.ndarray, config: TrainConfig,
                            seeds: Sequence[int] = (1337, 7, 23, 99), linear_blend: float = 0.0,
                            zero_centered: bool = False, device: DeviceLike = None) -> dict:
    """The seed-ensembled even-frame protocol: for each seed, fit
    ``make_model(seed)`` (the JAX trainer draws each fit's init from its
    seed; the port's factories take it) on the even frames with
    ``dataclasses.replace(config, seed=seed)`` and reconstruct the whole
    grid; average the reconstructions, blend them with the linear baseline
    from the even frames (``pred = (1 - b) * ensemble + b * linear``) when
    ``linear_blend`` b > 0, and score. Returns {"odd": metrics, "full":
    metrics, "per_seed_odd_psnr": [...]}."""
    dev = resolve_device(device)
    lo = -1.0 if zero_centered else 0.0
    data_range = 2.0 if zero_centered else 1.0
    coords, values = even_frame_training_set(image, zero_centered)
    recons, per_seed = [], []
    for seed in seeds:
        model = make_model(seed)
        Trainer(dataclasses.replace(config, seed=seed)).fit(model, coords, values, device=dev)
        recon = evaluate_grid(model, image.shape, lo=lo, device=dev)
        q = evaluate_reconstruction(recon[..., 1::2], image[..., 1::2], data_range=data_range, device=dev)
        per_seed.append(float(q["psnr"]))
        recons.append(recon)
    pred = np.mean(recons, axis=0)
    if linear_blend > 0.0:
        lin = linear_interpolate_volume(image[..., ::2], image.shape, device=dev)
        pred = (1.0 - linear_blend) * pred + linear_blend * lin
    return {"odd": evaluate_reconstruction(pred[..., 1::2], image[..., 1::2], data_range=data_range, device=dev),
            "full": evaluate_reconstruction(pred, image, data_range=data_range, device=dev),
            "per_seed_odd_psnr": per_seed}
