"""Training loop (port of ``mri_interpolation_tpu/train/trainer.py``:
``Trainer.fit`` and ``Trainer.fit_frames``).

The whole (coords, values) set is copied to the device once; each epoch
draws a permutation from a seeded ``torch.Generator`` and every step gathers
its batch on the device, runs forward and backward (the hash-encode kernel
pair on the card) and one Adam update. Per-step losses stay on the device
until the epoch ends, so the loop syncs with the host once per epoch.

Semantics kept: Adam with torch's weight decay (L2 added to the gradient
before the moments, as the JAX optimizer chain does), ``drop_last`` (default
True) and, when it is False, the final batch padded by wrapping around to
the permutation's start; ``shuffle=False`` walks the data in order.
``optimizer="adam_tcnn"`` is tcnn's Adam (b2 0.99, eps 1e-15). Cosine
schedules and gradient accumulation are not ported yet (ROADMAP.md, queue 1)
and raise.

``fit_frames`` fits the multi-frame models: one step per whole frame, the
frames in order every epoch, the model called as ``model(x, frame_idx=t)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.core import Model
from .losses import get_loss

__all__ = ["TrainConfig", "TrainResult", "Trainer", "make_optimizer"]


@dataclass
class TrainConfig:
    batch_size: int = 10000
    epochs: int = 1
    lr: float = 5e-3
    weight_decay: float = 0.0
    seed: int = 1337
    optimizer: str = "adam"
    lr_schedule: Optional[str] = None
    cosine_t_max: int = 10
    accumulate_grad_batches: int = 1
    loss: str = "mse"
    shuffle: bool = True
    drop_last: bool = True


@dataclass
class TrainResult:
    losses: np.ndarray  # per-step train loss
    wall_time_s: float
    steps_per_sec: float
    steps: int
    epoch_times_s: np.ndarray = field(default_factory=lambda: np.array([]))

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1]) if len(self.losses) else float("nan")

    @property
    def steady_steps_per_sec(self) -> float:
        """Steps/s over the epochs after the first (which pays kernel builds
        and warm-up); the whole-fit rate when there is one epoch."""
        if len(self.epoch_times_s) <= 1:
            return self.steps_per_sec
        steps_per_epoch = self.steps / len(self.epoch_times_s)
        return float(steps_per_epoch / max(float(np.median(self.epoch_times_s[1:])), 1e-9))


# optimizer name -> (betas, eps): torch's Adam defaults, and tcnn's Adam
# config (config/hash_config.json of the reference: beta2 0.99, eps 1e-15)
_ADAM = {"adam": ((0.9, 0.999), 1e-8), "adam_tcnn": ((0.9, 0.99), 1e-15)}


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """torch Adam with L2 weight decay: b1 0.9, b2 0.999, eps 1e-8 for
    ``"adam"``; b1 0.9, b2 0.99, eps 1e-15 for ``"adam_tcnn"``."""
    if cfg.optimizer not in _ADAM:
        raise KeyError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.lr_schedule is not None:
        raise NotImplementedError(f"lr_schedule={cfg.lr_schedule!r} is not ported yet: ROADMAP.md, queue 1")
    if cfg.accumulate_grad_batches > 1:
        raise NotImplementedError("accumulate_grad_batches > 1 is not ported yet: ROADMAP.md, queue 1")
    betas, eps = _ADAM[cfg.optimizer]
    return torch.optim.Adam(params, lr=cfg.lr, betas=betas, eps=eps, weight_decay=cfg.weight_decay)


def _result(epoch_losses, epoch_times, wall: float) -> TrainResult:
    """The TrainResult of a fit: per-step losses of every epoch, in order."""
    losses = np.concatenate(epoch_losses) if epoch_losses else np.array([])
    return TrainResult(losses=losses, wall_time_s=wall,
                       steps_per_sec=len(losses) / wall if wall > 0 else float("inf"), steps=len(losses),
                       epoch_times_s=np.asarray(epoch_times))


class Trainer:
    """Fits a Model to a (coords, values) regression set on one device."""

    def __init__(self, config: TrainConfig):
        self.config = config

    def fit(self, model: Model, coords: np.ndarray, values: np.ndarray,
            device: DeviceLike = None) -> TrainResult:
        """Train ``model`` in place on ``device`` (``cuda`` unless "cpu")."""
        cfg = self.config
        dev = resolve_device(device)
        n = len(coords)
        batch = min(cfg.batch_size, n)
        steps_per_epoch = n // batch if cfg.drop_last else -(-n // batch)
        if steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch} exceeds dataset size {n}")

        model.to(dev).train()
        optimizer = make_optimizer(cfg, model.parameters())
        loss_fn = get_loss(cfg.loss)
        coords_d = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
        values_d = torch.as_tensor(np.asarray(values, dtype=np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        all_losses, epoch_times = [], []
        t0 = time.perf_counter()
        for _ in range(cfg.epochs):
            te = time.perf_counter()
            if cfg.shuffle:
                perm = torch.randperm(n, generator=gen, device=dev)
            else:
                perm = torch.arange(n, device=dev)
            pad = steps_per_epoch * batch - n
            if pad > 0:  # drop_last=False: wrap the final batch around
                perm = torch.cat([perm, perm[:pad]])
            idx = perm[: steps_per_epoch * batch].view(steps_per_epoch, batch)
            losses = torch.empty(steps_per_epoch, device=dev)
            for s in range(steps_per_epoch):
                xb = coords_d[idx[s]]
                yb = values_d[idx[s]]
                loss = loss_fn(model(xb), yb)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses[s] = loss.detach()
            all_losses.append(losses.cpu().numpy())  # the epoch's one host sync
            epoch_times.append(time.perf_counter() - te)
        return _result(all_losses, epoch_times, time.perf_counter() - t0)

    def fit_frames(self, model: Model, frame_coords: np.ndarray, frame_values: np.ndarray,
                   device: DeviceLike = None) -> TrainResult:
        """Train a multi-frame model in place on ``device`` (``cuda`` unless
        "cpu"): each epoch one optimizer step per whole frame, frames visited
        in order (the reference's frames data module: batch = one frame, no
        shuffle). ``frame_coords`` is (T, N, d), or (N, d) shared by every
        frame; ``frame_values`` is (T, N, 1). Both are copied to the device
        once and stay there for the whole fit."""
        cfg = self.config
        dev = resolve_device(device)
        n_frames = frame_values.shape[0]
        model.to(dev).train()
        optimizer = make_optimizer(cfg, model.parameters())
        loss_fn = get_loss(cfg.loss)
        coords_d = torch.as_tensor(np.asarray(frame_coords, dtype=np.float32)).to(dev)
        values_d = torch.as_tensor(np.asarray(frame_values, dtype=np.float32)).to(dev)
        shared = coords_d.ndim == 2

        all_losses, epoch_times = [], []
        t0 = time.perf_counter()
        for _ in range(cfg.epochs):
            te = time.perf_counter()
            losses = torch.empty(n_frames, device=dev)
            for t in range(n_frames):
                loss = loss_fn(model(coords_d if shared else coords_d[t], frame_idx=t), values_d[t])
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses[t] = loss.detach()
            all_losses.append(losses.cpu().numpy())  # the epoch's one host sync
            epoch_times.append(time.perf_counter() - te)
        return _result(all_losses, epoch_times, time.perf_counter() - t0)
