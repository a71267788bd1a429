"""Training loop (port of ``mri_interpolation_tpu/train/trainer.py``:
``Trainer.fit``, ``Trainer.fit_frames`` and ``EpochHooks``).

The whole (coords, values) set is copied to the device once; each epoch
draws a permutation from a seeded ``torch.Generator`` and every step gathers
its batch on the device, runs forward and backward (the hash-encode kernel
pair on the card) and one optimizer update. Per-step losses stay on the
device until the epoch ends, so the loop syncs with the host once per epoch;
the epoch hooks (scalars, eval, checkpoints) run then, outside the epoch's
clock.

The optimizer is the JAX trainer's optax chain over torch's Adam, in its
order: the freeze mask zeroes frozen gradients (``masked(set_to_zero)``);
``accumulate_grad_batches = k`` averages k mini-steps' gradients and makes
one inner update every k (``MultiSteps``); the inner update adds the weight
decay to the gradient (torch Adam's L2, ``add_decayed_weights``) and takes an
Adam step at the schedule's rate. The schedule (constant, or ``"cosine"``:
``optax.cosine_decay_schedule``) and Adam count inner updates, while the
cosine's length is ``cosine_t_max`` epochs of mini-steps: with k > 1 it
reaches only 1/k of its decay, as in the JAX package. Other semantics kept:
``drop_last`` (default True) and, when it is False, the final batch padded
by wrapping around to the permutation's start; ``shuffle=False`` walks the
data in order; ``optimizer="adam_tcnn"`` is tcnn's Adam (b2 0.99, eps
1e-15); a model with a ``loss(x, y)`` method is trained on it in place of
``loss_fn(model(x), y)``; a model with complex parameters is refused
(``NotImplementedError``); ``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``), value-identical to the plain step.

``fit_frames`` fits the multi-frame models: one step per whole frame, the
frames in order every epoch, the model called as ``model(x, frame_idx=t)``.
As in the JAX package it takes the schedule, the accumulation and the freeze
mask, and no loss hook, epoch hooks or remat.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.core import Model
from .losses import get_loss

__all__ = ["TrainConfig", "TrainResult", "Trainer", "EpochHooks", "make_optimizer", "make_schedule"]


@dataclass
class TrainConfig:
    batch_size: int = 10000
    epochs: int = 1
    lr: float = 5e-3
    weight_decay: float = 0.0
    seed: int = 1337
    optimizer: str = "adam"
    lr_schedule: Optional[str] = None  # None | "cosine" (over cosine_t_max epochs)
    cosine_t_max: int = 10
    accumulate_grad_batches: int = 1
    loss: str = "mse"
    shuffle: bool = True
    drop_last: bool = True
    log_jsonl: Optional[str] = None  # per-step train_loss (and eval) records; None: none
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 0  # 0: no epoch checkpoints
    eval_every_epochs: int = 0  # 0: no eval records (fit's eval_fn)
    remat: bool = False  # recompute the forward in the backward


@dataclass
class TrainResult:
    losses: np.ndarray  # per-step train loss
    wall_time_s: float
    steps_per_sec: float
    steps: int
    epoch_times_s: np.ndarray = field(default_factory=lambda: np.array([]))
    hook_time_s: float = 0.0  # epoch hooks' seconds: in wall_time_s, not in epoch_times_s

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
    ``"adam"``; b1 0.9, b2 0.99, eps 1e-15 for ``"adam_tcnn"``. Its rate is
    set before every update from :func:`make_schedule`."""
    if cfg.optimizer not in _ADAM:
        raise KeyError(f"unknown optimizer {cfg.optimizer!r}")
    betas, eps = _ADAM[cfg.optimizer]
    return torch.optim.Adam(params, lr=cfg.lr, betas=betas, eps=eps, weight_decay=cfg.weight_decay)


def make_schedule(cfg: TrainConfig, n_steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The rate of inner update ``count`` (0 for the first): ``cfg.lr``, or
    for ``"cosine"`` ``optax.cosine_decay_schedule(lr, D)``: ``lr * (1 +
    cos(pi * min(count, D) / D)) / 2`` with D = max(cosine_t_max *
    n_steps_per_epoch, 1), 0 from update D on (not cyclic)."""
    if cfg.lr_schedule is None:
        return lambda count: cfg.lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}; the JAX package has None and 'cosine'")
    decay = max(cfg.cosine_t_max * n_steps_per_epoch, 1)
    return lambda count: cfg.lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))


class _Updates:
    """The JAX trainer's optimizer chain over torch's Adam, one
    :meth:`step` a mini-step after ``backward``: frozen gradients zeroed,
    then the running mean of ``accumulate_grad_batches`` mini-steps (optax's
    Welford form, ``acc + (g - acc) / (n + 1)``), then Adam (with its L2
    weight decay) at the scheduled rate once per window. A partial window at
    the end of a fit makes no update. With no mask, no accumulation and a
    constant rate the chain is Adam alone, and :meth:`step` is torch Adam's
    step (which would skip a parameter the loss did not reach; every
    parameter of the port's models reaches it)."""

    def __init__(self, cfg: TrainConfig, model: Model, n_steps_per_epoch: int,
                 freeze_mask_fn: Optional[Callable] = None):
        named = dict(model.named_parameters())
        self.params: List[torch.nn.Parameter] = list(named.values())
        self.frozen: List[torch.nn.Parameter] = []
        if freeze_mask_fn is not None:
            mask = freeze_mask_fn(named)
            if set(mask) != set(named):
                raise ValueError(f"the freeze mask names {sorted(mask)}, the model's parameters are {sorted(named)}")
            self.frozen = [named[k] for k, trainable in mask.items() if not trainable]
        self.optimizer = make_optimizer(cfg, self.params)
        self.schedule = make_schedule(cfg, n_steps_per_epoch)
        self.k = cfg.accumulate_grad_batches
        if self.k < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {self.k}")
        self.plain = not self.frozen and self.k == 1 and cfg.lr_schedule is None
        self.updates = 0  # inner updates so far: Adam's and the schedule's count
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.plain:
            self.optimizer.step()
            self.updates += 1
            return
        for p in self.params:
            if p.grad is None:  # the JAX gradient of an unused leaf is zero, and Adam still moves it
                p.grad = torch.zeros_like(p)
        for p in self.frozen:
            p.grad.zero_()
        if self.k > 1:
            m = self.mini_step
            grads = [p.grad for p in self.params]
            self.acc = grads if m == 0 else [a + (g - a) / (m + 1) for a, g in zip(self.acc, grads)]
            self.mini_step = (m + 1) % self.k
            if self.mini_step:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a
            self.acc = None
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1

    def state_dict(self) -> Dict:
        return {"adam": self.optimizer.state_dict(), "updates": self.updates, "mini_step": self.mini_step,
                "acc": self.acc}


@contextlib.contextmanager
def _buffers_held_at(model: Model, values: List[torch.Tensor]):
    """Inside: the model's buffers hold ``values``; after: what they held on
    entry, whatever was written to them inside."""
    bufs = list(model.buffers())
    held = [b.clone() for b in bufs]
    with torch.no_grad():
        for b, v in zip(bufs, values):
            b.copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for b, h in zip(bufs, held):
                b.copy_(h)


def _step_loss(model: Model, loss_fn: Callable, x: torch.Tensor, y: torch.Tensor, remat: bool) -> torch.Tensor:
    """``loss_fn(x, y)``; under ``remat`` through a non-reentrant
    ``torch.utils.checkpoint``. A forward writes the model's buffers
    (BatchNorm statistics, the level-anneal counter); the recomputation in
    the backward sees the buffers as the forward found them and its writes
    are undone, so each advances exactly once a step."""
    if not remat:
        return loss_fn(x, y)
    before = [b.clone() for b in model.buffers()]
    return checkpoint(loss_fn, x, y, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _buffers_held_at(model, before)))


class EpochHooks:
    """Per-epoch housekeeping of ``Trainer.fit`` (JAX ``EpochHooks``): the
    scalars stream (``cfg.log_jsonl``: each epoch's per-step losses, steps
    numbered from 0), every ``eval_every_epochs`` epochs ``eval_fn(model) ->
    {tag: value}`` logged at the epoch's last step count (only with a
    scalars stream, as there), and every ``checkpoint_every_epochs`` epochs
    a checkpoint with the optimizer state in ``checkpoint_dir``."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, eval_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.eval_fn = eval_fn
        self.logger = None
        if cfg.log_jsonl:
            from .scalars import ScalarLogger

            self.logger = ScalarLogger(cfg.log_jsonl)

    def after_epoch(self, e: int, losses: np.ndarray, model: Model,
                    optimizer_state: Optional[Callable[[], Dict]] = None) -> None:
        cfg, spe = self.cfg, self.steps_per_epoch
        if self.logger is not None:
            self.logger.log_epoch_losses(e, e * spe, losses)
        if (self.eval_fn is not None and self.logger is not None and cfg.eval_every_epochs > 0
                and (e + 1) % cfg.eval_every_epochs == 0):
            for tag, value in self.eval_fn(model).items():
                self.logger.log((e + 1) * spe, tag, float(value), epoch=e)
        if cfg.checkpoint_dir and cfg.checkpoint_every_epochs > 0 and (e + 1) % cfg.checkpoint_every_epochs == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(cfg.checkpoint_dir, (e + 1) * spe, model.state_dict(),
                            optimizer_state() if optimizer_state is not None else None)

    def close(self) -> None:
        if self.logger is not None:
            self.logger.close()


def _result(epoch_losses, epoch_times, wall: float, hook_s: float = 0.0) -> TrainResult:
    """The TrainResult of a fit: per-step losses of every epoch, in order."""
    losses = np.concatenate(epoch_losses) if epoch_losses else np.array([])
    return TrainResult(losses=losses, wall_time_s=wall,
                       steps_per_sec=len(losses) / wall if wall > 0 else float("inf"), steps=len(losses),
                       epoch_times_s=np.asarray(epoch_times), hook_time_s=hook_s)


class Trainer:
    """Fits a Model to a (coords, values) regression set on one device.

    ``freeze_mask_fn(named_parameters) -> {name: bool}`` (True: trainable)
    freezes parameters as the JAX ``masked(set_to_zero)``: a frozen
    parameter's gradient is zeroed, so only weight decay moves it."""

    def __init__(self, config: TrainConfig, freeze_mask_fn: Optional[Callable] = None):
        self.config = config
        self.freeze_mask_fn = freeze_mask_fn

    def fit(self, model: Model, coords: np.ndarray, values: np.ndarray,
            device: DeviceLike = None, eval_fn: Optional[Callable] = None) -> TrainResult:
        """Train ``model`` in place on ``device`` (``cuda`` unless "cpu").
        ``eval_fn(model) -> {tag: value}``: eval records every
        ``eval_every_epochs`` epochs into the scalars stream."""
        cfg = self.config
        dev = resolve_device(device)
        if any(p.is_complex() for p in model.parameters()):
            raise NotImplementedError(
                "complex parameters (the complex GaborNet) are not trainable: the JAX trainer cannot fit them "
                "either, so no reference holds such a fit (ROADMAP.md, section 3)")
        n = len(coords)
        batch = min(cfg.batch_size, n)
        steps_per_epoch = n // batch if cfg.drop_last else -(-n // batch)
        if steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch} exceeds dataset size {n}")

        model.to(dev).train()
        updates = _Updates(cfg, model, steps_per_epoch, self.freeze_mask_fn)
        base_loss = get_loss(cfg.loss)
        hook = model.loss

        def loss_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            return hook(x, y) if hook is not None else base_loss(model(x), y)

        coords_d = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
        values_d = torch.as_tensor(np.asarray(values, dtype=np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        hooks = EpochHooks(cfg, steps_per_epoch, eval_fn)

        all_losses, epoch_times, hook_s = [], [], 0.0
        t0 = time.perf_counter()
        try:
            for e in range(cfg.epochs):
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
                    loss = _step_loss(model, loss_fn, xb, yb, cfg.remat)
                    updates.zero_grad()
                    loss.backward()
                    updates.step()
                    losses[s] = loss.detach()
                epoch_losses = losses.cpu().numpy()  # the epoch's one host sync
                epoch_times.append(time.perf_counter() - te)
                all_losses.append(epoch_losses)
                th = time.perf_counter()
                hooks.after_epoch(e, epoch_losses, model, updates.state_dict)
                hook_s += time.perf_counter() - th
        finally:
            hooks.close()
        return _result(all_losses, epoch_times, time.perf_counter() - t0, hook_s)

    def fit_frames(self, model: Model, frame_coords: np.ndarray, frame_values: np.ndarray,
                   device: DeviceLike = None) -> TrainResult:
        """Train a multi-frame model in place on ``device`` (``cuda`` unless
        "cpu"): each epoch one mini-step per whole frame, frames visited in
        order (the reference's frames data module: batch = one frame, no
        shuffle); the cosine runs over ``cosine_t_max`` epochs of frames.
        ``frame_coords`` is (T, N, d), or (N, d) shared by every frame;
        ``frame_values`` is (T, N, 1). Both are copied to the device once and
        stay there for the whole fit."""
        cfg = self.config
        dev = resolve_device(device)
        n_frames = frame_values.shape[0]
        model.to(dev).train()
        updates = _Updates(cfg, model, n_frames, self.freeze_mask_fn)
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
                updates.zero_grad()
                loss.backward()
                updates.step()
                losses[t] = loss.detach()
            all_losses.append(losses.cpu().numpy())  # the epoch's one host sync
            epoch_times.append(time.perf_counter() - te)
        return _result(all_losses, epoch_times, time.perf_counter() - t0)
