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
``loss_fn(model(x), y)``; ``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``), value-identical to the plain step.

Complex parameters (the complex GaborNet, WIRE) are trained as pairs of
real numbers: torch's ``.grad`` of the real loss in ``z = p + i q`` is
dL/dp + i dL/dq, and torch's Adam steps over ``view_as_real`` of the
parameters, gradients and moments, so a complex leaf takes exactly the
update its real and imaginary parts would take as two real leaves. The
schedule, the freeze mask, the accumulation window and the checkpoint's
optimizer state hold complex leaves as they hold real ones; the loss is
real. A real model's step is unchanged. The JAX trainer cannot fit this
kind; ``benchmark/reference_wire.py`` is the reference such a fit is held
to.

``fit_frames`` fits the multi-frame models: one step per whole frame, the
frames in order every epoch, the model called as ``model(x, frame_idx=t)``.
As in the JAX package it takes the schedule, the accumulation and the freeze
mask, and no loss hook, epoch hooks or remat.

``fit_streaming`` is the out-of-core fit: only one shard of (coords,
values) lies on the device at a time. Each epoch draws one global
permutation of the flat voxel indices from a numpy ``default_rng(seed)``
(the JAX package's draw, so both packages see the same batches), cuts it
into equal shards (the tail padded from the permutation's head), and
synthesises each shard's coordinates and values on the host
(``make_host_shard_fn``, copied from the JAX package with
``resolve_value_range`` and ``flatten_volume_source``). A worker thread
synthesises the next shard into pinned memory while the steps of the
current one are issued; its copy runs on a side stream, the steps wait on
the copy's event, and the pinned buffer is held until that event has
completed. The host-synthesis and host-to-device seconds of each epoch are
in the result.

``fit`` and ``fit_streaming`` also run one rank's part of a data-parallel
fit (``parallel.DataParallelTrainer`` calls their loops with a
:class:`_Ranks`): the rank's column of every global batch, the step's mean
over the ranks after ``backward``, and the epoch hooks on rank 0 alone.
"""

from __future__ import annotations

import contextlib
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models.core import Model
from ..tracing import span
from .losses import get_loss

__all__ = ["TrainConfig", "TrainResult", "Trainer", "EpochHooks", "make_optimizer", "make_schedule",
           "resolve_value_range", "make_host_shard_fn", "flatten_volume_source"]


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
    # fit_streaming, per epoch: host synthesis seconds (worker thread), host-to-device copy seconds
    # (the copies' CUDA events; host copy time on the CPU), and the seconds the loop waited for a shard
    host_synth_s: np.ndarray = field(default_factory=lambda: np.array([]))
    h2d_s: np.ndarray = field(default_factory=lambda: np.array([]))
    shard_wait_s: np.ndarray = field(default_factory=lambda: np.array([]))
    models: Optional[List[Model]] = None  # parallel.fit_multi_volume: the fitted model of each volume

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
    the end of a fit makes no update."""

    def __init__(self, cfg: TrainConfig, params: Union[Model, Dict[str, torch.nn.Parameter]], n_steps_per_epoch: int,
                 freeze_mask_fn: Optional[Callable] = None):
        named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
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
        self.updates = 0  # inner updates so far: Adam's and the schedule's count
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
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
        if _eval_fires(cfg, self.eval_fn, e):
            for tag, value in self.eval_fn(model).items():
                self.logger.log((e + 1) * spe, tag, float(value), epoch=e)
        if _checkpoint_fires(cfg, e):
            from .checkpoint import save_checkpoint

            save_checkpoint(cfg.checkpoint_dir, (e + 1) * spe, model.state_dict(),
                            optimizer_state() if optimizer_state is not None else None)

    def close(self) -> None:
        if self.logger is not None:
            self.logger.close()


def _eval_fires(cfg: TrainConfig, eval_fn: Optional[Callable], e: int) -> bool:
    """Whether :meth:`EpochHooks.after_epoch` of epoch ``e`` logs an eval record."""
    return (eval_fn is not None and bool(cfg.log_jsonl) and cfg.eval_every_epochs > 0
            and (e + 1) % cfg.eval_every_epochs == 0)


def _checkpoint_fires(cfg: TrainConfig, e: int) -> bool:
    """Whether :meth:`EpochHooks.after_epoch` of epoch ``e`` writes a checkpoint."""
    return bool(cfg.checkpoint_dir) and cfg.checkpoint_every_epochs > 0 and (e + 1) % cfg.checkpoint_every_epochs == 0


def resolve_value_range(flat_values, n: int, chunk: int, value_range):
    """(vmin, vscale) for streaming min-max normalization
    (io.normalize_intensity semantics). ``None`` scans the source in chunks
    (memmap-friendly); ``False`` disables; a (vmin, vmax) tuple is direct."""
    if value_range is None:
        vmin, vmax = np.inf, -np.inf
        for start in range(0, n, chunk):
            c = np.asarray(flat_values[start:start + chunk], np.float32)
            vmin, vmax = min(vmin, float(c.min())), max(vmax, float(c.max()))
    elif value_range is False:
        vmin, vmax = 0.0, 1.0
    else:
        vmin, vmax = (float(v) for v in value_range)
    return vmin, 1.0 / max(vmax - vmin, 1e-12)


def make_host_shard_fn(shape, lo, hi, flat_values, vmin, vscale, order: str = "C"):
    """Host-side (coords, values) synthesis for flat voxel indices (numpy;
    the coordinates of ``infer.flat_index_to_coords`` / ``io.make_mgrid``).

    ``order="F"``: ``flat_values`` is Fortran-ordered on disk (NIfTI's
    layout, io.nifti.load_memmap); the C-order flat index's per-axis digits
    are re-folded with Fortran strides for the value fetch, so the mapped
    file is indexed as it is, with no reordering copy."""
    shape = tuple(int(s) for s in shape)
    strides = np.concatenate([np.cumprod(shape[::-1])[::-1][1:], [1]]).astype(np.int64)
    fstrides = np.concatenate([[1], np.cumprod(shape[:-1])]).astype(np.int64)

    def host_shard(idx: np.ndarray):
        coords = np.empty((idx.size, len(shape)), np.float32)
        vidx = idx if order == "C" else np.zeros_like(idx)
        for k in range(len(shape)):
            digit = (idx // strides[k]) % shape[k]
            coords[:, k] = lo + (hi - lo) * digit / max(shape[k] - 1, 1)
            if order == "F":
                vidx = vidx + digit * fstrides[k]
        vals = (np.asarray(flat_values[vidx], np.float32) - vmin) * vscale
        return coords, vals.reshape(-1, 1)

    return host_shard


def flatten_volume_source(volume):
    """(flat_values, order): a no-copy 1-D view of ``volume`` and the layout
    tag for make_host_shard_fn. Fortran-contiguous sources (memmapped NIfTI)
    are flattened in their native order, where a C-order reshape would
    materialise the whole file."""
    if hasattr(volume, "flags") and volume.ndim > 1 and volume.flags.f_contiguous \
            and not volume.flags.c_contiguous:
        return volume.reshape(-1, order="F"), "F"
    if hasattr(volume, "reshape"):
        return volume.reshape(-1), "C"
    return np.asarray(volume).reshape(-1), "C"


class _ShardFeed:
    """The shards of a streamed fit, one ahead: :meth:`submit` has a worker
    thread synthesise a shard on the host (into pinned memory on the card)
    while the caller issues the steps of the one before; :meth:`get` copies
    it to the device on a side stream and makes the current stream wait on
    the copy's event. A pinned buffer is held until its copy's event has
    completed. :meth:`drain` returns an epoch's seconds (host synthesis,
    host-to-device copies, the caller's wait for a shard) after the caller
    has synchronised."""

    def __init__(self, synth: Callable, dev: torch.device):
        self.synth, self.dev = synth, dev
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.future = None
        self.held: List = []  # (copy event, pinned tensors) until the event has completed
        self.copies: List = []  # (start, end) events of this epoch's copies
        self.synth_s = self.wait_s = 0.0

    def _host(self, idx: np.ndarray):
        t0 = time.perf_counter()
        coords, values = (torch.from_numpy(a) for a in self.synth(idx))
        if self.copy_stream is not None:
            coords, values = coords.pin_memory(), values.pin_memory()
        return coords, values, time.perf_counter() - t0

    def submit(self, idx: np.ndarray) -> None:
        self.future = self.pool.submit(self._host, idx)

    def get(self):
        t0 = time.perf_counter()
        coords, values, synth_s = self.future.result()
        self.wait_s += time.perf_counter() - t0
        self.synth_s += synth_s
        if self.copy_stream is None:
            return coords, values
        self.held = [(ev, bufs) for ev, bufs in self.held if not ev.query()]
        current = torch.cuda.current_stream(self.dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record()
            coords_d = coords.to(self.dev, non_blocking=True)
            values_d = values.to(self.dev, non_blocking=True)
            end.record()
        current.wait_event(end)
        coords_d.record_stream(current)  # allocated on the copy stream, used on the current one
        values_d.record_stream(current)
        self.held.append((end, (coords, values)))
        self.copies.append((start, end))
        return coords_d, values_d

    def drain(self):
        h2d = sum(a.elapsed_time(b) for a, b in self.copies) / 1e3  # no copies on the CPU
        out = (self.synth_s, h2d, self.wait_s)
        self.held, self.copies = [], []
        self.synth_s = self.wait_s = 0.0
        return out

    def close(self) -> None:
        self.pool.shutdown(wait=True)


@dataclass(frozen=True)
class _Ranks:
    """A process's part in a data-parallel fit (``parallel.DataParallelTrainer``):
    rank ``rank`` of ``world`` takes column ``rank`` of every global batch
    laid out ``(world, batch / world)``, ``mean(loss)`` averages the step's
    gradients, float buffers and loss over the ranks after ``backward`` and
    returns the mean loss, and the epoch hooks run on rank 0 alone. The
    default is a fit in one process."""

    world: int = 1
    rank: int = 0
    mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _take_step(model: Model, loss_fn: Callable, updates: "_Updates", x: torch.Tensor, y: torch.Tensor,
               remat: bool, mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """One mini-step: loss, backward, ``mean`` over the ranks (if any), the
    optimizer chain; the (mean) loss, detached."""
    with span("mri.train.forward"):
        loss = _step_loss(model, loss_fn, x, y, remat)
    with span("mri.train.backward"):
        updates.zero_grad()
        loss.backward()
        loss = loss.detach() if mean is None else mean(loss.detach())
    with span("mri.train.optimizer"):
        updates.step()
    return loss


def _model_loss(model: Model, loss: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``model.loss(x, y)`` where the model has that hook, else the named
    loss of ``model(x)`` against ``y``."""
    base_loss = get_loss(loss)
    hook = model.loss

    def loss_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return hook(x, y) if hook is not None else base_loss(model(x), y)

    return loss_fn


def _after_epoch(hooks: Optional[EpochHooks], e: int, losses: np.ndarray, model: Model, updates: _Updates) -> float:
    """The epoch hooks (none on a rank other than 0); their seconds."""
    if hooks is None:
        return 0.0
    th = time.perf_counter()
    with span("mri.train.hooks"):
        hooks.after_epoch(e, losses, model, updates.state_dict)
    return time.perf_counter() - th


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
        return self._fit(model, coords, values, resolve_device(device), eval_fn, _Ranks())

    def _fit(self, model: Model, coords: np.ndarray, values: np.ndarray, dev: torch.device,
             eval_fn: Optional[Callable], ranks: _Ranks) -> TrainResult:
        cfg = self.config
        n = len(coords)
        batch = min(cfg.batch_size, n)
        steps_per_epoch = n // batch if cfg.drop_last else -(-n // batch)
        if steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch} exceeds dataset size {n}")

        model.to(dev).train()
        updates = _Updates(cfg, model, steps_per_epoch, self.freeze_mask_fn)
        loss_fn = _model_loss(model, cfg.loss)
        coords_d = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
        values_d = torch.as_tensor(np.asarray(values, dtype=np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        hooks = EpochHooks(cfg, steps_per_epoch, eval_fn) if ranks.rank == 0 else None

        all_losses, epoch_times, hook_s = [], [], 0.0
        t0 = time.perf_counter()
        try:
            for e in range(cfg.epochs):
                te = time.perf_counter()
                with span("mri.train.shuffle"):
                    if cfg.shuffle:
                        perm = torch.randperm(n, generator=gen, device=dev)
                    else:
                        perm = torch.arange(n, device=dev)
                    pad = steps_per_epoch * batch - n
                    if pad > 0:  # drop_last=False: wrap the final batch around
                        perm = torch.cat([perm, perm[:pad]])
                    idx = perm[: steps_per_epoch * batch].view(steps_per_epoch, ranks.world, -1)[:, ranks.rank]
                    losses = torch.empty(steps_per_epoch, device=dev)
                for s in range(steps_per_epoch):
                    with span("mri.train.step"):
                        losses[s] = _take_step(model, loss_fn, updates, coords_d[idx[s]], values_d[idx[s]],
                                               cfg.remat, ranks.mean)
                with span("mri.train.sync"):
                    epoch_losses = losses.cpu().numpy()  # the epoch's one host sync
                epoch_times.append(time.perf_counter() - te)
                all_losses.append(epoch_losses)
                hook_s += _after_epoch(hooks, e, epoch_losses, model, updates)
        finally:
            if hooks is not None:
                hooks.close()
        return _result(all_losses, epoch_times, time.perf_counter() - t0, hook_s)

    def fit_streaming(self, model: Model, volume, shard_voxels: int = 1 << 22, lo: float = 0.0, hi: float = 1.0,
                      value_range=None, device: DeviceLike = None,
                      eval_fn: Optional[Callable] = None) -> TrainResult:
        """Out-of-core fit of ``model`` in place on ``device`` (``cuda``
        unless "cpu") to the grid ``volume`` (any array-like, ``np.memmap``
        included: values are fancy-indexed a shard at a time, so the whole
        volume need not be in memory; the host pays 8 bytes a voxel for the
        epoch's int64 permutation).

        The JAX package's shard arithmetic: ``steps_per_shard = shard //
        batch`` with ``shard = min(max(shard_voxels, batch), n)``, ``n_shards
        = ceil(n / shard)`` shards an epoch, the last one padded from the
        permutation's head; grids of 2^31 voxels or more are refused. Each
        epoch is one ``np.random.default_rng(cfg.seed).permutation(n)``
        (``shuffle`` and ``drop_last`` are not read). Coordinates run from
        ``lo`` to ``hi``; values are min-max normalised as
        ``io.dataset_from_array`` does, ``value_range=(vmin, vmax)`` gives
        the range (sparing the scan over the source) and ``False`` leaves
        the values as they are. Schedule, accumulation, freeze mask, remat,
        the loss hook and the epoch hooks are ``fit``'s, with the cosine over
        ``n_shards * steps_per_shard`` steps an epoch."""
        return self._fit_streaming(model, volume, shard_voxels, lo, hi, value_range, resolve_device(device), eval_fn,
                                   _Ranks())

    def _fit_streaming(self, model: Model, volume, shard_voxels: int, lo: float, hi: float, value_range,
                       dev: torch.device, eval_fn: Optional[Callable], ranks: _Ranks) -> TrainResult:
        cfg = self.config
        shape = tuple(int(s) for s in volume.shape)
        n = int(np.prod(shape))
        if n >= 2**31:
            raise ValueError(f"grid {shape} exceeds int32 flat indexing")
        batch = min(cfg.batch_size, n)
        shard = min(max(shard_voxels, batch), n)
        steps_per_shard = shard // batch  # equal shapes; the tail wraps
        shard = steps_per_shard * batch
        n_shards = -(-n // shard)
        steps_per_epoch = n_shards * steps_per_shard

        model.to(dev).train()
        updates = _Updates(cfg, model, steps_per_epoch, self.freeze_mask_fn)
        loss_fn = _model_loss(model, cfg.loss)
        flat_values, vorder = flatten_volume_source(volume)
        vmin, vscale = resolve_value_range(flat_values, n, shard, value_range)
        feed = _ShardFeed(make_host_shard_fn(shape, lo, hi, flat_values, vmin, vscale, vorder), dev)
        hooks = EpochHooks(cfg, steps_per_epoch, eval_fn) if ranks.rank == 0 else None
        local = batch // ranks.world

        def my_rows(idx: np.ndarray) -> np.ndarray:
            # the shard's global batches laid out (steps, world, local): this rank's column, step by step
            return idx.reshape(steps_per_shard, ranks.world, local)[:, ranks.rank].reshape(-1)

        rng = np.random.default_rng(cfg.seed)
        all_losses, epoch_times, hook_s, streamed = [], [], 0.0, []
        t0 = time.perf_counter()
        try:
            for e in range(cfg.epochs):
                te = time.perf_counter()
                perm = rng.permutation(n).astype(np.int64)
                pad = n_shards * shard - n
                if pad:
                    perm = np.concatenate([perm, perm[:pad]])
                feed.submit(my_rows(perm[:shard]))
                losses = torch.empty(steps_per_epoch, device=dev)
                for s in range(n_shards):
                    coords_d, values_d = feed.get()
                    if s + 1 < n_shards:  # the next shard's host synthesis overlaps this one's steps
                        feed.submit(my_rows(perm[(s + 1) * shard:(s + 2) * shard]))
                    for j in range(steps_per_shard):
                        with span("mri.train.step"):
                            rows = slice(j * local, (j + 1) * local)
                            losses[s * steps_per_shard + j] = _take_step(model, loss_fn, updates, coords_d[rows],
                                                                         values_d[rows], cfg.remat, ranks.mean)
                    del coords_d, values_d  # free this shard before the next one's copy allocates
                with span("mri.train.sync"):
                    epoch_losses = losses.cpu().numpy()  # the epoch's one host sync
                epoch_times.append(time.perf_counter() - te)
                streamed.append(feed.drain())
                all_losses.append(epoch_losses)
                hook_s += _after_epoch(hooks, e, epoch_losses, model, updates)
        finally:
            if hooks is not None:
                hooks.close()
            feed.close()
        result = _result(all_losses, epoch_times, time.perf_counter() - t0, hook_s)
        if streamed:
            result.host_synth_s, result.h2d_s, result.shard_wait_s = (np.asarray(c) for c in zip(*streamed))
        return result

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
