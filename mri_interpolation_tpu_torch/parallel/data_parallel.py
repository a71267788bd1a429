"""Data-parallel fitting and sharded grid evaluation over a process group.

Port of ``mri_interpolation_tpu/parallel/data_parallel.py``. The recipe is
the JAX package's: every rank holds the whole model and the whole
(coords, values) set, each step's global batch is split over the ranks,
each rank computes its gradient on its share, and one ``all_reduce`` over
one flat buffer averages the gradients, the BatchNorm batch statistics
(the running buffers a forward writes) and the loss before every rank
takes the same optimizer step. Integer buffers (the level-anneal counter)
advance alike on every rank and are left out of the sum.

Semantics kept from the JAX package:

- the global batch is ``min(batch_size, n)`` rounded down to a multiple of
  the world size (``ValueError`` at 0), ``n // batch`` steps an epoch, the
  last partial batch dropped;
- every epoch is shuffled, whatever ``cfg.shuffle`` says; the epoch's
  batches are laid out ``(steps, world, local)`` and rank ``r`` takes column
  ``r``. Every rank draws the port's ``Trainer.fit`` permutation (one
  ``torch.Generator`` seeded ``cfg.seed``, one ``randperm`` an epoch), so at
  world size 1 the fit is ``Trainer.fit``'s, step for step;
- ``fit_streaming`` keeps ``Trainer.fit_streaming``'s shard rotation and
  numpy permutation; each shard is split into the ranks' rows with the
  ``(steps, world, local) -> (world, steps, local)`` layout, and each rank
  synthesises only its own rows;
- the epoch hooks (scalars, eval, checkpoints) run on rank 0 only: the JAX
  package is one process and writes each file once.

``fit_multi_volume`` fits one model per volume, ``V / world`` on each rank
with no traffic between ranks during the fit; ``evaluate_grid_sharded``
stripes a grid's chunks over the ranks and gathers the volume on every
rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..infer.grid import _check_model_on, _volume, _walk
from ..models.core import Model
from ..ops.hash_mlp_grid import chunk_index, flat_index_to_coords
from ..train.losses import get_loss
from ..train.trainer import TrainConfig, Trainer, TrainResult, _Ranks, _refuse_complex, _step_loss, _Updates
from .mesh import RankGroup, all_gather, make_mesh, mean_over_ranks

__all__ = ["DataParallelTrainer", "fit_multi_volume", "evaluate_grid_sharded"]


def _global_batch(batch_size: int, n: int, world: int) -> int:
    batch = min(batch_size, n)
    batch -= batch % world
    if batch == 0:
        raise ValueError(f"batch_size {batch_size} < n_devices {world}")
    return batch


class _StepMean:
    """One data-parallel step's averaging: gradients (zeros where the loss
    did not reach a parameter, JAX's zero cotangent), float buffers and the
    loss, in one ``all_reduce``. The gradients become views of the reduced
    buffer; the buffers are copied back in place."""

    def __init__(self, mesh: RankGroup, model: Model):
        self.mesh = mesh
        self.params = list(model.parameters())
        self.buffers = [b for b in model.buffers() if b.is_floating_point()]

    def __call__(self, loss: torch.Tensor) -> torch.Tensor:
        if self.mesh.group is None:
            return loss
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        means = mean_over_ranks(self.mesh, grads + self.buffers + [loss.reshape(1)])
        for p, g in zip(self.params, means):
            p.grad = g
        with torch.no_grad():
            for b, m in zip(self.buffers, means[len(self.params):]):
                b.copy_(m)
        return means[-1].reshape(())


class DataParallelTrainer:
    """Data-parallel version of ``train.Trainer.fit`` and ``fit_streaming``
    over ``mesh`` (default: :func:`make_mesh` of the default group on
    ``device``). Every rank calls the same method with the same arguments;
    the model is trained in place on every rank, and every rank returns the
    same losses. Both methods run ``Trainer``'s own loop with this rank's
    part in it (its column of each global batch, the step's mean over the
    ranks, the hooks on rank 0)."""

    def __init__(self, config: TrainConfig, mesh: Optional[RankGroup] = None, device=None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh(device=device)

    def _trainer(self, model: Model, n: int):
        """``Trainer`` on the global batch (every epoch shuffled, the last
        partial batch dropped) and this rank's part, the model on its device."""
        cfg, mesh = self.config, self.mesh
        batch = _global_batch(cfg.batch_size, n, mesh.world_size)
        model.to(mesh.device)  # _StepMean holds the buffers where the fit leaves them
        ranks = _Ranks(mesh.world_size, mesh.rank, _StepMean(mesh, model))
        return Trainer(dataclasses.replace(cfg, batch_size=batch, shuffle=True, drop_last=True)), ranks

    def fit(self, model: Model, coords: np.ndarray, values: np.ndarray,
            eval_fn: Optional[Callable] = None) -> TrainResult:
        """``eval_fn(model) -> {tag: value}``: eval records every
        ``cfg.eval_every_epochs`` epochs into the scalars stream (rank 0)."""
        trainer, ranks = self._trainer(model, len(coords))
        return trainer._fit(model, coords, values, self.mesh.device, eval_fn, ranks)

    def fit_streaming(self, model: Model, volume, shard_voxels: int = 1 << 22, lo: float = 0.0, hi: float = 1.0,
                      value_range=None, eval_fn: Optional[Callable] = None) -> TrainResult:
        """Out-of-core and data-parallel: ``Trainer.fit_streaming``'s shard
        rotation, each shard split into the ranks' rows, so a rank holds
        ``shard_voxels / world`` voxels of (coords, values) on its device at
        a time. The arguments are ``Trainer.fit_streaming``'s."""
        trainer, ranks = self._trainer(model, int(np.prod(volume.shape)))
        return trainer._fit_streaming(model, volume, shard_voxels, lo, hi, value_range, self.mesh.device, eval_fn,
                                      ranks)


def _state_vector(model: Model) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float32) for t in model.state_dict().values()])


def _load_state_vector(model: Model, flat: torch.Tensor) -> None:
    state = model.state_dict()
    chunks = flat.split([t.numel() for t in state.values()])
    with torch.no_grad():
        for t, chunk in zip(state.values(), chunks):
            t.copy_(chunk.view_as(t).to(t.dtype))


def fit_multi_volume(models: Union[Sequence[Model], Callable[[int], Model]], coords: np.ndarray,
                     values: np.ndarray, config: TrainConfig, mesh: Optional[RankGroup] = None) -> TrainResult:
    """Fit one model per volume, the volumes split over the ranks.

    ``coords`` (N, d) is the grid every volume shares, ``values`` (V, N, 1)
    one intensity set per volume; V must be a multiple of the world size.
    ``models``: the V initial models (all alike), or a factory called with
    the seed ``config.seed + v`` for volume v. Rank r fits volumes ``r *
    V / world`` to ``(r + 1) * V / world - 1``, each as the JAX package does:
    ``min(batch_size, n)`` rows a step, ``n // batch`` steps an epoch, every
    epoch shuffled (volume v from its own ``torch.Generator`` seeded
    ``config.seed + v``), the model's output scored by ``config.loss``,
    ``remat`` honoured, no epoch hooks. After the fit one ``all_gather`` hands every rank every
    fitted model's parameters and buffers. Returns the losses as (V, steps),
    ``steps_per_sec`` counting ``steps x V``, and the V models in
    ``models``, each on the mesh's device."""
    mesh = mesh if mesh is not None else make_mesh()
    world, rank, dev = mesh.world_size, mesh.rank, mesh.device
    n_volumes = values.shape[0]
    if n_volumes % world != 0:
        raise ValueError(f"n_volumes {n_volumes} must be divisible by mesh size {world}")
    models = [models(config.seed + v) for v in range(n_volumes)] if callable(models) else list(models)
    if len(models) != n_volumes:
        raise ValueError(f"{len(models)} models for {n_volumes} volumes")
    n = len(coords)
    batch = min(config.batch_size, n)
    steps_per_epoch = n // batch
    per_rank = n_volumes // world
    mine = range(rank * per_rank, (rank + 1) * per_rank)
    base_loss = get_loss(config.loss)
    coords_d = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)

    losses = torch.empty((per_rank, config.epochs * steps_per_epoch), device=dev)
    epoch_times = np.zeros(config.epochs)
    t0 = time.perf_counter()
    for i, v in enumerate(mine):
        model = models[v].to(dev).train()
        _refuse_complex(model)
        updates = _Updates(config, model, steps_per_epoch)
        values_d = torch.as_tensor(np.asarray(values[v], dtype=np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(config.seed + v)
        for e in range(config.epochs):
            te = time.perf_counter()
            perm = torch.randperm(n, generator=gen, device=dev)
            idx = perm[: steps_per_epoch * batch].view(steps_per_epoch, batch)
            for s in range(steps_per_epoch):
                loss = _step_loss(model, lambda x, y: base_loss(model(x), y), coords_d[idx[s]], values_d[idx[s]],
                                  config.remat)
                updates.zero_grad()
                loss.backward()
                updates.step()
                losses[i, e * steps_per_epoch + s] = loss.detach()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            epoch_times[e] += time.perf_counter() - te
    wall = time.perf_counter() - t0

    gathered = all_gather(mesh, torch.stack([_state_vector(models[v].to(dev)) for v in mine]))
    for v in range(n_volumes):
        if v not in mine:
            _load_state_vector(models[v].to(dev), gathered[v // per_rank, v % per_rank])
    all_losses = all_gather(mesh, losses).reshape(n_volumes, -1).cpu().numpy()
    total_steps = config.epochs * steps_per_epoch
    return TrainResult(losses=all_losses, wall_time_s=wall,
                       steps_per_sec=total_steps * n_volumes / wall if wall > 0 else float("inf"),
                       steps=total_steps, epoch_times_s=epoch_times, models=models)


@torch.no_grad()
def evaluate_grid_sharded(model: Model, shape: Sequence[int], mesh: Optional[RankGroup] = None, lo: float = 0.0,
                          hi: float = 1.0, chunk_size: int = 1 << 17) -> np.ndarray:
    """Evaluate ``model`` (in eval mode, on the mesh's device) on the dense
    grid ``shape`` with its chunks split over the ranks; every rank returns
    the whole volume (``shape``, plus a trailing axis when dim_out > 1).

    The chunk is ``min(chunk_size, ceil(n / world))`` voxels; rank r takes
    ``chunks_per_rank`` consecutive chunks from ``r * chunks_per_rank``
    through the grid's chunk walk (the padded tail repeats the last voxel),
    synthesises their coordinates on its device
    (``infer.flat_index_to_coords``) and runs the model's forward; one
    ``all_gather`` brings the ranks' outputs together."""
    mesh = mesh if mesh is not None else make_mesh()
    world, rank, dev = mesh.world_size, mesh.rank, mesh.device
    _check_model_on(model, dev)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    chunk_size = min(chunk_size, -(-n // world))
    chunks_per_rank = -(-n // (world * chunk_size))
    first = rank * chunks_per_rank * chunk_size  # this rank's first voxel

    def write(start: int, stop: int, out: torch.Tensor) -> None:
        out[start:stop] = model(flat_index_to_coords(chunk_index(first + start, stop - start, n, dev), shape, lo, hi))

    out = _walk(model, n, chunk_size, dev, write, n_chunks=chunks_per_rank)
    return _volume(all_gather(mesh, out).reshape(-1, model.dim_out)[:n].cpu().numpy(), shape)
