"""Hash-table sharding over a process group (port of
``mri_interpolation_tpu/parallel/sharded_table.py``).

The fused ``(total_size, F)`` hash table is the one part of a model whose
memory can outgrow one card. ``plan_table_sharding`` (numpy) partitions it
into per-rank slots: a level larger than a rank's fair share is split into
one contiguous row range per rank (dense levels on whole time-lines, so the
temporal-TV prior stays rank-local), the rest are bin-packed whole by size.
``plan.py`` reads it for ``--plan_devices``.

- ``shard_table`` / ``unshard_table``: the fused table to the ranks'
  ``(world, local_rows, F)`` shards and back, exact;
- the sharded encode (:func:`make_sharded_encode`), plain PyTorch as the
  JAX package's is plain ``jnp``: every rank computes the corner geometry
  of the single-table path (``HashGridEncoding.corner_ids_and_weights``),
  gathers only from its own slots (a corner outside them gets weight 0),
  and contributes an ``(N, S*F)`` block of partial features; one
  ``all_gather`` brings the blocks together and the plan's ``(world*S, L)``
  0/1 matrix sums them in logical level order. The ``all_gather`` is this
  module's own autograd function, whose backward hands each rank its own
  slice of the gathered cotangent. Every rank runs the decoder on the same
  features, so every rank holds the same cotangent, and that slice is the
  single-table gradient of the rank's rows. (The JAX package differentiates
  through ``all_gather``, whose transpose sums the ranks' identical copies:
  its table gradient is ``world`` times the single-table one; ROADMAP.md,
  "Not queued". ``torch.distributed.nn.functional.all_gather`` would do the
  same.)
- :class:`ShardedHashTrainer` fits a ``make_hash_mlp`` model with its table
  sharded; the decoder is replicated.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..encodings.hashgrid import HashGridEncoding
from ..infer.grid import _volume, _walk
from ..models.core import Model
from ..models.hash_mlp import as_f32
from ..ops.hash_mlp_grid import chunk_index, flat_index_to_coords
from ..train.losses import get_loss
from ..train.trainer import (EpochHooks, TrainConfig, TrainResult, _checkpoint_fires, _eval_fires, _result,
                             _step_loss, _Updates)
from .mesh import RankGroup, all_gather, all_reduce_sum_, make_mesh, mean_over_ranks

__all__ = ["TableShardingPlan", "plan_table_sharding", "shard_table", "unshard_table", "make_sharded_encode",
           "sharded_encode_apply", "evaluate_grid_sharded_table", "ShardedHashTrainer"]


@dataclass
class TableShardingPlan:
    """Static slot layout: device -> [(level, start, length)] row-ranges.

    ``start``/``length`` are LEVEL-RELATIVE rows; device arrays below are
    padded to ``n_slots`` slots (length 0 = inert slot) and carry GLOBAL row
    starts (level offset + start) so the encode path works off the oracle's
    global corner ids directly.
    """

    ndev: int
    n_slots: int
    local_rows: int
    slots: List[List[Tuple[int, int, int]]]
    slot_level: np.ndarray   # (ndev, S) int32; 0 pad
    slot_lo: np.ndarray     # (ndev, S) int64 global row start; 0 pad
    slot_len: np.ndarray    # (ndev, S) int64; 0 pad
    slot_off: np.ndarray    # (ndev, S) int64 local row offset; 0 pad
    scatter: np.ndarray     # (ndev*S, L) float32 gathered-slot -> level sum
    tv_mask: np.ndarray     # (ndev, local_rows) f32: rows (r, r+1) time-adjacent
    tv_pairs: int           # total time-adjacent row pairs (all devices)
    n_levels: int
    n_features: int
    dim: int


def plan_table_sharding(enc: HashGridEncoding, n_devices: int) -> TableShardingPlan:
    """Partition the fused table: big levels split by contiguous row-range
    across all devices, the rest greedily bin-packed by size."""
    L, F, d = enc.n_levels, enc.n_features_per_level, enc.input_dim
    sizes = enc.level_sizes.astype(np.int64)
    total = int(sizes.sum())
    fair = -(-total // n_devices)

    slots: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_devices)]
    loads = np.zeros(n_devices, dtype=np.int64)
    big = [l for l in range(L) if int(sizes[l]) > fair]
    small = sorted((l for l in range(L) if int(sizes[l]) <= fair), key=lambda l: -int(sizes[l]))

    for l in big:
        size = int(sizes[l])
        # Dense levels: align split boundaries to whole time-lines (the last
        # axis is fastest-varying in the row-major vertex grid) so every
        # temporal-adjacent vertex pair lives on one device.
        align = int(enc.level_resolutions[l][-1]) + 1 if enc.level_dense[l] else 1
        bounds = [0]
        for i in range(1, n_devices):
            b = int(round(i * size / n_devices / align)) * align
            bounds.append(min(max(b, bounds[-1]), size))
        bounds.append(size)
        for dev in range(n_devices):
            length = bounds[dev + 1] - bounds[dev]
            slots[dev].append((l, bounds[dev], length))
            loads[dev] += length
    for l in small:
        dev = int(np.argmin(loads))
        slots[dev].append((l, 0, int(sizes[l])))
        loads[dev] += sizes[l]
    for s in slots:
        s.sort()

    S = max(1, max(len(s) for s in slots))
    local_rows = max(1, int(loads.max()))

    slot_level = np.zeros((n_devices, S), dtype=np.int32)
    slot_lo = np.zeros((n_devices, S), dtype=np.int64)
    slot_len = np.zeros((n_devices, S), dtype=np.int64)
    slot_off = np.zeros((n_devices, S), dtype=np.int64)
    scatter = np.zeros((n_devices * S, L), dtype=np.float32)
    tv_mask = np.zeros((n_devices, local_rows), dtype=np.float32)
    tv_pairs = 0
    for dev, dev_slots in enumerate(slots):
        cursor = 0
        for j, (l, start, length) in enumerate(dev_slots):
            slot_level[dev, j] = l
            slot_lo[dev, j] = int(enc.level_offsets[l]) + start
            slot_len[dev, j] = length
            slot_off[dev, j] = cursor
            if length > 0:
                scatter[dev * S + j, l] = 1.0
            if length > 1 and enc.level_dense[l]:
                # rows (r, r+1) within the slot are time-adjacent unless r is
                # the last vertex of its time-line.
                vt = int(enc.level_resolutions[l][-1]) + 1
                g = start + np.arange(length - 1)
                adj = (g % vt) != (vt - 1)
                tv_mask[dev, cursor : cursor + length - 1] = adj.astype(np.float32)
                tv_pairs += int(adj.sum())
            cursor += length

    # Alignment invariant: the sharded TV decomposition is exact — every
    # within-line adjacent pair is counted exactly once.
    expected = 0
    for l in range(L):
        if enc.level_dense[l]:
            verts = enc.level_resolutions[l].astype(np.int64) + 1
            if verts[-1] >= 2:
                expected += int(np.prod(verts[:-1]) * (verts[-1] - 1))
    assert tv_pairs == expected, (tv_pairs, expected)

    return TableShardingPlan(
        ndev=n_devices, n_slots=S, local_rows=local_rows, slots=slots,
        slot_level=slot_level, slot_lo=slot_lo, slot_len=slot_len,
        slot_off=slot_off, scatter=scatter, tv_mask=tv_mask, tv_pairs=tv_pairs,
        n_levels=L, n_features=F, dim=d,
    )


def _rank_rows(table: torch.Tensor, enc: HashGridEncoding, plan: TableShardingPlan, rank: int) -> torch.Tensor:
    """Rank ``rank``'s (local_rows, F) shard of the fused table, zero-padded."""
    out = table.new_zeros((plan.local_rows, plan.n_features))
    cursor = 0
    for l, start, length in plan.slots[rank]:
        lo = int(enc.level_offsets[l]) + start
        out[cursor:cursor + length] = table[lo:lo + length]
        cursor += length
    return out


def _place_rows(out: torch.Tensor, shard: torch.Tensor, enc: HashGridEncoding, plan: TableShardingPlan,
                rank: int) -> None:
    """Write rank ``rank``'s (local_rows, F) ``shard`` into the fused table ``out``."""
    cursor = 0
    for l, start, length in plan.slots[rank]:
        lo = int(enc.level_offsets[l]) + start
        out[lo:lo + length] = shard[cursor:cursor + length]
        cursor += length


def _table_of(shards: torch.Tensor, enc: HashGridEncoding, plan: TableShardingPlan) -> torch.Tensor:
    """The fused (total, F) table from the ranks' (world, local_rows, F) shards."""
    out = shards.new_zeros((enc.total_size, plan.n_features))
    for rank in range(plan.ndev):
        _place_rows(out, shards[rank], enc, plan, rank)
    return out


def _gather_table_to_host(mesh: RankGroup, shard: torch.Tensor, enc: HashGridEncoding, plan: TableShardingPlan,
                          keep: bool = True) -> Optional[torch.Tensor]:
    """The fused (total, F) table on the host from every rank's ``shard``:
    one ``broadcast`` of each rank's shard in turn, copied to the host, so a
    rank's device holds one more shard at a time and never the table. Every
    rank calls it; with ``keep=False`` a rank takes part and keeps nothing."""
    out = torch.zeros((enc.total_size, plan.n_features), dtype=shard.dtype) if keep else None
    buf = shard.detach().clone()
    for rank in range(plan.ndev):
        if mesh.group is not None:
            if rank == mesh.rank:
                buf.copy_(shard.detach())
            dist.broadcast(buf, src=rank, group=mesh.group)  # the mesh's ranks are the default group's first
        if keep:
            _place_rows(out, buf.cpu(), enc, plan, rank)
    return out


def shard_table(table, enc: HashGridEncoding, plan: TableShardingPlan) -> np.ndarray:
    """Fused (total, F) table (numpy, or a tensor) -> (ndev, local_rows, F)
    padded rank shards, numpy, in the table's dtype."""
    t = torch.as_tensor(np.array(table))  # a copy: a read-only array (a JAX array's) cannot back a tensor
    return torch.stack([_rank_rows(t, enc, plan, r) for r in range(plan.ndev)]).numpy()


def unshard_table(shards, enc: HashGridEncoding, plan: TableShardingPlan) -> np.ndarray:
    """Inverse of :func:`shard_table`."""
    return _table_of(torch.as_tensor(np.array(shards)), enc, plan).numpy()


class _AllGatherOwnSlice(torch.autograd.Function):
    """``all_gather`` (world, ...) whose backward hands each rank its own
    slice of the gathered cotangent: the sharded encode's collective (see
    the module docstring for why not the sum of the slices)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: RankGroup) -> torch.Tensor:
        ctx.rank = mesh.rank
        return all_gather(mesh, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[ctx.rank], None


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward passes the cotangent through:
    every rank's loss holds the same sum, so each rank's own term takes the
    loss's cotangent once (the sharded temporal TV)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: RankGroup) -> torch.Tensor:
        return all_reduce_sum_(mesh, x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def make_sharded_encode(enc: HashGridEncoding, plan: TableShardingPlan,
                        mesh: RankGroup) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``encode(local_table, x) -> (N, L*F)`` on this rank of ``mesh``, with
    ``local_table`` its (local_rows, F) shard: the single-table encode up to
    the order of float sums (``tests/test_torch_sharded_table.py``: 1e-6).
    Every rank of the mesh calls it on the same ``x``."""
    if plan.ndev != mesh.world_size:
        raise ValueError(f"the plan is for {plan.ndev} ranks, the mesh has {mesh.world_size}")
    r, dev = mesh.rank, mesh.device
    levels = [int(l) for l in plan.slot_level[r]]  # the rank's slots' levels (pad slots: level 0, length 0)
    lo, length, off = (torch.as_tensor(a[r], dtype=torch.int64, device=dev)[None, :, None]
                       for a in (plan.slot_lo, plan.slot_len, plan.slot_off))
    scatter = torch.as_tensor(plan.scatter, device=dev)
    S, F, L = plan.n_slots, plan.n_features, plan.n_levels

    def encode(local_table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        ids, w = enc.corner_ids_and_weights(x, levels)  # (n, S, C): global rows
        rel = ids - lo
        inb = (rel >= 0) & (rel < length)
        rows = local_table[(torch.where(inb, rel, 0) + off).reshape(-1)].reshape(n, S, -1, F)
        partial = (rows * (w * inb.to(w.dtype)).unsqueeze(-1)).sum(dim=2)  # (n, S, F), as the plain encode sums
        gathered = _AllGatherOwnSlice.apply(partial.reshape(n, S * F), mesh)  # (world, n, S*F)
        gath = gathered.permute(1, 0, 2).reshape(n, plan.ndev * S, F)
        return torch.einsum("nkf,kl->nlf", gath, scatter).reshape(n, L * F)  # partial sums, in level order

    return encode


def sharded_encode_apply(enc: HashGridEncoding, plan: TableShardingPlan, mesh: RankGroup, shard: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """The sharded encode of ``x`` with this rank's ``shard``: the
    distributed equivalent of ``ops.hash_encode.hash_encode_forward(enc,
    table, x)``, on every rank."""
    return make_sharded_encode(enc, plan, mesh)(shard, x)


_TABLE = "encoder.table"  # the hash table's name among a make_hash_mlp model's parameters


def _hash_mlp_geometry(model: Model) -> HashGridEncoding:
    geometry = getattr(getattr(model, "encoder", None), "geometry", None)
    if not isinstance(geometry, HashGridEncoding) or not callable(getattr(model, "decode", None)):
        raise ValueError("ShardedHashTrainer requires a make_hash_mlp-style model (a hash-grid encoder and a decode)")
    return geometry


def _decoder_on(model: Model, dev: torch.device) -> None:
    """Raise unless every parameter and buffer of ``model`` but its hash
    table is on ``dev`` (the table may be anywhere)."""
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if name != _TABLE and t.device != dev:
            raise ValueError(f"the decoder's {name} is on {t.device}, the evaluation runs on {dev}")


@torch.no_grad()
def evaluate_grid_sharded_table(model: Model, plan: TableShardingPlan, mesh: RankGroup, shard: torch.Tensor,
                                shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                                chunk_size: int = 1 << 16) -> np.ndarray:
    """Dense-grid evaluation with the table still sharded: every rank walks
    every chunk of ``shape`` (coordinates made on its device), encodes it
    with the sharded encode (its own gathers, one ``all_gather``) and
    decodes it with its replica of the decoder (``model.decode`` in eval
    mode: kernel 5 for the ``relu_plain`` decoder on the card). Only the
    decoder must be on the rank's device: the model's own table is not
    read, wherever it lies, and the full table is never on one device.
    ``shard``: this rank's (local_rows, F) rows on its device
    (:func:`shard_table`, or ``ShardedHashTrainer.shard``). Every rank
    returns the volume."""
    enc = _hash_mlp_geometry(model)
    _decoder_on(model, mesh.device)
    encode = make_sharded_encode(enc, plan, mesh)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))

    def write(start: int, stop: int, out: torch.Tensor) -> None:
        x = flat_index_to_coords(chunk_index(start, stop - start, n, mesh.device), shape, lo, hi)
        out[start:stop] = model.decode(encode(shard, x))

    return _volume(_walk(model, n, chunk_size, mesh.device, write).cpu().numpy(), shape)


class ShardedHashTrainer:
    """Fits a ``make_hash_mlp`` model with its hash table sharded over
    ``mesh`` (default: :func:`make_mesh` on ``device``); the decoder is
    replicated. Every rank calls ``fit`` with the same arguments.

    It mirrors ``Trainer.fit``: the same permutations (``shuffle``,
    ``drop_last`` and the wrap pad), the loss registry, the optimizer chain
    (one for the table shard and one for the decoder, the freeze mask split
    between them), ``remat``, the epoch hooks (on rank 0). It refuses
    models that are not hash models and a level anneal (its weighting lives
    in the model's forward, which this trainer replaces by the sharded
    encode and ``model.decode``). The model's ``temporal_tv`` prior is
    decomposed exactly over the ranks (the plan's time-line-aligned row
    pairs) and summed with one ``all_reduce``.

    A rank's device holds its shard, the shard's gradient and Adam state,
    and the decoder; never the full table. ``fit`` moves the model's table
    to the host, leaves an empty placeholder in its place for the fit, and
    at the end writes the unsharded table back into the model on the host,
    on every rank (gathered one shard at a time; the decoder stays on the
    rank's device). ``model.to(device)`` then makes it a whole model for
    ``infer.evaluate_grid`` where the table fits one card; the trainer's
    ``plan`` and ``shard`` (this rank's final rows, on its device) serve
    :func:`evaluate_grid_sharded_table` where it does not. On an epoch
    whose eval or checkpoint fires, rank 0's hooks see the whole model on
    its device for their duration, as the JAX package hands its hooks the
    whole parameters.

    The decoder's gradient is averaged over the ranks with one
    ``all_reduce`` a step. The ranks compute it on the same inputs, but
    float atomics in a backward kernel (kernel 6 sums dW with them) make
    its bits differ from run to run, and unaveraged the decoder replicas
    would drift apart."""

    def __init__(self, config: TrainConfig, mesh: Optional[RankGroup] = None, freeze_mask_fn: Optional[Callable] = None,
                 device=None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.freeze_mask_fn = freeze_mask_fn
        self.plan: Optional[TableShardingPlan] = None
        self.shard: Optional[torch.Tensor] = None

    def fit(self, model: Model, coords: np.ndarray, values: np.ndarray,
            eval_fn: Optional[Callable] = None) -> TrainResult:
        """``eval_fn(model) -> {tag: value}``: as ``Trainer.fit``'s, on rank 0."""
        cfg, mesh = self.config, self.mesh
        dev, rank = mesh.device, mesh.rank
        enc = _hash_mlp_geometry(model)
        if getattr(model, "level_anneal_steps", 0) > 0:
            raise ValueError("level_anneal_steps does not compose with ShardedHashTrainer (the anneal weighting "
                             "lives in the model's forward, which the distributed encode path replaces)")
        temporal_tv = float(getattr(model, "temporal_tv", 0.0))
        plan = plan_table_sharding(enc, mesh.world_size)
        n = len(coords)
        batch = min(cfg.batch_size, n)
        steps_per_epoch = n // batch if cfg.drop_last else -(-n // batch)
        if steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch} exceeds dataset size {n}")

        named = dict(model.named_parameters())
        table = named[_TABLE]
        decoder = {k: p for k, p in named.items() if k != _TABLE}
        host_table = table.detach().cpu()  # the caller's table, off the device for the fit
        table.data = host_table.new_empty((0, plan.n_features))  # the table has nothing for model.to to move
        model.to(dev).train()
        placeholder = table.data
        local = torch.nn.Parameter(_rank_rows(as_f32(host_table), enc, plan, rank).to(dev))
        masks = [None, None]
        if self.freeze_mask_fn is not None:
            mask = self.freeze_mask_fn(named)
            if set(mask) != set(named):
                raise ValueError(f"the freeze mask names {sorted(mask)}, the model's parameters are {sorted(named)}")
            masks = [lambda _: {_TABLE: mask[_TABLE]}, lambda _: {k: mask[k] for k in decoder}]
        tab_updates = _Updates(cfg, {_TABLE: local}, steps_per_epoch, masks[0])
        dec_updates = _Updates(cfg, decoder, steps_per_epoch, masks[1])
        base_loss = get_loss(cfg.loss)
        encode = make_sharded_encode(enc, plan, mesh)
        tv_mask = torch.as_tensor(plan.tv_mask[rank, :-1], device=dev)[:, None]
        tv_count = max(plan.tv_pairs * plan.n_features, 1)

        def loss_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            loss = base_loss(model.decode(encode(local, x)), y)
            if temporal_tv > 0.0:
                tv_local = torch.sum((local[1:] - local[:-1]) ** 2 * tv_mask)
                loss = loss + temporal_tv * _AllReduceSum.apply(tv_local, mesh) / tv_count
            return loss

        def unsharded(keep: bool) -> Optional[torch.Tensor]:
            full = _gather_table_to_host(mesh, local, enc, plan, keep)
            return None if full is None else full.to(host_table.dtype)

        coords_d = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
        values_d = torch.as_tensor(np.asarray(values, dtype=np.float32)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        hooks = EpochHooks(cfg, steps_per_epoch, eval_fn) if rank == 0 else None

        all_losses, epoch_times, hook_s = [], [], 0.0
        t0 = time.perf_counter()
        try:
            for e in range(cfg.epochs):
                te = time.perf_counter()
                perm = torch.randperm(n, generator=gen, device=dev) if cfg.shuffle else torch.arange(n, device=dev)
                pad = steps_per_epoch * batch - n
                if pad > 0:
                    perm = torch.cat([perm, perm[:pad]])
                idx = perm[: steps_per_epoch * batch].view(steps_per_epoch, batch)
                losses = torch.empty(steps_per_epoch, device=dev)
                for s in range(steps_per_epoch):
                    loss = _step_loss(model, loss_fn, coords_d[idx[s]], values_d[idx[s]], cfg.remat)
                    tab_updates.zero_grad()
                    dec_updates.zero_grad()
                    loss.backward()
                    reached = [p for p in decoder.values() if p.grad is not None]
                    for p, g in zip(reached, mean_over_ranks(mesh, [p.grad for p in reached])):
                        p.grad = g
                    tab_updates.step()
                    dec_updates.step()
                    losses[s] = loss.detach()
                epoch_losses = losses.cpu().numpy()
                epoch_times.append(time.perf_counter() - te)
                all_losses.append(epoch_losses)
                th = time.perf_counter()
                if _eval_fires(cfg, eval_fn, e) or _checkpoint_fires(cfg, e):  # the hooks read the whole model
                    full = unsharded(keep=hooks is not None)
                    if hooks is not None:
                        table.data = full.to(dev)
                if hooks is not None:
                    hooks.after_epoch(e, epoch_losses, model)
                    table.data = placeholder
                hook_s += time.perf_counter() - th
            result = _result(all_losses, epoch_times, time.perf_counter() - t0, hook_s)
            host_table = unsharded(keep=True)
        finally:
            if hooks is not None:
                hooks.close()
            table.data = host_table  # the fitted table, or the caller's if the fit failed
        self.plan, self.shard = plan, local.detach()
        return result
