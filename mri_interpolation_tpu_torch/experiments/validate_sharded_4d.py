"""Hash-table sharding on the 4-D F = 8 configuration whose fused table
(> 400 MB) exceeds one device's fair share (port of
``scripts/validate_sharded_4d.py``).

The JAX script forces 8 virtual CPU devices and runs one ``shard_map``
program on them. Here 8 ranks of a gloo group (``parallel.RankPool``) each
run :func:`_rank`: on ``cuda`` (rank ``r`` on card ``r`` modulo the cards,
so all 8 share one card on a one-card machine; NCCL refuses two ranks on
one card) unless ``device="cpu"``. Steps, as the JAX script's:

- plan the sharding; the big dense levels must be row-range split and the
  largest rank's load at most 1.25 x the fair share;
- the sharded encode (``parallel.sharded_encode_apply``) against the
  single-table oracle (``ops.hash_encode.hash_encode_forward``: kernel 1 on
  the card) on 2,048 points, max abs error < 1e-5. The table is drawn
  U(-0.5, 0.5), a trained table's scale, from a seeded ``torch.Generator``
  (the JAX script draws the init's U(-1e-4, 1e-4) from ``jax.random``, at
  which scale the bound is a 10 % one);
- ``ShardedHashTrainer`` for 2 epochs of 32,768 synthetic rows at batch
  4,096: losses finite and decreasing.

    python -m mri_interpolation_tpu_torch.experiments.validate_sharded_4d [--out_dir D] [--device cpu]

writes ``<out_dir>/sharded_4d_validation.json`` with the JAX script's keys
(``mesh_devices``: the number of ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..encodings.hashgrid import HashGridEncoding
from ..models import make_hash_mlp
from ..ops import build, fused_mlp
from ..ops import hash_encode as he
from ..parallel import (RankPool, ShardedHashTrainer, TableShardingPlan, make_mesh, plan_table_sharding,
                        sharded_encode_apply)
from ..parallel.sharded_table import _rank_rows
from ..train import TrainConfig
from . import common

__all__ = ["MODEL", "RECORD_KEYS", "geometry", "plan_record", "validate", "main"]

# 4D F8: the finest dense level is the full (352,352,6,15) vertex grid
# (353*353*7*16 = 13.96M rows) at 8 features, the hash grid's motivating case
# for a sharded table
MODEL = dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=24,
             base_resolution=(64, 64, 2, 5), finest_resolution=(352, 352, 6, 15),
             growth="paper", storage="auto", dim_hidden=64, n_layers=2, decoder="relu_plain")
RECORD_KEYS = ("table_rows", "table_mb", "per_device_mb", "split_dense_levels", "encode_parity_max_abs_err",
               "fit_first_loss", "fit_last_loss", "fit_wall_s", "mesh_devices")
ENCODE_POINTS = 2048  # the encode check's points
FIT = dict(epochs=2, lr=5e-3, seed=0)  # the sharded fit's config besides its batch
_ENCODING_KEYS = ("n_levels", "n_features_per_level", "log2_hashmap_size", "base_resolution", "finest_resolution",
                  "per_level_scale", "growth", "storage")


def geometry(model_kwargs: dict = MODEL) -> HashGridEncoding:
    """The 4-D hash grid of ``make_hash_mlp(4, **model_kwargs)``, without a table."""
    return HashGridEncoding(dim=4, **{k: v for k, v in model_kwargs.items() if k in _ENCODING_KEYS})


def plan_record(enc: HashGridEncoding, world: int) -> Tuple[TableShardingPlan, dict]:
    """The sharding plan over ``world`` ranks and its summary (``table_rows``,
    ``table_mb``, ``per_device_mb``, ``split_dense_levels``, ``loads``);
    raises ``AssertionError`` unless a dense level is split and the largest
    load is at most 1.25 x the fair share."""
    plan = plan_table_sharding(enc, world)
    F = enc.n_features_per_level
    loads = [sum(ln for (_, _, ln) in s) for s in plan.slots]
    split_dense = sorted({int(l) for s in plan.slots for (l, start, ln) in s
                          if ln > 0 and start > 0 and enc.level_dense[l]})
    record = {"table_rows": int(enc.total_size), "table_mb": round(enc.total_size * F * 4 / 2**20, 1),
              "per_device_mb": round(max(loads) * F * 4 / 2**20, 1), "split_dense_levels": split_dense,
              "loads": loads}
    if not split_dense:
        raise AssertionError("big dense levels must be row-range split")
    if not max(loads) <= 1.25 * enc.total_size / world:
        raise AssertionError(f"the largest rank load {max(loads)} exceeds 1.25 x the fair share "
                             f"{enc.total_size / world:.0f}")
    return plan, record


def _counts() -> dict:
    return {**he.LAUNCHES, **fused_mlp.LAUNCHES}


def _rank(model_kwargs: dict, coords: np.ndarray, values: np.ndarray, cfg: TrainConfig,
          device: Optional[str]) -> dict:
    """One rank of :func:`validate` (run by ``RankPool``): the model (the
    same seed, so the same table, on every rank), the sharded encode against
    the single-table oracle, and the sharded fit. Returns this rank's
    numbers and the kernel launches it made."""
    before = _counts()
    mesh = make_mesh(device=device)
    dev = mesh.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = make_hash_mlp(4, device=dev, **model_kwargs)
    enc = model.encoder.geometry
    plan = plan_table_sharding(enc, mesh.world_size)

    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.rand((enc.total_size, enc.n_features_per_level), generator=gen, device=dev) - 0.5
    x = torch.rand((ENCODE_POINTS, 4), generator=gen, device=dev)
    shard = _rank_rows(table, enc, plan, mesh.rank)
    sync()
    t0 = time.perf_counter()
    got = sharded_encode_apply(enc, plan, mesh, shard, x)
    sync()
    encode_s = time.perf_counter() - t0
    want = he.hash_encode_forward(enc, table, x)
    out = {"rank": mesh.rank, "device": str(dev), "encode_err": float((got - want).abs().max()),
           "encode_scale": float(want.abs().max()), "encode_s": encode_s}
    del table, x, shard, got, want

    sync()
    t0 = time.perf_counter()
    res = ShardedHashTrainer(cfg, mesh=mesh).fit(model, coords, values)
    sync()
    out.update(fit_s=time.perf_counter() - t0, losses=np.asarray(res.losses, np.float64).reshape(-1).tolist())
    after = _counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


def validate(model_kwargs: dict = MODEL, world: int = 8, device: DeviceLike = None, n_rows: int = 32768,
             batch_size: int = 4096, threads: Optional[int] = None) -> dict:
    """The validation over ``world`` gloo ranks on ``device`` (``cuda``
    unless "cpu"; raises without a card). Raises ``AssertionError`` where a
    check fails. Returns the JAX script's record (:data:`RECORD_KEYS`) and
    ``loads``, ``losses`` (rank 0's, a step each), ``encode_scale``,
    ``launches_by_rank``, ``rank_devices`` and ``wall_s`` (the pool's start
    included). ``n_rows`` and ``batch_size`` size the fit (2 epochs);
    ``threads`` sets each rank's ``torch.set_num_threads``."""
    dev = resolve_device(device)
    if dev.type == "cuda":  # build the kernels once here, not in every rank
        build.load("hash_encode")
    _, record = plan_record(geometry(model_kwargs), world)
    rng = np.random.default_rng(0)
    coords = rng.random((n_rows, 4), dtype=np.float32)
    values = (np.sin(6 * coords[:, :1]) * np.cos(4 * coords[:, 1:2])).astype(np.float32)
    cfg = TrainConfig(batch_size=batch_size, **FIT)
    rank_device = None if device is None else str(device)
    t0 = time.perf_counter()
    with RankPool(world, backend="gloo", threads=threads, timeout=1200.0) as pool:
        ranks = pool.run(_rank, model_kwargs, coords, values, cfg, rank_device)
    wall = time.perf_counter() - t0

    err = max(r["encode_err"] for r in ranks)
    print(f"encode parity: max abs err {err:.2e} (largest value {ranks[0]['encode_scale']:.3f}; "
          f"{ranks[0]['encode_s']:.1f}s)", flush=True)
    if not err < 1e-5:
        raise AssertionError(f"sharded encode against the single table: max abs err {err}")
    losses = np.asarray(ranks[0]["losses"])
    fit_s = ranks[0]["fit_s"]
    print(f"fit: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {fit_s:.1f}s", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the sharded fit's losses are not finite and decreasing: {losses.tolist()}")
    record.update(encode_parity_max_abs_err=err, fit_first_loss=float(losses[0]), fit_last_loss=float(losses[-1]),
                  fit_wall_s=round(fit_s, 1), mesh_devices=world, losses=losses.tolist(),
                  encode_scale=ranks[0]["encode_scale"], launches_by_rank=[r["launches"] for r in ranks],
                  rank_devices=[r["device"] for r in ranks], wall_s=wall)
    return record


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments.validate_sharded_4d")
    ap.add_argument("--out_dir", default=common.OUT_DIR)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    enc = geometry(MODEL)
    table_mb = enc.total_size * enc.n_features_per_level * 4 / 2**20
    print(f"fused table: {enc.total_size:,} rows x F{enc.n_features_per_level} = {table_mb:.0f} MB", flush=True)
    if not table_mb > 400:
        raise AssertionError("config must exceed 400 MB to motivate sharding")
    rec = validate(MODEL, world=8, device=args.device)
    print(f"per-device shard: {max(rec['loads']):,} rows = {rec['per_device_mb']:.0f} MB; "
          f"split dense levels: {rec['split_dense_levels']}")
    out = {k: rec[k] for k in RECORD_KEYS}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "sharded_4d_validation.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return rec


if __name__ == "__main__":
    main()
