"""Port parity: the sharded-table validation (``mri_interpolation_tpu_torch.
experiments.validate_sharded_4d``) against ``scripts/validate_sharded_4d.py``
and its committed record ``runs/sharded_4d_validation.json``, neither edited.

- At the full 4-D F = 8 geometry, with no table allocated: the port's plan
  over 8 ranks equals JAX's ``plan_table_sharding(enc, 8)`` field by field,
  and the record's ``table_rows``, ``table_mb``, ``per_device_mb`` and
  ``split_dense_levels`` equal the committed JSON's.
- ``validate()`` at a small 4-D geometry (two dense levels split, as at full
  size) over 8 gloo ranks on the CPU (``threads=1``): the sharded encode
  within 1e-5 of the single table, the loss finite and falling, every rank on
  the CPU and no kernel launched. The JAX script draws its table and points
  from ``jax.random``, the port from a seeded ``torch.Generator``, so the
  parity is of geometry, plan and encode equality, not of loss values.
- ``main`` writes the JAX script's keys under ``--out_dir`` and nowhere else.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from mri_interpolation_tpu_torch.experiments import validate_sharded_4d as v

REPO = Path(__file__).resolve().parents[1]
RECORD = json.loads((REPO / "runs" / "sharded_4d_validation.json").read_text())
SMALL = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=16, base_resolution=(8, 8, 2, 2),
             finest_resolution=(32, 32, 4, 8), growth="paper", storage="auto", dim_hidden=16, n_layers=2,
             decoder="relu_plain")


def test_full_geometry_plan_matches_jax_and_the_committed_record():
    from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
    from mri_interpolation_tpu.parallel.sharded_table import plan_table_sharding as jax_plan

    jenc = jax_make_hash_mlp(dim_in=4, fused="off", **v.MODEL).hparams["encoder"]  # no table until init
    enc = v.geometry()
    assert enc.total_size == jenc.total_size == RECORD["table_rows"]
    np.testing.assert_array_equal(enc.level_sizes, jenc.level_sizes)
    np.testing.assert_array_equal(enc.level_dense, jenc.level_dense)
    plan, record = v.plan_record(enc, 8)
    want = jax_plan(jenc, 8)
    slots = lambda p: [[tuple(int(x) for x in slot) for slot in rank] for rank in p.slots]  # noqa: E731
    assert slots(plan) == slots(want)
    for field in dataclasses.fields(want):
        if field.name != "slots":
            np.testing.assert_array_equal(np.asarray(getattr(plan, field.name)),
                                          np.asarray(getattr(want, field.name)), err_msg=field.name)
    for key in ("table_rows", "table_mb", "per_device_mb", "split_dense_levels"):
        assert record[key] == RECORD[key], key
    assert max(record["loads"]) <= 1.25 * enc.total_size / 8


def test_small_geometry_plans_like_the_full_one():
    _, record = v.plan_record(v.geometry(SMALL), 8)
    assert record["split_dense_levels"] == RECORD["split_dense_levels"] == [2, 3]
    with pytest.raises(AssertionError, match="fair share"):
        v.plan_record(v.geometry(dict(SMALL, base_resolution=(16, 16, 2, 2))), 8)


def test_validate_over_8_cpu_ranks():
    rec = v.validate(SMALL, world=8, device="cpu", threads=1, n_rows=4096, batch_size=512)
    assert set(v.RECORD_KEYS) <= set(rec) and rec["mesh_devices"] == 8
    assert rec["encode_parity_max_abs_err"] < 1e-5 and rec["encode_scale"] > 0.1
    assert rec["split_dense_levels"] == [2, 3] and rec["table_rows"] == v.geometry(SMALL).total_size
    losses = np.asarray(rec["losses"])
    assert len(losses) == 2 * 4096 // 512 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert (rec["fit_first_loss"], rec["fit_last_loss"]) == (losses[0], losses[-1])
    assert rec["rank_devices"] == ["cpu"] * 8
    assert all(set(launches.values()) == {0} for launches in rec["launches_by_rank"])


def test_main_writes_the_record_under_out_dir(monkeypatch, tmp_path):
    seen = {}

    def fake_validate(model_kwargs, world, device):
        seen.update(model_kwargs=model_kwargs, world=world, device=device)
        return {**RECORD, "loads": [1] * world, "losses": [1.0, 0.5]}

    monkeypatch.setattr(v, "validate", fake_validate)
    monkeypatch.chdir(tmp_path)
    v.main(["--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert seen == {"model_kwargs": v.MODEL, "world": 8, "device": "cpu"}
    assert json.loads((tmp_path / "out" / "sharded_4d_validation.json").read_text()) == RECORD
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["out", "sharded_4d_validation.json"]
