"""Port parity: the table-sharded half of the parallel layer
(``parallel/sharded_table.py``) on a gloo group of four CPU processes
against the JAX package on its 8-device virtual mesh (``make_mesh(4)``).

One pool of four ranks (``parallel.RankPool``) runs every case of the
module; the ranks import this module, so it imports the JAX package only
inside the ``jx`` fixture. The geometries are ``tests/test_sharded_table.py``'s:
hashed, mixed dense/hashed, and a dense level larger than a rank's share
(split by row range).

Tolerances:

- ``shard_table`` / ``unshard_table``: exact, and equal to JAX's;
- the sharded encode against JAX's ``sharded_encode_apply`` and against the
  single-table encode: 1e-6 (float sums in another order);
- the sharded table gradient, unsharded, against the single-table
  gradient: 1e-6 of its largest entry. JAX's is 4 times it at world size 4
  (ROADMAP.md, "Not queued"): pinned here;
- ``ShardedHashTrainer`` against JAX's with ``shuffle=False``, every
  step's loss: JAX's own 2e-3 (5e-3 with the BatchNorm decoder) against
  the single-device trainer, which its tests hold; remat against no remat
  1e-6; against the port's ``Trainer.fit``, 1e-5. With weight decay (added
  to the gradient before Adam) JAX's world-times gradient shows, and only
  the port tracks its single-device fit.
"""

import types

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
from mri_interpolation_tpu_torch.ops.hash_encode import hash_encode_reference, hash_encode_table_grad_reference
from mri_interpolation_tpu_torch.parallel import (RankPool, ShardedHashTrainer, evaluate_grid_sharded_table,
                                                  make_mesh, plan_table_sharding, shard_table, sharded_encode_apply,
                                                  unshard_table)
from mri_interpolation_tpu_torch.parallel.mesh import all_gather
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, read_scalars

WORLD = 4
GEOMETRIES = {
    "hashed": dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=8, base_resolution=(4, 4, 2),
                   finest_resolution=(24, 24, 12), storage="hashed"),
    "mixed": dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=9, base_resolution=(4, 4, 2),
                  finest_resolution=(40, 40, 12), storage="auto"),
    "big_dense": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=16, base_resolution=(4, 4, 2),
                      finest_resolution=(32, 32, 12), storage="auto"),
}
MODEL = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=16, base_resolution=(4, 4, 2),
             finest_resolution=(32, 32, 12), storage="auto", dim_hidden=16, n_layers=2, decoder="relu_plain")


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, threads=1, timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts, imported here and not at the top:
    the ranks import this module and run without JAX."""
    import jax
    import jax.numpy as jnp

    from mri_interpolation_tpu import encodings, models, parallel, train
    from mri_interpolation_tpu.parallel import sharded_table

    return types.SimpleNamespace(jax=jax, jnp=jnp, encodings=encodings, models=models, parallel=parallel,
                                 sharded_table=sharded_table, train=train, mesh=parallel.make_mesh(WORLD))


def _jax_table(jx, name, seed=2):
    enc = jx.encodings.HashGridEncoding(dim=3, **GEOMETRIES[name])
    return enc, np.array(enc.init(jx.jax.random.key(seed))["table"])  # writable: torch.from_numpy takes it


# ---------------------------------------------------------------------------
# what the ranks run (module level: the pool pickles them by name)


def _encode_rank(name, table, x, g):
    """The sharded encode of x and, for upstream g, the unsharded gradient
    of sum(features * g) with respect to the table."""
    mesh = make_mesh(device="cpu")
    enc = HashGridEncoding(dim=3, **GEOMETRIES[name])
    plan = plan_table_sharding(enc, mesh.world_size)
    shard = torch.from_numpy(shard_table(table, enc, plan)[mesh.rank]).requires_grad_(True)
    feats = sharded_encode_apply(enc, plan, mesh, shard, torch.from_numpy(x))
    torch.sum(feats * torch.from_numpy(g)).backward()
    grad = unshard_table(all_gather(mesh, shard.grad).numpy(), enc, plan)
    return feats.detach().numpy(), grad


def _freeze_decoder(named):
    return {k: k == "encoder.table" for k in named}


def _eval_mean(model):
    x = torch.linspace(0, 1, 48).reshape(16, 3)
    return {"mean": float(model(x).mean())}


def _sharded_fit_rank(model_kw, state_dict, coords, values, cfg_kw, options):
    mesh = make_mesh(options.get("world"), device="cpu")
    model = make_hash_mlp(3, device="cpu", **model_kw)
    model.load_state_dict(state_dict)
    trainer = ShardedHashTrainer(TrainConfig(**cfg_kw), mesh=mesh,
                                 freeze_mask_fn=_freeze_decoder if options.get("freeze") else None)
    res = trainer.fit(model, coords, values, eval_fn=_eval_mean if options.get("eval") else None)
    return res.losses, {k: v.clone() for k, v in model.state_dict().items()}


def _sharded_grid_rank(model_kw, state_dict, shape):
    mesh = make_mesh(device="cpu")
    model = make_hash_mlp(3, device="cpu", **model_kw)
    model.load_state_dict(state_dict)
    enc = model.encoder.geometry
    plan = plan_table_sharding(enc, mesh.world_size)
    shard = torch.from_numpy(shard_table(model.encoder.table.detach().numpy(), enc, plan)[mesh.rank])
    return evaluate_grid_sharded_table(model, plan, mesh, shard, shape, chunk_size=40)


def _table_off_the_rank(coords, values, shape):
    """The sizes of the model's own table that the decoder saw during a
    sharded fit, whether the trainer's shard is this rank's rows of the
    fitted table, and the sharded grid of the fitted model with no table
    rows of its own against ``evaluate_grid`` of the whole model."""
    mesh = make_mesh(device="cpu")
    model = make_hash_mlp(3, device="cpu", **MODEL)
    seen, decode = [], model.decode

    def spy(z):
        seen.append(model.encoder.table.numel())
        return decode(z)

    model.decode = spy
    trainer = ShardedHashTrainer(TrainConfig(batch_size=300, epochs=2, lr=2e-3, seed=0), mesh=mesh)
    trainer.fit(model, coords, values)
    del model.decode
    table = model.encoder.table.detach().clone()
    mine = torch.equal(trainer.shard, torch.from_numpy(shard_table(table, model.encoder.geometry,
                                                                   trainer.plan)[mesh.rank]))
    whole = evaluate_grid(model, shape, device="cpu")
    model.encoder.table.data = table[:0]  # the grid reads the shards and the decoder alone
    grid = evaluate_grid_sharded_table(model, trainer.plan, mesh, trainer.shard, shape, chunk_size=40)
    return seen, mine, float(np.abs(grid - whole).max())


def _refusal_rank(what):
    mesh = make_mesh(device="cpu")
    coords = np.zeros((16, 3), np.float32)
    model = make_siren(3, device="cpu", dim_hidden=4, n_layers=2) if what == "not_hash" else make_hash_mlp(
        3, device="cpu", **dict(MODEL, level_anneal_steps=4))
    try:
        ShardedHashTrainer(TrainConfig(batch_size=8), mesh=mesh).fit(model, coords, coords[:, :1])
    except ValueError as err:
        return str(err)
    return None


# ---------------------------------------------------------------------------
# shard_table / unshard_table


@pytest.mark.parametrize("ndev", [2, WORLD, 8])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_shard_round_trip_equals_jax(jx, name, ndev):
    jenc, table = _jax_table(jx, name)
    enc = HashGridEncoding(dim=3, **GEOMETRIES[name])
    plan = plan_table_sharding(enc, ndev)
    shards = shard_table(table, enc, plan)
    want = jx.sharded_table.shard_table(table, jenc, jx.sharded_table.plan_table_sharding(jenc, ndev))
    assert shards.dtype == table.dtype
    np.testing.assert_array_equal(shards, want)
    np.testing.assert_array_equal(unshard_table(shards, enc, plan), table)
    np.testing.assert_array_equal(shard_table(torch.from_numpy(table.copy()), enc, plan), shards)


# ---------------------------------------------------------------------------
# the sharded encode and its gradient


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sharded_encode_and_gradient(pool, jx, name):
    jenc, table = _jax_table(jx, name)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    enc = HashGridEncoding(dim=3, **GEOMETRIES[name])
    g = rng.standard_normal((257, enc.output_dim)).astype(np.float32)
    results = pool.run(_encode_rank, name, table, x, g)
    plan = jx.sharded_table.plan_table_sharding(jenc, WORLD)
    jshards = jx.sharded_table.shard_table(table, jenc, plan)
    want_sharded = np.asarray(jx.sharded_table.sharded_encode_apply(jenc, plan, jx.mesh, jshards, x))
    want = np.asarray(jenc.apply({"table": table}, x))
    single = hash_encode_reference(enc, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    single_grad = hash_encode_table_grad_reference(enc, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    for feats, grad in results:
        np.testing.assert_allclose(feats, want_sharded, rtol=0, atol=1e-6)
        np.testing.assert_allclose(feats, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(feats, single, rtol=0, atol=1e-6)
        # the port's table gradient is the single table's
        np.testing.assert_allclose(grad, single_grad, rtol=0, atol=1e-6 * np.abs(single_grad).max())


def test_sharded_encode_at_the_domain_edges(pool, jx):
    jenc, table = _jax_table(jx, "mixed", seed=4)
    x = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0]], np.float32)
    g = np.ones((3, jenc.output_dim), np.float32)
    want = np.asarray(jenc.apply({"table": table}, x))
    for feats, _ in pool.run(_encode_rank, "mixed", table, x, g):
        np.testing.assert_allclose(feats, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["mixed", "big_dense"])
def test_jax_sharded_table_gradient_is_world_times_the_single_one(jx, name):
    """The JAX package's fault that the port does not copy: inside
    ``shard_map``, the transpose of ``all_gather`` sums every device's
    (identical) feature cotangent, so the table gradient that
    ``ShardedHashTrainer`` applies is ``world`` times the single table's."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jax, jnp, st = jx.jax, jx.jnp, jx.sharded_table
    jenc, table = _jax_table(jx, name)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (129, 3)).astype(np.float32)
    g = rng.standard_normal((129, jenc.output_dim)).astype(np.float32)
    plan = st.plan_table_sharding(jenc, WORLD)
    encode = st.make_sharded_encode(jenc, plan)

    def per_device(shards3, x, g):  # as ShardedHashTrainer's epoch_shard takes its table gradient
        return jax.grad(lambda local: jnp.sum(encode(local, x) * g))(shards3[0])[None]

    fn = shard_map(per_device, mesh=jx.mesh, in_specs=(P("data"), P(), P()), out_specs=P("data"), check_vma=False)
    got = st.unshard_table(np.asarray(jax.jit(fn)(st.shard_table(table, jenc, plan), x, g)), jenc, plan)
    single = np.asarray(jax.grad(lambda t: jnp.sum(jenc.apply({"table": t}, x) * g))(table))
    np.testing.assert_allclose(got, WORLD * single, rtol=0, atol=1e-6 * WORLD * np.abs(single).max())


# ---------------------------------------------------------------------------
# ShardedHashTrainer


@pytest.fixture(scope="module")
def fit_data():
    ds = dataset_from_array(synthetic_volume((10, 10, 6), seed=1))
    return ds.coords, ds.values


def _shared_init(jx, seed=0, **kw):
    """JAX's initial parameters, the table redrawn U(-0.5, 0.5), and the
    port's state_dict of them."""
    from mri_interpolation_tpu_torch.convert import params_from_jax

    jm = jx.models.make_hash_mlp(dim_in=3, fused="off", **{**MODEL, **kw})
    params, state = jx.jax.device_get(jm.init(jx.jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    return jm, params, state, params_from_jax(params, state)


CASES = {
    "plain": (dict(), dict(batch_size=300, epochs=2, lr=2e-3, seed=0), {}, 2e-3),
    "temporal_tv": (dict(temporal_tv=0.05), dict(batch_size=200, epochs=2, lr=2e-3, seed=3), {}, 2e-3),
    "norm_decoder": (dict(decoder="norm"), dict(batch_size=300, epochs=2, lr=2e-3, seed=0), {}, 5e-3),
    "freeze_decoder": (dict(), dict(batch_size=300, epochs=1, lr=5e-3, seed=0), {"freeze": True}, 2e-3),
    "drop_last_false": (dict(), dict(batch_size=280, epochs=2, lr=2e-3, seed=0, drop_last=False), {}, 2e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_fit_matches_jax(pool, jx, fit_data, case, tmp_path):
    model_kw, cfg_kw, options, rtol = CASES[case]
    coords, values = fit_data
    jm, params, state, sd = _shared_init(jx, **model_kw)
    cfg_kw = dict(cfg_kw, shuffle=False)
    freeze = None
    if options.get("freeze"):
        def freeze(p):
            return {k: jx.jax.tree.map(lambda _: k == "encoder", v) for k, v in p.items()}
    want = jx.parallel.ShardedHashTrainer(jx.train.TrainConfig(**cfg_kw), mesh=jx.mesh, freeze_mask_fn=freeze).fit(
        jm, coords, values, params=params, state=state)
    results = pool.run(_sharded_fit_rank, {**MODEL, **model_kw}, sd, coords, values, cfg_kw, options)
    losses, final = results[0]
    assert losses.shape == np.asarray(want.losses).shape
    np.testing.assert_allclose(losses, np.asarray(want.losses), rtol=rtol, atol=1e-6)
    for other_losses, other_final in results[1:]:  # every rank: the same losses and the whole model
        np.testing.assert_array_equal(other_losses, losses)
        for k, v in final.items():
            torch.testing.assert_close(other_final[k], v, rtol=0, atol=0, msg=k)
    # against the port's single-device fit from the same start
    model = make_hash_mlp(3, device="cpu", **{**MODEL, **model_kw})
    model.load_state_dict(sd)
    mask = _freeze_decoder if options.get("freeze") else None
    ref = Trainer(TrainConfig(**cfg_kw), freeze_mask_fn=mask).fit(model, coords, values, device="cpu")
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-5)
    if case == "freeze_decoder":
        for k, v in sd.items():
            if k != "encoder.table":
                torch.testing.assert_close(final[k], v, rtol=0, atol=0, msg=k)
        assert not torch.equal(final["encoder.table"], sd["encoder.table"])
    if case == "norm_decoder":  # the state threads through (the running mean tracks a bias that float noise
        # moves, test_torch_trainer.py: the variance is the comparison)
        assert not torch.equal(final["bn.0.var"], sd["bn.0.var"])
        np.testing.assert_allclose(final["bn.0.var"].numpy(), np.asarray(want.state["bn"][0]["var"]), rtol=1e-3)


def test_sharded_fit_remat_and_world_one(pool, fit_data):
    coords, values = fit_data
    sd = make_hash_mlp(3, device="cpu", **dict(MODEL, temporal_tv=0.05)).state_dict()
    cfg = dict(batch_size=200, epochs=1, lr=2e-3, seed=0)
    plain = pool.run(_sharded_fit_rank, dict(MODEL, temporal_tv=0.05), sd, coords, values, cfg, {})[0][0]
    remat = pool.run(_sharded_fit_rank, dict(MODEL, temporal_tv=0.05), sd, coords, values, dict(cfg, remat=True),
                     {})[0][0]
    np.testing.assert_allclose(remat, plain, rtol=1e-6, atol=0)
    one = _sharded_fit_rank(dict(MODEL, temporal_tv=0.05), sd, coords, values, cfg, {})[0]  # no group
    np.testing.assert_allclose(one, plain, rtol=1e-5)


def test_sharded_fit_eval_and_checkpoint_hooks(pool, jx, fit_data, tmp_path):
    coords, values = fit_data
    jm, params, state, sd = _shared_init(jx)
    cfg = dict(batch_size=300, epochs=2, lr=2e-3, seed=0, shuffle=False, eval_every_epochs=1,
               log_jsonl=str(tmp_path / "port.jsonl"), checkpoint_dir=str(tmp_path / "ckpt"),
               checkpoint_every_epochs=2)
    x = np.linspace(0, 1, 48, dtype=np.float32).reshape(16, 3)

    def jax_eval(p, s):
        y, _ = jm.apply(p, s, x, train=False, rng=None)
        return {"mean": float(y.mean())}

    jax_cfg = dict(cfg, log_jsonl=str(tmp_path / "jax.jsonl"), checkpoint_dir=None)
    jx.parallel.ShardedHashTrainer(jx.train.TrainConfig(**jax_cfg), mesh=jx.mesh).fit(
        jm, coords, values, params=params, state=state, eval_fn=jax_eval)
    pool.run(_sharded_fit_rank, MODEL, sd, coords, values, cfg, {"eval": True})
    port, want = read_scalars(str(tmp_path / "port.jsonl")), read_scalars(str(tmp_path / "jax.jsonl"))
    got_eval = [r for r in port if r["tag"] == "mean"]
    want_eval = [r for r in want if r["tag"] == "mean"]
    assert [r["step"] for r in got_eval] == [r["step"] for r in want_eval] == [2, 4]
    np.testing.assert_allclose([r["value"] for r in got_eval], [r["value"] for r in want_eval], rtol=2e-3)
    assert len([r for r in port if r["tag"] == "train_loss"]) == 4  # rank 0 alone writes the stream
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_4.pt"]


def test_weight_decay_shows_the_jax_world_times_gradient(pool, jx, fit_data):
    """With L2 weight decay added before Adam, the scale of the gradient
    matters: the port's sharded fit tracks its single-device fit, JAX's
    sharded fit (a table gradient 4 times too large) leaves JAX's."""
    coords, values = fit_data
    jm, params, state, sd = _shared_init(jx)
    cfg = dict(batch_size=300, epochs=3, lr=5e-3, seed=0, shuffle=False, weight_decay=1e-2)
    jsh = np.asarray(jx.parallel.ShardedHashTrainer(jx.train.TrainConfig(**cfg), mesh=jx.mesh).fit(
        jm, coords, values, params=params, state=state).losses)
    jref = np.asarray(jx.train.Trainer(jx.train.TrainConfig(**cfg)).fit(
        jm, coords, values, params=params, state=state).losses)
    port = pool.run(_sharded_fit_rank, MODEL, sd, coords, values, cfg, {})[0][0]
    model = make_hash_mlp(3, device="cpu", **MODEL)
    model.load_state_dict(sd)
    ref = Trainer(TrainConfig(**cfg)).fit(model, coords, values, device="cpu").losses
    port_gap = np.max(np.abs(port - ref) / np.abs(ref))
    jax_gap = np.max(np.abs(jsh - jref) / np.abs(jref))
    assert port_gap < 1e-5 < 1e-3 < jax_gap, (port_gap, jax_gap)
    np.testing.assert_allclose(ref, jref, rtol=1e-4)  # the two single-device fits agree


def test_sharded_fit_keeps_the_table_off_the_ranks(pool, fit_data):
    """During the fit the model's own table holds no rows: a rank keeps its
    shard, never the whole table. After it, the model holds the fitted
    table (here on the host, as on the card) and the trainer this rank's
    shard of it, which ``evaluate_grid_sharded_table`` reads without the
    model's table."""
    coords, values = fit_data
    for seen, mine, err in pool.run(_table_off_the_rank, coords, values, (9, 7, 5)):
        assert len(seen) == 2 * (len(coords) // 300) and set(seen) == {0}
        assert mine
        assert err <= 1e-5


@pytest.mark.parametrize("shape", [(9, 7, 5), (32, 32, 12)], ids=["odd", "finest"])
def test_evaluate_grid_sharded_table(pool, jx, shape):
    jm, params, state, sd = _shared_init(jx, seed=6)
    plan = jx.sharded_table.plan_table_sharding(jm.hparams["encoder"], WORLD)
    shards = jx.sharded_table.shard_table(params["encoder"]["table"], jm.hparams["encoder"], plan)
    dec = {k: v for k, v in params.items() if k != "encoder"}
    want = np.asarray(jx.sharded_table.evaluate_grid_sharded_table(jm, plan, jx.mesh, shards, dec, state, shape,
                                                                   chunk_size=40))
    model = make_hash_mlp(3, device="cpu", **MODEL)
    model.load_state_dict(sd)
    single = evaluate_grid(model, shape, device="cpu")
    for got in pool.run(_sharded_grid_rank, MODEL, sd, shape):
        assert got.shape == shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, single, rtol=0, atol=1e-5)


@pytest.mark.parametrize("what, match", [("not_hash", "make_hash_mlp-style model"),
                                         ("anneal", "level_anneal_steps does not compose")])
def test_refusals(pool, what, match):
    for err in pool.run(_refusal_rank, what):
        assert match in err
