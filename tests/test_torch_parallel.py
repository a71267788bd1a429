"""Port parity: the data-parallel half of the parallel layer
(``parallel/mesh.py``, ``parallel/data_parallel.py``) and the launcher's
parallel branches, on a gloo group of CPU processes against the JAX
package on its 8-device virtual mesh.

One pool of four ranks (``parallel.RankPool``) is started for the module
and runs every case; a case at world size 2 runs on the first two ranks
(``make_mesh(2)``, as the JAX tests take ``make_mesh(2)`` of the eight
devices). The ranks import this module, so it imports the JAX package only
inside the ``jx`` fixture.

Tolerances:

- JAX's ``DataParallelTrainer.fit`` and ``fit_multi_volume`` draw their
  permutations from ``jax.random``, which torch cannot reproduce: those
  cases take one batch an epoch (``batch = n``), where the averaged loss
  and gradient do not depend on the permutation but through the order of
  float sums, on models without BatchNorm; every step's loss within rtol
  1e-4, as ``test_torch_trainer.py`` holds ``Trainer.fit`` (XLA's and
  PyTorch's float32 sums differ and compound over the Adam steps);
- ``fit_streaming`` draws numpy permutations in both packages, so the
  batches are the same: rtol 1e-4 as well;
- BatchNorm's running statistics under DP are held by hand: the mean of
  what each rank's rows would give, within 1e-6;
- ``evaluate_grid_sharded``: within 1e-5 of JAX's (the per-point forward
  in both);
- at world size 1 the DP trainer is ``Trainer.fit`` / ``fit_streaming``,
  exactly.

Hash tables are redrawn U(-0.5, 0.5), as in the other trainer tests.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import dataset_from_array, load_volume, nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
from mri_interpolation_tpu_torch.parallel import (DataParallelTrainer, RankGroup, RankPool, evaluate_grid_sharded,
                                                  fit_multi_volume, make_mesh)
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RTOL = 1e-4
HASH = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=8, base_resolution=(2, 2, 2),
            finest_resolution=(8, 8, 6), dim_hidden=8, n_layers=2)
SIREN = dict(dim_hidden=16, n_layers=3)
MODELS = {"hash_relu_plain": ("hash", dict(HASH, decoder="relu_plain")), "siren": ("siren", SIREN)}


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, threads=1, timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts, imported here and not at the top:
    the ranks import this module and run without JAX."""
    import jax

    from mri_interpolation_tpu import models, parallel, train

    return types.SimpleNamespace(jax=jax, models=models, parallel=parallel, train=train)


@pytest.fixture(scope="module")
def ds():
    return dataset_from_array(synthetic_volume((8, 8, 6), seed=5))


def _jax_model(jx, spec):
    kind, kw = spec
    if kind == "hash":
        return jx.models.make_hash_mlp(dim_in=3, fused="off", **kw)
    return jx.models.make_siren(dim_in=3, fused="off", **kw)


def _port_model(spec):
    kind, kw = spec
    return make_hash_mlp(3, device="cpu", **kw) if kind == "hash" else make_siren(3, device="cpu", **kw)


def _jax_init(jx, spec, seed=0):
    """JAX's initial parameters, the hash table redrawn U(-0.5, 0.5); the
    port's state_dict of them."""
    params, state = jx.jax.device_get(_jax_model(jx, spec).init(jx.jax.random.key(seed)))
    if "encoder" in params:
        shape = params["encoder"]["table"].shape
        params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    return params, state, params_from_jax(params, state)


# ---------------------------------------------------------------------------
# what the ranks run (module level: the pool pickles them by name)


def _mesh_rank(n):
    mesh = make_mesh(n, device="cpu")
    return None if mesh is None else (mesh.world_size, mesh.rank, str(mesh.device), mesh.group is not None)


def _too_many_rank():
    try:
        make_mesh(WORLD + 1, device="cpu")
    except ValueError as err:
        return str(err)
    return None


def _dp_fit_rank(n, spec, state_dict, coords, values, cfg_kw, streaming=None):
    mesh = make_mesh(n, device="cpu")
    if mesh is None:
        return None
    model = _port_model(spec)
    model.load_state_dict(state_dict)
    trainer = DataParallelTrainer(TrainConfig(**cfg_kw), mesh=mesh)
    if streaming is None:
        res = trainer.fit(model, coords, values)
    else:
        res = trainer.fit_streaming(model, streaming["volume"], shard_voxels=streaming["shard_voxels"])
    return res.losses, {k: v.clone() for k, v in model.state_dict().items()}


def _refusal_rank(what):
    mesh = make_mesh(device="cpu")
    model = make_siren(3, device="cpu", dim_hidden=4, n_layers=2)
    coords = np.zeros((16, 3), np.float32)
    try:
        if what == "batch":
            DataParallelTrainer(TrainConfig(batch_size=3), mesh=mesh).fit(model, coords, coords[:, :1])
        else:
            fit_multi_volume([model] * 3, coords, np.zeros((3, 16, 1), np.float32), TrainConfig(), mesh=mesh)
    except ValueError as err:
        return str(err)
    return None


def _multi_volume_rank(n, spec, models, coords, values, cfg_kw):
    mesh = make_mesh(n, device="cpu")
    if mesh is None:
        return None
    if models is None:  # the factory: volume v's model from seed config.seed + v
        models = lambda seed: make_siren(3, device="cpu", **spec[1])  # noqa: E731
        torch.manual_seed(0)
    else:
        loaded = []
        for sd in models:
            m = _port_model(spec)
            m.load_state_dict(sd)
            loaded.append(m)
        models = loaded
    res = fit_multi_volume(models, coords, values, TrainConfig(**cfg_kw), mesh=mesh)
    return res.losses, res.steps, [m.state_dict() for m in res.models]


def _grid_rank(n, spec, state_dict, shape, lo):
    mesh = make_mesh(n, device="cpu")
    if mesh is None:
        return None
    model = _port_model(spec)
    model.load_state_dict(state_dict)
    return evaluate_grid_sharded(model, shape, mesh=mesh, lo=lo, chunk_size=16)


def _launcher_dp_rank(n, path, cfg_kw):
    """What ``launcher.run`` fits at world size n with ``data_parallel``,
    through ``DataParallelTrainer.fit`` called directly."""
    mesh = make_mesh(n, device="cpu")
    if mesh is None:
        return None
    cfg = RunConfig(image_path=path, **cfg_kw)
    ds = load_volume(path)
    cfg.dim_in = ds.dim_in
    model = launcher.build_model(cfg, ds.dim_in, mesh.device)
    tc = TrainConfig(batch_size=cfg.batch_size, epochs=cfg.epochs, lr=cfg.lr, seed=cfg.seed)
    return DataParallelTrainer(tc, mesh=mesh).fit(model, ds.coords, ds.values).losses


def _launcher_rank(cfg_kw):
    """``launcher.run`` on every rank of the pool's group."""
    try:
        return launcher.run(RunConfig(**cfg_kw), device="cpu")
    except ValueError as err:
        return str(err)


# ---------------------------------------------------------------------------
# the mesh


def test_make_mesh_without_a_group():
    assert make_mesh(device="cpu") == RankGroup(None, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("n", [None, 2, WORLD])
def test_make_mesh_in_a_group(pool, jx, n):
    got = pool.run(_mesh_rank, n)
    size = n or WORLD
    assert jx.parallel.make_mesh(size).devices.size == size
    assert got == [(size, r, "cpu", True) for r in range(size)] + [None] * (WORLD - size)


def test_make_mesh_refuses_more_ranks_than_exist(pool, jx):
    assert pool.run(_too_many_rank) == [f"requested {WORLD + 1} devices, have {WORLD}"] * WORLD
    with pytest.raises(ValueError, match="devices"):
        jx.parallel.make_mesh(1000)


# ---------------------------------------------------------------------------
# DataParallelTrainer.fit


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_fit_matches_jax(pool, jx, ds, name):
    spec = MODELS[name]
    params, state, sd = _jax_init(jx, spec)
    cfg = dict(batch_size=len(ds.coords), epochs=5, lr=5e-3, seed=0)
    want = jx.parallel.DataParallelTrainer(jx.train.TrainConfig(**cfg), mesh=jx.parallel.make_mesh(WORLD)).fit(
        _jax_model(jx, spec), ds.coords, ds.values, params=params, state=state)
    results = pool.run(_dp_fit_rank, WORLD, spec, sd, ds.coords, ds.values, cfg)
    losses, final = results[0]
    np.testing.assert_allclose(losses, np.asarray(want.losses), rtol=RTOL)
    for other_losses, other_final in results[1:]:  # every rank holds the same losses and parameters
        np.testing.assert_array_equal(other_losses, losses)
        for k, v in final.items():
            torch.testing.assert_close(other_final[k], v, rtol=0, atol=0)
    want_sd = params_from_jax(jx.jax.device_get(want.params), jx.jax.device_get(want.state))
    for k, v in want_sd.items():
        np.testing.assert_allclose(final[k].numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=k)


def test_dp_batchnorm_statistics_are_the_ranks_mean(pool, ds):
    """One step of the BatchNorm decoder at world 4: every rank's running
    statistics are the mean of the four updates its rows would make alone
    (JAX's ``pmean`` of the new state)."""
    spec = ("hash", dict(HASH, decoder="norm"))
    init = _port_model(spec)
    sd = {k: v.clone() for k, v in init.state_dict().items()}
    n = len(ds.coords)
    cfg = dict(batch_size=n, epochs=1, lr=5e-3, seed=0)
    results = pool.run(_dp_fit_rank, WORLD, spec, sd, ds.coords, ds.values, cfg)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    cols = perm.view(1, WORLD, n // WORLD)[0]
    means, variances = [], []
    with torch.no_grad():
        for r in range(WORLD):
            z = init.layers[0](init.encode(torch.from_numpy(ds.coords)[cols[r]]))
            means.append(0.9 * init.bn[0].mean + 0.1 * z.mean(0))
            variances.append(0.9 * init.bn[0].var + 0.1 * z.var(0, unbiased=True))
    for _, final in results:
        torch.testing.assert_close(final["bn.0.mean"], torch.stack(means).mean(0), rtol=0, atol=1e-6)
        torch.testing.assert_close(final["bn.0.var"], torch.stack(variances).mean(0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", ["flagship", "siren"])
def test_dp_fit_at_world_one_is_trainer_fit(ds, name, remat):
    spec = ("hash", dict(HASH)) if name == "flagship" else MODELS["siren"]
    cfg = TrainConfig(batch_size=64, epochs=2, lr=5e-3, seed=3, remat=remat)
    a, b = _port_model(spec), _port_model(spec)
    b.load_state_dict(a.state_dict())
    got = DataParallelTrainer(cfg, device="cpu").fit(a, ds.coords, ds.values)
    want = Trainer(cfg).fit(b, ds.coords, ds.values, device="cpu")
    np.testing.assert_array_equal(got.losses, want.losses)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("what, match", [("batch", "batch_size 3 < n_devices 4"),
                                         ("volumes", "n_volumes 3 must be divisible by mesh size 4")])
def test_refusals(pool, what, match):
    assert pool.run(_refusal_rank, what) == [match] * WORLD


# ---------------------------------------------------------------------------
# DataParallelTrainer.fit_streaming


@pytest.mark.parametrize("shard_voxels, batch", [(128, 64), (100, 32)], ids=["3_shards", "4_shards_padded"])
def test_dp_fit_streaming_matches_jax(pool, jx, shard_voxels, batch):
    spec = MODELS["hash_relu_plain"]
    params, state, sd = _jax_init(jx, spec, seed=1)
    volume = synthetic_volume((8, 8, 6), seed=2)
    cfg = dict(batch_size=batch, epochs=2, lr=5e-3, seed=4)
    want = jx.parallel.DataParallelTrainer(jx.train.TrainConfig(**cfg), mesh=jx.parallel.make_mesh(WORLD)) \
        .fit_streaming(_jax_model(jx, spec), volume, shard_voxels=shard_voxels, params=params, state=state)
    results = pool.run(_dp_fit_rank, WORLD, spec, sd, None, None, cfg,
                       dict(volume=volume, shard_voxels=shard_voxels))
    losses = results[0][0]
    assert len(losses) == len(np.asarray(want.losses))
    np.testing.assert_allclose(losses, np.asarray(want.losses), rtol=RTOL)
    want_sd = params_from_jax(jx.jax.device_get(want.params), jx.jax.device_get(want.state))
    for k, v in want_sd.items():
        np.testing.assert_allclose(results[0][1][k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_dp_fit_streaming_at_world_one_is_trainer_fit_streaming():
    spec = ("hash", dict(HASH))
    volume = synthetic_volume((8, 8, 6), seed=2)
    cfg = TrainConfig(batch_size=50, epochs=2, lr=5e-3, seed=4)
    a, b = _port_model(spec), _port_model(spec)
    b.load_state_dict(a.state_dict())
    got = DataParallelTrainer(cfg, device="cpu").fit_streaming(a, volume, shard_voxels=120)
    want = Trainer(cfg).fit_streaming(b, volume, shard_voxels=120, device="cpu")
    np.testing.assert_array_equal(got.losses, want.losses)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------------------
# fit_multi_volume


def test_fit_multi_volume_matches_jax(pool, jx):
    """V = 4 volumes at world size 2; JAX's vmapped initial parameters
    carried across (``params_from_jax(..., stacked=True)``)."""
    spec = ("siren", dict(dim_hidden=8, n_layers=2))
    coords = dataset_from_array(synthetic_volume((6, 6, 4), seed=0)).coords
    values = np.stack([dataset_from_array(synthetic_volume((6, 6, 4), seed=s)).values for s in range(4)])
    cfg = dict(batch_size=len(coords), epochs=4, lr=1e-3, seed=0)
    jcfg = jx.train.TrainConfig(**cfg)
    jm = _jax_model(jx, spec)
    want = jx.parallel.fit_multi_volume(jm, coords, values, jcfg, mesh=jx.parallel.make_mesh(2))
    key = jx.jax.random.key(cfg["seed"])  # the JAX function's own initial draw
    _, k_init = jx.jax.random.split(key)
    params, state = jx.jax.device_get(jx.jax.vmap(jm.init)(jx.jax.random.split(k_init, 4)))
    sds = params_from_jax(params, state, stacked=True)
    assert len(sds) == 4
    results = pool.run(_multi_volume_rank, 2, spec, sds, coords, values, cfg)
    losses, steps, finals = results[0]
    assert losses.shape == np.asarray(want.losses).shape == (4, 4) and steps == want.steps
    for v in range(4):
        np.testing.assert_allclose(losses[v], np.asarray(want.losses)[v], rtol=RTOL, err_msg=f"volume {v}")
    assert results[2] is None and results[3] is None
    for k, t in finals[3].items():  # volume 3 was fitted on rank 1; rank 0 holds it after the gather
        torch.testing.assert_close(results[1][2][3][k], t, rtol=0, atol=0)


def test_fit_multi_volume_factory_at_world_two_is_world_one(pool):
    spec = ("siren", dict(dim_hidden=8, n_layers=2))
    coords = dataset_from_array(synthetic_volume((6, 6, 4), seed=0)).coords
    values = np.stack([dataset_from_array(synthetic_volume((6, 6, 4), seed=s)).values for s in range(4)])
    cfg = dict(batch_size=48, epochs=2, lr=1e-3, seed=0)
    got = pool.run(_multi_volume_rank, 2, spec, None, coords, values, cfg)[0]
    want = _multi_volume_rank(1, spec, None, coords, values, cfg)
    assert got[1] == want[1] == 2 * (len(coords) // 48)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[2], want[2]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# evaluate_grid_sharded


@pytest.mark.parametrize("shape, lo", [((6, 5, 4), 0.0), ((7, 5, 3), 0.0), ((5, 3, 7), -1.0)],
                         ids=["even", "odd", "odd_zero_centred"])
@pytest.mark.parametrize("name", list(MODELS))
def test_evaluate_grid_sharded_matches_jax(pool, jx, name, shape, lo):
    spec = MODELS[name]
    params, state, sd = _jax_init(jx, spec, seed=2)
    want = jx.parallel.evaluate_grid_sharded(_jax_model(jx, spec), params, state, shape,
                                             mesh=jx.parallel.make_mesh(WORLD), lo=lo, chunk_size=16)
    results = pool.run(_grid_rank, WORLD, spec, sd, shape, lo)
    for got in results:
        assert got.shape == shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    model = _port_model(spec)
    model.load_state_dict(sd)
    np.testing.assert_allclose(results[0], evaluate_grid(model, shape, lo=lo, device="cpu",
                                                         transform=lambda x: x), rtol=0, atol=1e-6)


def test_evaluate_grid_sharded_at_world_one():
    model = _port_model(("hash", dict(HASH)))
    got = evaluate_grid_sharded(model, (7, 5, 3), mesh=make_mesh(device="cpu"), chunk_size=8)
    np.testing.assert_array_equal(got, evaluate_grid(model, (7, 5, 3), chunk_size=8, device="cpu",
                                                     transform=lambda x: x))


# ---------------------------------------------------------------------------
# the launcher under torchrun


def test_launcher_under_torchrun_fits_data_parallel_and_writes_once(pool, tmp_path):
    """``torchrun --nproc_per_node 2`` of the CLI with ``--device cpu
    --data_parallel true``: one run directory with its files, written by
    rank 0, whose loss is ``DataParallelTrainer.fit``'s at world size 2."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((8, 8, 4), seed=1), path)
    flags = dict(epochs=2, batch_size=64, dim_hidden=8, base_resolution=(2, 2, 2), finest_resolution=(8, 8, 4),
                 lr=5e-3)
    argv = ["--image_path", path, "--device", "cpu", "--data_parallel", "true", "--output_root",
            str(tmp_path / "runs"), "--interp_shapes", "()", "--save_checkpoint", "false"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v).replace(" ", "")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "mri_interpolation_tpu_torch.launcher", *argv], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    runs = os.listdir(tmp_path / "runs")
    assert runs == ["version_0"]
    files = sorted(os.listdir(tmp_path / "runs" / "version_0"))
    assert files == ["config.txt", "metrics.json", "pred.nii.gz", "scalars.jsonl"]
    with open(tmp_path / "runs" / "version_0" / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["world_size"] == 2 and metrics["steps"] == 2 * (256 // 64)
    with open(tmp_path / "runs" / "version_0" / "scalars.jsonl") as f:
        assert sum(1 for _ in f) == metrics["steps"]  # one stream, each step once
    losses = pool.run(_launcher_dp_rank, 2, path, flags)[0]
    assert metrics["final_loss"] == pytest.approx(float(losses[-1]), rel=1e-6)


LAUNCH = dict(epochs=2, batch_size=64, dim_hidden=8, base_resolution=(2, 2, 2), finest_resolution=(8, 8, 4), lr=5e-3,
              interp_shapes=((8, 8, 8),), save_checkpoint=False)


@pytest.mark.parametrize("flags", [dict(shard_tables=True),
                                   dict(data_parallel=True, stream_shard_voxels=100, decoder="relu_plain"),
                                   dict(data_parallel=True, decoder="relu_plain")],
                         ids=["shard_tables", "data_parallel_streaming", "data_parallel"])
def test_launcher_parallel_branches_at_world_four(pool, tmp_path, flags):
    """``launcher.run`` in a group of four takes the JAX launcher's
    parallel branch; rank 0 writes the run directory, the other ranks
    return their fit's summary, and the loss is the single-device run's
    but for the order of float sums (the DP cases on the ``relu_plain``
    decoder: BatchNorm normalises by each rank's own rows)."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((8, 8, 4), seed=1), path)
    cfg = dict(LAUNCH, image_path=path, output_root=str(tmp_path / "runs"), **flags)
    summaries = pool.run(_launcher_rank, cfg)
    first, others = summaries[0], summaries[1:]
    assert first["world_size"] == WORLD and np.isfinite(first["psnr"])
    assert [o["rank"] for o in others] == [1, 2, 3]
    assert all(o["run_dir"] == first["run_dir"] and o["final_loss"] == first["final_loss"] for o in others)
    assert sorted(os.listdir(tmp_path / "runs")) == ["version_0"]
    assert sorted(os.listdir(first["run_dir"])) == ["config.txt", "interpolation(8, 8, 8).nii.gz", "metrics.json",
                                                    "pred.nii.gz", "scalars.jsonl"]
    single = launcher.run(RunConfig(**cfg), device="cpu")  # no group here: the single-device fit
    assert single["world_size"] == 1 and single["steps"] == first["steps"]
    assert first["final_loss"] == pytest.approx(single["final_loss"], rel=1e-5)


@pytest.mark.parametrize("flags, match", [
    (dict(stream_shard_voxels=100), "--stream_shard_voxels does not compose with --shard_tables"),
    (dict(level_anneal_steps=4), "--level_anneal_steps does not compose with --shard_tables")],
    ids=["streaming", "anneal"])
def test_launcher_shard_tables_refusals_at_world_four(pool, tmp_path, flags, match):
    cfg = dict(LAUNCH, image_path=str(tmp_path / "absent.nii.gz"), output_root=str(tmp_path / "runs"),
               shard_tables=True, **flags)
    assert pool.run(_launcher_rank, cfg) == [match] * WORLD
    assert not (tmp_path / "runs").exists()
