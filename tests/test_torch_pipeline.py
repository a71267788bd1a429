"""Port parity for the whole slice: fit -> reconstruct -> interpolate ->
score, against the JAX pipeline, plus the port's launcher, IO and metrics.

Tolerances and their reasons:

- same parameters through ``evaluate_grid``: atol 1e-4. Both packages
  encode an all-dense grid with the separable ``apply_grid``; the features
  agree to 1e-6 (the JAX tests' own bound), and the eval-mode BatchNorm
  divides them by running deviations down to ~1e-2.
- two fits from one init (``shuffle=False``): reconstruction PSNR within
  0.05 dB, SSIM within 5e-3, and the interpolated volumes within 40 dB PSNR
  of each other. A bias that feeds a BatchNorm has a true gradient of zero,
  so Adam moves it by float noise, differently in each framework; the
  running means track those biases, so eval-mode outputs of two fits differ
  by up to ~1e-2 while their training losses agree to 1e-3.
- metrics on the same arrays: atol 1e-4 (float32 window sums in another
  order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu import io as jio
from mri_interpolation_tpu import metrics as jmetrics
from mri_interpolation_tpu.infer import evaluate_grid as jax_evaluate_grid
from mri_interpolation_tpu.infer import flat_index_to_coords as jax_flat_index_to_coords
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch import io, launcher, metrics
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import evaluate_grid, flat_index_to_coords
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

SMALL = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
             base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, n_layers=2)
DENSER = (24, 24, 16)


@pytest.fixture(scope="module")
def fitted():
    """The JAX pipeline and the port's, fitted from one init on (16, 16, 8)."""
    ds = io.dataset_from_array(io.synthetic_volume((16, 16, 8), seed=7))
    jm = jax_make_hash_mlp(dim_in=3, **SMALL)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    tm = make_hash_mlp(3, device="cpu", **SMALL)
    tm.load_state_dict(params_from_jax(params, state))
    cfg = dict(batch_size=256, epochs=10, lr=5e-3, seed=0, shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords, ds.values, params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords, ds.values, device="cpu")
    return ds, jm, jres, tm, tres


def test_fit_reconstruction_and_quality_match_jax(fitted):
    ds, jm, jres, tm, tres = fitted
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-3)
    j_recon = np.asarray(jax_evaluate_grid(jm, jres.params, jres.state, ds.shape))
    t_recon = evaluate_grid(tm, ds.shape, device="cpu")
    jq = jmetrics.evaluate_reconstruction(jnp.asarray(j_recon), jnp.asarray(ds.image()))
    tq = metrics.evaluate_reconstruction(t_recon, ds.image(), device="cpu")
    assert t_recon.shape == ds.shape
    assert abs(tq["psnr"] - jq["psnr"]) < 0.05
    assert abs(tq["ssim"] - jq["ssim"]) < 5e-3
    j_dense = np.array(jax_evaluate_grid(jm, jres.params, jres.state, DENSER))
    t_dense = evaluate_grid(tm, DENSER, device="cpu")
    assert t_dense.shape == DENSER and np.isfinite(t_dense).all()
    assert float(metrics.psnr(torch.from_numpy(t_dense), torch.from_numpy(j_dense))) > 40.0


@pytest.mark.parametrize("shape", [(16, 16, 8), DENSER, (7, 5, 3)])
def test_evaluate_grid_matches_jax_on_same_params(fitted, shape):
    _, jm, jres, _, _ = fitted
    tm = make_hash_mlp(3, device="cpu", **SMALL)
    tm.load_state_dict(params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state)))
    want = np.asarray(jax_evaluate_grid(jm, jres.params, jres.state, shape))
    got = evaluate_grid(tm, shape, device="cpu", chunk_size=1000)  # several chunks and a padded tail
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_evaluate_grid_leaves_model_mode(fitted):
    _, _, _, tm, _ = fitted
    tm.train()
    evaluate_grid(tm, (4, 4, 4), device="cpu")
    assert tm.training


@pytest.mark.parametrize("shape, lo", [((5, 7, 3), 0.0), ((4, 3, 2, 6), -1.0), ((1, 9), 0.0)])
def test_flat_index_to_coords_matches_jax(shape, lo):
    n = int(np.prod(shape))
    got = flat_index_to_coords(torch.arange(n), shape, lo=lo)
    want = jax_flat_index_to_coords(jnp.arange(n), shape, lo=lo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), io.flat_coords(shape, lo=lo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(32, 30), (12, 11, 9), (8, 9, 5, 6)])
def test_metrics_match_jax(shape):
    rng = np.random.default_rng(1)
    target = rng.random(shape, dtype=np.float32)
    pred = np.clip(target + 0.05 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    want = jmetrics.evaluate_reconstruction(jnp.asarray(pred), jnp.asarray(target))
    got = metrics.evaluate_reconstruction(pred, target, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key


def test_ssim_of_identical_images_is_one():
    x = torch.from_numpy(io.synthetic_volume((16, 16, 8), seed=2))
    assert float(metrics.ssim(x, x, win_size=7)) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="smaller than win_size"):
        metrics.ssim(x[:5], x[:5])


@pytest.mark.parametrize("use_native", [True, False])
def test_io_matches_jax(tmp_path, monkeypatch, use_native):
    """The port's loader against the JAX package's, bitwise: a whole volume
    through both native codecs (the JAX one built into this test's own
    directory, so that no other test's build of it races this one) or both
    numpy readers; a slice through numpy."""
    from mri_interpolation_tpu import native as jax_native

    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(tmp_path / "libmit_native.so"))
    jax_native.build()
    vol = io.synthetic_volume((9, 8, 5), seed=4)
    np.testing.assert_array_equal(vol, jio.synthetic_volume((9, 8, 5), seed=4))
    np.testing.assert_array_equal(io.make_mgrid((4, 3), lo=-1.0), jio.make_mgrid((4, 3), lo=-1.0))
    assert io.nifti.nifti_bytes(vol, pixdim=(0.5, 0.5, 2.0)) == jio.nifti.nifti_bytes(vol, pixdim=(0.5, 0.5, 2.0))
    path = str(tmp_path / "v.nii.gz")
    jio.nifti.save(vol, path, pixdim=(0.5, 0.5, 2.0))
    ds = io.load_volume(path, use_native=use_native)
    jds = jio.load_volume(path, use_native=use_native)
    np.testing.assert_array_equal(ds.coords, jds.coords)
    np.testing.assert_array_equal(ds.values, jds.values)
    assert ds.shape == jds.shape and ds.pixdim == pytest.approx(jds.pixdim)
    z = io.load_volume(path, zero_centered=True, slice_axes=(slice(None), slice(None), 2))
    jz = jio.load_volume(path, zero_centered=True, slice_axes=(slice(None), slice(None), 2))
    np.testing.assert_array_equal(z.values, jz.values)
    np.testing.assert_array_equal(z.coords, jz.coords)


def test_nifti_roundtrip(tmp_path):
    vol = np.arange(2 * 3 * 4, dtype=np.int16).reshape(2, 3, 4)
    for name in ("a.nii", "a.nii.gz"):
        path = str(tmp_path / name)
        io.nifti.save(vol, path, pixdim=(1.0, 2.0, 3.0))
        img = io.nifti.load(path)
        np.testing.assert_array_equal(img.get_fdata(np.float32), vol.astype(np.float32))
        assert img.pixdim == (1.0, 2.0, 3.0)


def _write_volume(tmp_path, shape, seed=0):
    path = str(tmp_path / "vol.nii.gz")
    io.nifti.save(io.synthetic_volume(shape, seed=seed), path)
    return path


def test_launcher_writes_the_run(tmp_path):
    cfg = RunConfig(image_path=_write_volume(tmp_path, (16, 16, 8)), output_root=str(tmp_path / "runs"),
                    epochs=2, batch_size=512, base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8),
                    dim_hidden=16, interp_shapes=((16, 16, 16), (8, 8, 4)))
    summary = launcher.run(cfg, device="cpu")
    run_dir = summary["run_dir"]
    assert run_dir.endswith("version_0")
    files = set(os.listdir(run_dir))
    assert {"pred.nii.gz", "interpolation(16, 16, 16).nii.gz", "interpolation(8, 8, 4).nii.gz",
            "metrics.json", "config.txt", "checkpoints"} <= files
    assert io.nifti.load(os.path.join(run_dir, "pred.nii.gz")).shape == (16, 16, 8)
    interp = io.nifti.load(os.path.join(run_dir, "interpolation(16, 16, 16).nii.gz")).get_fdata(np.float32)
    assert interp.shape == (16, 16, 16) and np.isfinite(interp).all()
    with open(os.path.join(run_dir, "metrics.json")) as f:
        saved = json.load(f)
    assert saved["steps"] == 2 * (16 * 16 * 8 // 512) and np.isfinite(saved["psnr"])
    assert 0 < saved["ssim"] <= 1 and saved["device"] == "cpu"
    with open(os.path.join(run_dir, "config.txt")) as f:
        assert "dim_in : 3" in f.read()
    ckpt = torch.load(os.path.join(run_dir, "checkpoints", f"step_{saved['steps']}.pt"))
    model = make_hash_mlp(3, device="cpu", **SMALL)
    model.load_state_dict(ckpt["model"])
    recon = io.nifti.load(os.path.join(run_dir, "pred.nii.gz")).get_fdata(np.float32)
    np.testing.assert_allclose(evaluate_grid(model, (16, 16, 8), device="cpu"), recon, rtol=0, atol=1e-6)
    # a second run gets the next version
    assert launcher.run(cfg, device="cpu")["run_dir"].endswith("version_1")


def test_launcher_rank_adapts_a_4d_volume(tmp_path):
    cfg = RunConfig(image_path=_write_volume(tmp_path, (8, 8, 4, 6)), output_root=str(tmp_path / "runs"),
                    epochs=1, batch_size=256, dim_hidden=8, save_checkpoint=False)
    summary = launcher.run(cfg, device="cpu")
    files = set(os.listdir(summary["run_dir"]))
    assert "interpolation(8, 8, 4, 12).nii.gz" in files and "checkpoints" not in files
    with open(os.path.join(summary["run_dir"], "config.txt")) as f:
        text = f.read()
    assert "finest_resolution : (8, 8, 4, 6)" in text and "base_resolution : (2, 2, 2, 2)" in text
    assert cfg.dim_in == 0  # the caller's config is left as it was


@pytest.mark.parametrize("field, value", [("shard_tables", True), ("data_parallel", True),
                                          ("stream_shard_voxels", 100), ("tb_events", True)])
def test_launcher_unported_branches_raise(tmp_path, field, value):
    """Every branch runs. ``shard_tables`` and ``data_parallel`` at world
    size 1 (no process group) fall through to ``Trainer.fit``, as the JAX
    launcher does on one device: the same losses as the plain run;
    ``stream_shard_voxels`` (the out-of-core fit: 100-voxel shards of 2
    steps, 3 shards of the 256 voxels) and ``tb_events`` (the event file
    under ``tb/``) run."""
    cfg = RunConfig(image_path=_write_volume(tmp_path, (8, 8, 4)), output_root=str(tmp_path / "runs"), epochs=1,
                    batch_size=50, dim_hidden=8, base_resolution=(2, 2, 2), finest_resolution=(8, 8, 4),
                    interp_shapes=(), save_checkpoint=False)
    setattr(cfg, field, value)
    summary = launcher.run(cfg, device="cpu")
    assert np.isfinite(summary["psnr"]) and summary["world_size"] == 1
    if field in ("shard_tables", "data_parallel"):
        setattr(cfg, field, False)
        plain = launcher.run(cfg, device="cpu")
        assert summary["steps"] == plain["steps"] == 256 // 50
        assert summary["final_loss"] == plain["final_loss"] and summary["psnr"] == plain["psnr"]
    elif field == "stream_shard_voxels":
        assert summary["steps"] == 3 * 2 and len(summary["stream"]["host_synth_s"]) == 1
    else:
        assert summary["steps"] == 256 // 50 and len(os.listdir(os.path.join(summary["run_dir"], "tb"))) == 1
