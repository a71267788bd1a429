"""Port parity: the out-of-core fit (``Trainer.fit_streaming``, its host-shard
helpers, the launcher's ``stream_shard_voxels`` branch) against the JAX
package.

Tolerances:

- the host-shard helpers (``resolve_value_range``,
  ``flatten_volume_source``, ``make_host_shard_fn``) are numpy in both
  packages: coordinates and values bit for bit, for C- and F-ordered arrays
  and a memmapped ``.nii``;
- every step's loss within rtol 1e-4 of JAX's ``fit_streaming`` from the
  same parameters (``convert.params_from_jax``), as ``test_torch_trainer.py``
  holds ``fit``: float32 summation orders differ between XLA and PyTorch
  and compound over the Adam steps. Both packages draw each epoch's
  permutation from ``np.random.default_rng(seed)``, so the batches are the
  same with shuffling on;
- final parameters within atol 1e-5 on the ``relu_plain`` shape. The
  flagship's BatchNorm-fed biases have a true gradient of zero, so Adam
  moves them by float noise, differently in each package (ROADMAP.md §3):
  its curves are the comparison there.

Tables are redrawn U(-0.5, 0.5), as in the other trainer tests.
"""

import os

import jax
import numpy as np
import pytest

from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu.train import trainer as jtrainer
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import load_volume, nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer
from mri_interpolation_tpu_torch.train import trainer as ttrainer

RTOL, ATOL = 1e-4, 1e-5
RELU_3D = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=10, base_resolution=(4, 4, 2),
               finest_resolution=(16, 12, 6), growth="paper", decoder="relu_plain", dim_hidden=16, n_layers=2)
# the full-4D recipe's shape (5 levels x F = 4, paper growth, relu_plain), cut to (10, 8, 4, 5)
RELU_4D = dict(n_levels=5, n_features_per_level=4, log2_hashmap_size=10, base_resolution=(2, 2, 2, 2),
               finest_resolution=(10, 8, 4, 5), growth="paper", decoder="relu_plain", dim_hidden=16, n_layers=2)
FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23, base_resolution=(4, 4, 2),
                finest_resolution=(16, 12, 6), dim_hidden=16, n_layers=2)


def _pair(dim, kw, seed=0):
    """A JAX HashMLP and the port's with the same parameters (table U(-0.5, 0.5))."""
    jm = jax_make_hash_mlp(dim_in=dim, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    tm = make_hash_mlp(dim, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def _stream_both(dim, kw, volume, cfg, shard_voxels, **stream_kw):
    jm, params, state, tm = _pair(dim, kw)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit_streaming(jm, volume, shard_voxels=shard_voxels, params=params,
                                                           state=state, **stream_kw)
    tres = Trainer(TrainConfig(**cfg)).fit_streaming(tm, volume, shard_voxels=shard_voxels, device="cpu",
                                                     **stream_kw)
    return jres, tm, tres


# ---------------------------------------------------------------------------
# host-shard helpers


def _sources(tmp_path):
    vol = (synthetic_volume((7, 6, 5, 4), seed=2) * 900.0 + 37.0).astype(np.float32)
    path = str(tmp_path / "vol.nii")
    nifti.save(vol, path)
    return {"C": vol, "F": np.asfortranarray(vol), "memmap": nifti.load_memmap(path).dataobj}


@pytest.mark.parametrize("kind", ["C", "F", "memmap"])
def test_host_shard_helpers_are_bit_equal(tmp_path, kind):
    src = _sources(tmp_path)[kind]
    flat_t, order_t = ttrainer.flatten_volume_source(src)
    flat_j, order_j = jtrainer.flatten_volume_source(src)
    assert order_t == order_j == ("C" if kind == "C" else "F")
    np.testing.assert_array_equal(np.asarray(flat_t), np.asarray(flat_j))
    n = int(np.prod(src.shape))
    idx = np.random.default_rng(0).permutation(n)[:301].astype(np.int64)
    for value_range in (None, False, (10.0, 500.0)):
        vr_t = ttrainer.resolve_value_range(flat_t, n, 97, value_range)
        assert vr_t == jtrainer.resolve_value_range(flat_j, n, 97, value_range)
        for lo in (0.0, -1.0):
            ct, vt = ttrainer.make_host_shard_fn(src.shape, lo, 1.0, flat_t, *vr_t, order_t)(idx)
            cj, vj = jtrainer.make_host_shard_fn(src.shape, lo, 1.0, flat_j, *vr_t, order_j)(idx)
            np.testing.assert_array_equal(ct, cj)
            np.testing.assert_array_equal(vt, vj)
    # the coordinates are the grid's and the values the voxels', in C order, whatever the layout
    ct, vt = ttrainer.make_host_shard_fn(src.shape, 0.0, 1.0, flat_t, 0.0, 1.0, order_t)(np.arange(n))
    np.testing.assert_array_equal(vt[:, 0], np.asarray(src, np.float32).reshape(-1))
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, s) for s in src.shape], indexing="ij"), -1).reshape(n, -1)
    np.testing.assert_allclose(ct, grid, rtol=0, atol=1e-7)


def test_memmap_stream_equals_the_array_stream(tmp_path):
    """A memmapped F-order .nii streams the same batches as the array."""
    src = _sources(tmp_path)
    cfg = TrainConfig(batch_size=64, epochs=1, lr=1e-2, seed=5, optimizer="adam_tcnn")
    losses = []
    for kind in ("C", "memmap"):
        model = make_hash_mlp(4, device="cpu", **{**RELU_4D, "finest_resolution": (7, 6, 5, 4)}, seed=1)
        losses.append(Trainer(cfg).fit_streaming(model, src[kind], shard_voxels=300, device="cpu").losses)
    np.testing.assert_array_equal(losses[0], losses[1])


# ---------------------------------------------------------------------------
# the fit


@pytest.mark.parametrize("case", ["relu_plain_3d", "relu_plain_4d", "flagship_3d"])
def test_fit_streaming_matches_jax(case):
    """Two epochs of several shards, the last one padded from the
    permutation's head, shuffled; the 3-D volumes raw (value_range None:
    the chunked min-max scan), the 4-D one normalised (value_range False)."""
    if case == "relu_plain_4d":
        dim, kw, volume, stream = 4, RELU_4D, synthetic_volume((10, 8, 4, 5), seed=3), dict(value_range=False)
        shard, batch = 500, 128  # 1,600 voxels: 3 steps a shard of 384, 5 shards, the last padded by 320
    else:
        dim, kw = 3, (RELU_3D if case == "relu_plain_3d" else FLAGSHIP)
        volume, stream = synthetic_volume((16, 12, 6), seed=3) * 250.0 + 4.0, {}
        shard, batch = 400, 100  # 1,152 voxels: 4 steps a shard of 400, 3 shards, the last padded by 48
    cfg = dict(batch_size=batch, epochs=2, lr=1e-2, seed=7, optimizer="adam_tcnn")
    jres, tm, tres = _stream_both(dim, kw, volume, cfg, shard, **stream)
    n = int(np.prod(volume.shape))
    steps_per_shard = min(shard, n) // batch
    n_shards = -(-n // (steps_per_shard * batch))
    assert n_shards >= 3 and n_shards * steps_per_shard * batch > n  # a padded last shard
    assert tres.steps == jres.steps == 2 * n_shards * steps_per_shard
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    assert len(tres.host_synth_s) == len(tres.h2d_s) == len(tres.shard_wait_s) == 2
    if case == "flagship_3d":
        return
    want = params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state))
    got = tm.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("option", ["cosine", "accumulation", "remat"])
def test_fit_streaming_options_match_jax(option):
    """The trainer's options compose with streaming: the cosine over
    ``n_shards * steps_per_shard`` steps an epoch, accumulation over 2
    mini-steps, remat (value-identical)."""
    extra = {"cosine": dict(lr_schedule="cosine", cosine_t_max=2), "accumulation": dict(accumulate_grad_batches=2),
             "remat": dict(remat=True)}[option]
    cfg = dict(batch_size=100, epochs=2, lr=1e-2, seed=11, optimizer="adam_tcnn", **extra)
    volume = synthetic_volume((16, 12, 6), seed=4)
    jres, tm, tres = _stream_both(3, RELU_3D, volume, cfg, 400, value_range=False)
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    want = params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state))
    for key, value in want.items():
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), value.numpy(), rtol=0, atol=ATOL, err_msg=key)


def test_fit_streaming_refuses_a_grid_of_2_31_voxels():
    class Huge:
        shape = (1 << 16, 1 << 15)

    model = make_hash_mlp(2, device="cpu", base_resolution=(2, 2), finest_resolution=(4, 4), dim_hidden=4)
    with pytest.raises(ValueError, match="int32 flat indexing"):
        Trainer(TrainConfig()).fit_streaming(model, Huge(), device="cpu")


# ---------------------------------------------------------------------------
# the launcher's branch


def _write(tmp_path, shape, seed=0):
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume(shape, seed=seed), path)
    return path


def test_launcher_streams_the_whole_grid(tmp_path):
    """``stream_shard_voxels`` > 0 runs ``fit_streaming`` on the loaded
    image (value_range False, lo -1 when zero-centred): the run equals a
    direct ``fit_streaming`` of the same model, and its summary carries the
    epochs' host seconds."""
    path = _write(tmp_path, (10, 8, 4, 5))
    kw = dict(RELU_4D, base_resolution=(2, 2, 2, 2), finest_resolution=(10, 8, 4, 5))
    cfg = RunConfig(image_path=path, output_root=str(tmp_path / "runs"), epochs=2, batch_size=128, lr=1e-2,
                    optimizer="adam_tcnn", stream_shard_voxels=500, interp_shapes=(), zero_centered=True,
                    eval_every_epochs=1, **kw)
    summary = launcher.run(cfg, device="cpu")
    assert summary["steps"] == 2 * 5 * 3 and np.isfinite(summary["psnr"])
    assert len(summary["stream"]["host_synth_s"]) == 2
    model = make_hash_mlp(4, device="cpu", **kw, seed=cfg.seed)
    image = load_volume(path, zero_centered=True).image()
    want = Trainer(TrainConfig(batch_size=128, epochs=2, lr=1e-2, optimizer="adam_tcnn", seed=cfg.seed)).fit_streaming(
        model, image, shard_voxels=500, lo=-1.0, value_range=False, device="cpu")
    assert summary["final_loss"] == pytest.approx(want.final_loss, rel=1e-6)
    files = set(os.listdir(summary["run_dir"]))
    assert {"pred.nii.gz", "metrics.json", "config.txt", "scalars.jsonl", "checkpoints"} <= files


@pytest.mark.parametrize("field, value, match", [("even_frames_only", True, "FULL volume grid"),
                                                 ("undersample_pct", 10.0, "FULL volume grid"),
                                                 ("shard_tables", True, "does not compose with --shard_tables")])
def test_launcher_streaming_refuses_what_it_cannot_stream(tmp_path, field, value, match):
    cfg = RunConfig(image_path=str(tmp_path / "absent.nii.gz"), output_root=str(tmp_path / "runs"),
                    stream_shard_voxels=100)
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match=match):
        launcher.run(cfg, device="cpu")
    assert not (tmp_path / "runs").exists()

