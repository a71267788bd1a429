"""Port parity: the held-out-frame and undersampling protocols, in the
launcher (``even_frames_only``, ``undersample_pct``, ``save_latents``, the
PSF spacing, the SIREN family through ``launcher.run``) and in
``train/protocols.py`` (the seed-ensembled warp protocol among them), and
the port's undersampling mask (``utils.create_rn_mask``), against the JAX
package.

JAX's mask draws from ``jax.random.bernoulli``, which torch cannot
reproduce, so the parity tests hand JAX's kept indices to the port (the
port's function is monkeypatched in the launcher's and the protocols'
namespaces), as ``convert.params_from_jax`` hands over parameters. Both
launchers start from one init through their checkpoints, and each fit takes
its whole training set as one batch, so the two frameworks' shuffles give
the same steps.

Tolerances and their reasons:

- training coordinates: bitwise (the same numpy operations in the same
  order) for the even frames; the undersampled rows and the training
  values bitwise against what the JAX launcher trains on, both launchers
  loading the volume through their native C++ codecs (the same source and
  flags) or both through numpy (the ``loader`` cases); the native load
  within an ulp (6e-8) of JAX's numpy loader, whose grid and normalisation
  round in another order;
- PSNR within 0.05 dB and SSIM within 5e-3, the full volume's and the odd
  frames' (``test_torch_pipeline.py``'s bounds for two fits from one init);
- latents: atol 1e-5 (a fit's table held through the same steps; the
  features are its lerps);
- the protocols' loss curves: rtol 1e-4 (``test_torch_trainer.py``'s);
- the mask's kept fraction: within 5 binomial standard deviations of
  ``pct / 100``.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu import launcher as jlauncher
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.models import siren as jsiren
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu.train import protocols as jprotocols
from mri_interpolation_tpu.train import save_checkpoint as jax_save_checkpoint
from mri_interpolation_tpu.utils import imaging as jimaging
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import (dataset_from_array, even_frame_split, even_frame_training_set, nifti,
                                            synthetic_volume)
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.models import siren as tsiren
from mri_interpolation_tpu_torch.train import TrainConfig, protocols, save_checkpoint
from mri_interpolation_tpu_torch.train import trainer as port_trainer
from mri_interpolation_tpu_torch.utils import create_rn_mask

SHAPE = (16, 16, 8)
# the temporal protocol's HashMLP (scripts/experiments.py:267-273) at a small size
PROTOCOL = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(4, 4, 2),
                finest_resolution=(16, 16, 8), growth="paper", dim_hidden=16, n_layers=2, decoder="relu_plain",
                temporal_tv=0.01)
PROTOCOL_RUN = dict(optimizer="adam_tcnn", lr=1e-2, lr_schedule="cosine", cosine_t_max=20, weight_decay=1e-5,
                    epochs=20, save_checkpoint=False, interp_shapes=((16, 16, 16),), **PROTOCOL)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vol") / "synthetic_16x16x8.nii.gz")
    nifti.save(synthetic_volume(SHAPE, seed=7), path)
    return path


def _hash_init(kw=PROTOCOL, seed=0):
    jm = jax_make_hash_mlp(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    return jm, params, state


def _checkpoints(tmp_path, params, state, port_state_dict):
    jax_ckpt, port_ckpt = str(tmp_path / "jax_init"), str(tmp_path / "port_init")
    jax_save_checkpoint(jax_ckpt, 0, params, state)
    save_checkpoint(port_ckpt, 0, port_state_dict)
    return jax_ckpt, port_ckpt


@pytest.fixture
def fit_inputs(monkeypatch):
    """The (coords, values) each trainer's ``fit`` is called with, by framework."""
    seen = {"jax": [], "port": []}
    jfit, pfit = JaxTrainer.fit, port_trainer.Trainer.fit

    def jax_fit(self, model, coords, values, *a, **k):
        seen["jax"].append((np.array(coords), np.array(values)))
        return jfit(self, model, coords, values, *a, **k)

    def port_fit(self, model, coords, values, *a, **k):
        seen["port"].append((np.array(coords), np.array(values)))
        return pfit(self, model, coords, values, *a, **k)

    monkeypatch.setattr(JaxTrainer, "fit", jax_fit)
    monkeypatch.setattr(port_trainer.Trainer, "fit", port_fit)
    return seen


@pytest.fixture(params=["native", "numpy"])
def loader(request, monkeypatch, tmp_path_factory):
    """How both launchers load a whole volume: through their native codecs
    (JAX's built into a directory of this test's own, so that no other
    test's build of it races this one) or through numpy (JAX's codec hidden,
    the port's ``load_volume`` called with ``use_native=False``)."""
    from mri_interpolation_tpu import native as jax_native
    from mri_interpolation_tpu_torch import io as port_io

    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(tmp_path_factory.mktemp("jax_native") / "libmit_native.so"))
    if request.param == "native":
        jax_native.build()
        assert jax_native.available()
    else:
        monkeypatch.setattr(port_io, "load_volume", functools.partial(port_io.load_volume, use_native=False))
        assert not jax_native.available()
    return request.param


def _assert_loaded_alike(port, jax_launcher, numpy_loader, loader):
    """Bitwise equal to the JAX launcher's; equal to the JAX numpy loader's
    where both load through numpy, within an ulp of it where they load
    through their codecs."""
    np.testing.assert_array_equal(port, jax_launcher)
    np.testing.assert_allclose(port, numpy_loader, rtol=0, atol=6e-8 if loader == "native" else 0.0)


def _jax_numpy_dataset(volume):
    from mri_interpolation_tpu.io import load_volume as jax_load_volume

    return jax_load_volume(volume, use_native=False)


def _both_launchers(tmp_path, volume, run, jax_ckpt, port_ckpt):
    want = jlauncher.run(jconfigs.RunConfig(image_path=volume, **run, checkpoint_path=jax_ckpt,
                                            output_root=str(tmp_path / "jax")))
    got = launcher.run(RunConfig(image_path=volume, **run, checkpoint_path=port_ckpt,
                                 output_root=str(tmp_path / "port")), device="cpu")
    with open(os.path.join(got["run_dir"], "metrics.json")) as f:
        assert json.load(f)["steps"] == got["steps"]
    assert got["steps"] == want["steps"] == run["epochs"]
    assert abs(got["psnr"] - want["psnr"]) < 0.05 and abs(got["ssim"] - want["ssim"]) < 5e-3
    return want, got


def test_even_frames_and_latents_match_the_jax_launcher(volume, tmp_path, fit_inputs, loader):
    """The temporal protocol's HashMLP (relu_plain, F=4, paper growth,
    temporal TV, adam_tcnn, cosine, weight decay) trained on the 4 even
    frames of (16, 16, 8) by both launchers from one init, 20 one-batch
    epochs, ``save_latents`` on: the training set bitwise, the odd frames'
    PSNR and SSIM, and the latents."""
    jm, params, state = _hash_init()
    tm = make_hash_mlp(3, device="cpu", **PROTOCOL)
    tm.load_state_dict(params_from_jax(params, state))
    run = dict(PROTOCOL_RUN, even_frames_only=True, save_latents=True, batch_size=16 * 16 * 4)
    want, got = _both_launchers(tmp_path, volume, run, *_checkpoints(tmp_path, params, state, tm.state_dict()))
    (jc, jv), (pc, pv) = fit_inputs["jax"][0], fit_inputs["port"][0]
    assert pc.dtype == np.float32 and pc.shape == (1024, 3)
    np.testing.assert_array_equal(pc, jc)
    _assert_loaded_alike(pv, jv, _jax_numpy_dataset(volume).image()[..., ::2].reshape(-1, 1), loader)
    # even frame k at frame 2k of the whole volume: t = 2k / 7
    np.testing.assert_allclose(np.unique(pc[:, -1]), np.arange(4) * 2 / 7, rtol=0, atol=1e-7)
    for key in ("odd_psnr", "odd_ssim", "odd_mse"):
        assert key in got and np.isfinite(got[key])
    assert abs(got["odd_psnr"] - want["odd_psnr"]) < 0.05 and abs(got["odd_ssim"] - want["odd_ssim"]) < 5e-3
    lat = nifti.load(os.path.join(got["run_dir"], "latents.nii.gz")).get_fdata(np.float32)
    jlat = nifti.load(os.path.join(want["run_dir"], "latents.nii.gz")).get_fdata(np.float32)
    assert lat.shape == SHAPE + (16,)
    np.testing.assert_allclose(lat, jlat, rtol=0, atol=1e-5)
    assert got["train_voxels"] == 1024


def test_even_frame_training_set_matches_jax_numpy():
    """The launcher's and protocol's even-frame set on a (5, 4, 7) volume
    (odd T) and a 2-D one, in both coordinate conventions, against JAX's
    arithmetic."""
    from mri_interpolation_tpu.io.volume import flat_coords as jflat_coords

    for shape in ((5, 4, 7), (6, 9)):
        img = synthetic_volume(shape, seed=2)
        for zc in (False, True):
            coords, values = even_frame_training_set(img, zc)
            train = img[..., ::2]
            lo = -1.0 if zc else 0.0
            want = jflat_coords(train.shape, lo=lo)
            want[:, -1] = lo + (want[:, -1] - lo) * (2.0 * (train.shape[-1] - 1) / max(shape[-1] - 1, 1))
            np.testing.assert_array_equal(coords, want)
            np.testing.assert_array_equal(values, train.reshape(-1, 1))
            assert coords[:, -1].max() <= 1.0 and coords[:, -1].min() == lo


def test_undersampling_with_jax_mask_matches_the_jax_launcher(volume, tmp_path, fit_inputs, monkeypatch, loader):
    """``undersample_pct 10`` with the port given JAX's kept indices: the same
    training rows, then PSNR and SSIM of the whole reconstruction."""
    kw = {k: v for k, v in PROTOCOL.items() if k != "temporal_tv"}
    jm, params, state = _hash_init(kw, seed=1)
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    n = int(np.prod(SHAPE))
    jmask, jkept = jimaging.create_rn_mask((n,), 10.0, key=1337)
    asked = []

    def jax_mask(shape, percentage, key=0):
        asked.append((tuple(shape), percentage, key))
        return jmask, jkept

    monkeypatch.setattr(launcher, "create_rn_mask", jax_mask)
    run = dict(PROTOCOL_RUN, temporal_tv=0.0, undersample_pct=10.0, batch_size=len(jkept), seed=1337)
    _, got = _both_launchers(tmp_path, volume, run, *_checkpoints(tmp_path, params, state, tm.state_dict()))
    assert asked == [((n,), 10.0, 1337)]
    (jc, jv), (pc, pv) = fit_inputs["jax"][0], fit_inputs["port"][0]
    jds = _jax_numpy_dataset(volume)
    _assert_loaded_alike(pc, jc, jds.coords[jkept], loader)
    _assert_loaded_alike(pv, jv, jds.values[jkept], loader)
    assert got["train_voxels"] == len(jkept) and 0.05 * n < len(jkept) < 0.15 * n


def test_even_frames_and_undersampling_compose(volume, tmp_path):
    """Both options: the mask is drawn over the even frames' set, with the
    run's seed; the port's own mask."""
    n_even = 16 * 16 * 4
    cfg = RunConfig(image_path=volume, output_root=str(tmp_path), even_frames_only=True, undersample_pct=50.0,
                    epochs=1, batch_size=64, seed=3, interp_shapes=(), save_checkpoint=False, **PROTOCOL)
    got = launcher.run(cfg, device="cpu")
    _, kept = create_rn_mask((n_even,), 50.0, key=3)
    assert got["train_voxels"] == len(kept) and got["steps"] == len(kept) // 64
    assert np.isfinite(got["odd_psnr"])


@pytest.mark.parametrize("name", ["modulated_siren", "hash_siren", "psf_siren"])
def test_siren_family_through_both_launchers(volume, tmp_path, name):
    """Each SIREN variant zero-centred through both launchers from one init,
    10 one-batch epochs (the PSF SIREN on its 3^3-point objective): steps,
    PSNR and SSIM; the PSF SIREN gets the volume's half-voxel spacing."""
    jmake, tmake = {"modulated_siren": (jsiren.make_modulated_siren, tsiren.make_modulated_siren),
                    "hash_siren": (jsiren.make_hash_siren, tsiren.make_hash_siren),
                    "psf_siren": (jsiren.make_psf_siren, tsiren.make_psf_siren)}[name]
    spacing = tuple(0.5 / (s - 1) for s in SHAPE)
    kw = dict(dim_hidden=16, n_layers=2)
    model_kw = {"hash_siren": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
                                  per_level_scale=2.0),
                "psf_siren": dict(coordinates_spacing=spacing, n_sample=3)}.get(name, {})
    jm = jmake(dim_in=3, **kw, **model_kw)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    tm = tmake(3, device="cpu", **kw, **model_kw)
    tm.load_state_dict(params_from_jax(params, state))
    flags = {k: v for k, v in model_kw.items() if k != "coordinates_spacing"}
    run = dict(model_class=name, zero_centered=True, lr=1e-4, epochs=10, batch_size=int(np.prod(SHAPE)),
               save_checkpoint=False, interp_shapes=((16, 16, 16),), **kw, **flags)
    _, got = _both_launchers(tmp_path, volume, run, *_checkpoints(tmp_path, params, state, tm.state_dict()))
    assert got["model"] == name
    assert os.path.exists(os.path.join(got["run_dir"], "interpolation(16, 16, 16).nii.gz"))
    if name == "psf_siren":
        assert got["coordinates_spacing"] == pytest.approx(list(spacing))
    else:
        assert "coordinates_spacing" not in got


def test_psf_siren_gets_the_spacing():
    """The port of the JAX launcher test ``test_psf_gets_spacing``."""
    cfg = RunConfig(model_class="psf_siren", dim_hidden=16, n_layers=2)
    model = launcher.build_model(cfg, 3, "cpu", coordinates_spacing=(0.01, 0.01, 0.05))
    assert model.name == "psf_siren" and model.hparams["coordinates_spacing"] == (0.01, 0.01, 0.05)
    assert model.offsets.shape == (125, 3) and float(model.offsets[:, 2].max()) == pytest.approx(0.05)
    with pytest.raises(ValueError, match="coordinates_spacing"):
        launcher.build_model(cfg, 3, "cpu")


def test_save_latents_needs_the_split(volume, tmp_path):
    """``save_latents`` writes latents only for a model with the
    encode/decode split, as in JAX: a SIREN run writes none."""
    cfg = RunConfig(image_path=volume, output_root=str(tmp_path), model_class="siren", zero_centered=True,
                    dim_hidden=8, n_layers=2, epochs=1, batch_size=1024, save_latents=True, interp_shapes=(),
                    save_checkpoint=False)
    got = launcher.run(cfg, device="cpu")
    assert "latents.nii.gz" not in os.listdir(got["run_dir"])


@pytest.mark.parametrize("pct", [10.0, 50.0])
def test_port_mask_is_seeded_and_binomial(pct):
    shape = (40, 30, 20)
    mask, kept = create_rn_mask(shape, pct, key=5)
    again, kept_again = create_rn_mask(shape, pct, key=5)
    other, _ = create_rn_mask(shape, pct, key=6)
    assert mask.dtype == np.float32 and mask.shape == shape and set(np.unique(mask)) == {0.0, 1.0}
    np.testing.assert_array_equal(mask, again)
    np.testing.assert_array_equal(kept, kept_again)
    assert not np.array_equal(mask, other)
    np.testing.assert_array_equal(kept, np.flatnonzero(mask.reshape(-1)))
    n, p = mask.size, pct / 100
    assert abs(len(kept) - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def test_key_frame_subset_matches_jax():
    ds = dataset_from_array(synthetic_volume((6, 5, 16), seed=1))
    got = protocols.key_frame_subset(ds.coords, ds.values, ds.shape, (3, 7, 13))
    want = jprotocols.key_frame_subset(ds.coords, ds.values, ds.shape, (3, 7, 13))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 6 * 5 * 3


def _protocol_pair(kw, seed=0):
    jm, params, state = _hash_init(kw, seed)
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def test_two_phase_hash_fit_matches_jax(monkeypatch):
    """Phase 1 on the key frames, phase 2 with every parameter outside the
    encoder frozen: both loss curves; the decoder ends as phase 1 left it
    (only weight decay, 0 here, could move it)."""
    kw = {k: v for k, v in PROTOCOL.items() if k != "temporal_tv"}
    jm, params, state, tm = _protocol_pair(kw)
    ds = dataset_from_array(synthetic_volume((8, 8, 16), seed=3))
    jfit = JaxTrainer.fit
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, m, c, v, **k: jfit(
        self, m, c, v, **{"params": params, "state": state, **k}))  # the JAX phase 1 from the shared init
    cfg1, cfg2 = dict(batch_size=192, epochs=2, lr=5e-3, shuffle=False), dict(batch_size=512, epochs=2, lr=5e-3,
                                                                             shuffle=False)
    j1, j2 = jprotocols.two_phase_hash_fit(jm, ds.coords, ds.values, ds.shape, pretrain_config=JaxTrainConfig(**cfg1),
                                           train_config=JaxTrainConfig(**cfg2))
    t1, t2 = protocols.two_phase_hash_fit(tm, ds.coords, ds.values, ds.shape, pretrain_config=TrainConfig(**cfg1),
                                          train_config=TrainConfig(**cfg2), device="cpu")
    assert (t1.steps, t2.steps) == (j1.steps, j2.steps) == (2, 4)
    np.testing.assert_allclose(t1.losses, np.asarray(j1.losses), rtol=1e-4)
    np.testing.assert_allclose(t2.losses, np.asarray(j2.losses), rtol=1e-4)
    after1 = params_from_jax(jax.device_get(j1.params))
    for name, p in tm.named_parameters():
        if not name.startswith("encoder."):
            np.testing.assert_allclose(p.detach().numpy(), after1[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_even_frame_fit_eval_matches_jax(monkeypatch):
    kw = dict(PROTOCOL, temporal_tv=0.0)
    jm, params, state, tm = _protocol_pair(kw, seed=2)
    img = dataset_from_array(synthetic_volume(SHAPE, seed=4)).image()
    jfit = JaxTrainer.fit
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, m, c, v, **k: jfit(self, m, c, v, params=params, state=state))
    cfg = dict(batch_size=1024, epochs=10, lr=1e-2, optimizer="adam_tcnn")
    jres, jq = jprotocols.even_frame_fit_eval(jm, img, JaxTrainConfig(**cfg))
    tres, tq = protocols.even_frame_fit_eval(tm, img, TrainConfig(**cfg), device="cpu")
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-4)
    for part in ("full", "odd"):
        assert abs(tq[part]["psnr"] - jq[part]["psnr"]) < 0.05 and abs(tq[part]["ssim"] - jq[part]["ssim"]) < 5e-3


def test_undersampled_fit_eval_matches_jax(monkeypatch):
    kw = dict(PROTOCOL, temporal_tv=0.0)
    jm, params, state, tm = _protocol_pair(kw, seed=3)
    img = dataset_from_array(synthetic_volume(SHAPE, seed=5)).image()
    jmask, jkept = jimaging.create_rn_mask(img.shape, 30.0, key=0)
    monkeypatch.setattr(protocols, "create_rn_mask", lambda shape, pct, key=0: (np.asarray(jmask), jkept))
    jfit = JaxTrainer.fit
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, m, c, v, **k: jfit(self, m, c, v, params=params, state=state))
    cfg = dict(batch_size=len(jkept), epochs=10, lr=1e-2, optimizer="adam_tcnn")
    jres, jq = jprotocols.undersampled_fit_eval(jm, img, 30.0, JaxTrainConfig(**cfg))
    tres, tq = protocols.undersampled_fit_eval(tm, img, 30.0, TrainConfig(**cfg), device="cpu")
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-4)
    assert tq["kept_fraction"] == jq["kept_fraction"]
    for part in ("recon", "zero_filled"):
        assert abs(tq[part]["psnr"] - jq[part]["psnr"]) < 0.05 and abs(tq[part]["ssim"] - jq[part]["ssim"]) < 5e-3


def test_even_frame_split_matches_jax():
    from mri_interpolation_tpu.io import even_frame_split as jax_even_frame_split

    img = synthetic_volume((4, 3, 7), seed=0)
    for a, b in zip(even_frame_split(img), jax_even_frame_split(img)):
        np.testing.assert_array_equal(a, b)


def test_ensembled_warp_fit_eval_matches_jax(monkeypatch):
    """Two seeds of the warp INR (residual 0.05, warp_accel 1.0) on the even
    frames, each fit from the JAX init of its seed (injected by seed into
    the JAX trainer, and into the port through ``make_model(seed)``), the
    mean blended with the linear baseline at 0.25: each seed's odd-frame
    PSNR and the ensemble's odd and full scores."""
    from mri_interpolation_tpu.models import warp as jwarp
    from mri_interpolation_tpu_torch.models import make_warp_inr

    kw = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=16, base_resolution=(4, 4),
              finest_resolution=(16, 16), dim_hidden=16, warp_hidden=16, residual_scale=0.05, warp_accel=1.0)
    seeds = (1337, 7)
    jm = jwarp.make_warp_inr(dim_in=3, **kw)
    inits = {s: jax.device_get(jm.init(jax.random.key(s))) for s in seeds}

    def make_model(seed):
        tm = make_warp_inr(3, device="cpu", **kw)
        tm.load_state_dict(params_from_jax(*inits[seed]))
        return tm

    jfit = JaxTrainer.fit
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, m, c, v, **k: jfit(
        self, m, c, v, params=inits[self.config.seed][0], state=inits[self.config.seed][1]))
    img = dataset_from_array(synthetic_volume(SHAPE, seed=4)).image()
    cfg = dict(batch_size=16 * 16 * 4, epochs=10, lr=1e-2, optimizer="adam_tcnn")
    want = jprotocols.ensembled_warp_fit_eval(lambda: jm, img, JaxTrainConfig(**cfg), seeds=seeds, linear_blend=0.25)
    got = protocols.ensembled_warp_fit_eval(make_model, img, TrainConfig(**cfg), seeds=seeds, linear_blend=0.25,
                                            device="cpu")
    assert len(got["per_seed_odd_psnr"]) == 2
    np.testing.assert_allclose(got["per_seed_odd_psnr"], want["per_seed_odd_psnr"], rtol=0, atol=0.05)
    for part in ("odd", "full"):
        assert abs(got[part]["psnr"] - want[part]["psnr"]) < 0.05
        assert abs(got[part]["ssim"] - want[part]["ssim"]) < 5e-3
