"""Port parity: the LOO-stacked temporal fusion (``train/stacking.py``)
against the JAX package on the CPU: the numpy fusion on synthetic fold and
deploy caches written in both layouts, the cache format read across the two
packages (the committed caches included), the families end to end on tiny
volumes, ``stacked_interp_eval`` with a warp_transfer fit run through both
trainers from one init, the fit memo and its disk layer, and the CLI.

Tolerances and their reasons:

- the fusion on one cache (weights, fused frames, uncertainty, calibration,
  oracles, the spatial field, the affine map): 1e-6, the same numpy
  operations on the same arrays;
- the committed caches: bitwise (one reader's code);
- the cubic and linear families: bitwise (numpy); the registration
  families at 20 Adam steps a stage: 1e-4 where the whole LOO protocol's
  fits are well conditioned (the pairwise one), lr (3e-3) for the group
  families, whose non-uniform folds amplify rounding as
  ``test_torch_registration.py`` shows;
- ``stacked_interp_eval`` with warp_transfer (one seed, one epoch in order,
  one init): odd-frame PSNR within 0.05 dB and SSIM within 5e-3 (PERF.md
  section 2), the global weights within 0.05;
- a refit recalled from the disk layer: 1e-6 (the same parameters).
"""

import os

import jax
import numpy as np
import pytest

import mri_interpolation_tpu.train.stacking as jstk
from mri_interpolation_tpu.models import warp as jwarp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
import mri_interpolation_tpu_torch.train.stacking as stk
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import nifti, normalize_intensity
from mri_interpolation_tpu_torch.models import warp as twarp
from mri_interpolation_tpu_torch.train import TrainConfig
from mri_interpolation_tpu_torch.train import trainer as port_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ctrl_sizes=(4, 8), pyramid=(2, 1), steps=20)
TINY_WARP = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=10, base_resolution=(4, 4),
                 finest_resolution=(16, 16), dim_hidden=8, n_layers=2, warp_hidden=8, warp_layers=3)


@pytest.fixture(autouse=True)
def no_fit_cache(monkeypatch):
    """Neither package reads or writes a warp-fit disk cache, and each test
    starts with empty fit memos."""
    monkeypatch.setattr(jstk, "_FIT_DISK_DIR", "")
    monkeypatch.setattr(stk, "_FIT_DISK_DIR", "")
    jstk._FIT_MEMO.clear()
    stk._FIT_MEMO.clear()
    yield
    jstk._FIT_MEMO.clear()
    stk._FIT_MEMO.clear()


def _blob(shape, center, sigma=0.12):
    axes = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    d2 = np.sum((grid - np.asarray(center, np.float32)) ** 2, axis=-1)
    return np.exp(-d2 / (2.0 * sigma**2)).astype(np.float32)


def _moving(t_full=9, shape=(16, 16)):
    return np.stack([_blob(shape, (0.3 + 0.04 * t, 0.5 - 0.02 * t)) for t in range(t_full)], axis=-1)


def _mk_cache(path, img, names, npz=()):
    """Deploy and fold predictions of ``names`` for the even-frame protocol
    of ``img``: the truth plus per-family noise of a family-specific scale
    and a spatial pattern (so weights, fields and oracles all differ), as
    ``.npy`` or, for the names in ``npz``, as the fp16 ``.npz`` layout."""
    rng = np.random.default_rng(0)
    even, odd = img[..., ::2], img[..., 1::2]
    n_even = even.shape[-1]
    os.makedirs(path, exist_ok=True)
    ramp = np.linspace(0, 1, img.shape[0], dtype=np.float32)[:, None]
    for f, n in enumerate(names):
        scale = 0.02 * (f + 1) * (1.0 + (ramp if f % 2 else 1.0 - ramp))

        def save(key, arr):
            if n in npz:
                np.savez_compressed(os.path.join(path, key + ".npz"), pred=arr.astype(np.float16))
            else:
                np.save(os.path.join(path, key + ".npy"), arr.astype(np.float32))

        save(f"deploy_{n}", odd + scale[..., None] * rng.standard_normal(odd.shape))
        for k in range(1, n_even - 1):
            save(f"fold{k}_{n}", even[..., k] + scale * rng.standard_normal(even.shape[:-1]))
    return path


def _assert_tree_close(got, want, atol, path="weights"):
    """Nested dicts of floats (and strings) equal up to ``atol``."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            _assert_tree_close(got[key], want[key], atol, f"{path}[{key!r}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= atol, (path, got, want)


def _raising(names):
    def fail(*_):
        raise AssertionError("a cached family was called")

    return {n: fail for n in names}


FUSIONS = {
    "temporal": dict(),
    "spatial_nested": dict(spatial="nested"),
    "robust_median_nested": dict(robust="median_nested"),
    "both_nested": dict(spatial="nested", robust="median_nested"),
    "forced": dict(spatial=(8.0, 2.0, 0.5), robust=0.25, shrink=0.3),
}


@pytest.mark.parametrize("name", sorted(FUSIONS))
def test_stacked_fuse_on_a_cache_matches_jax(tmp_path, name):
    img = np.random.default_rng(1).random((20, 16, 11)).astype(np.float32)
    names = ["a", "b", "c"]
    cache = _mk_cache(str(tmp_path / "cache"), img, names, npz=("b",))
    even = img[..., ::2]
    t_keep = np.asarray([2 * j / 10 for j in range(6)])
    t_odd = np.asarray([(2 * j + 1) / 10 for j in range(5)])
    kw = FUSIONS[name]
    want, wj = jstk.stacked_fuse(even, t_keep, t_odd, _raising(names), cache_dir=cache, **kw)
    got, wt = stk.stacked_fuse(even, t_keep, t_odd, _raising(names), cache_dir=cache, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    (dj, w_j), (dt, w_t) = wj.pop("_components"), wt.pop("_components")
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-6)
    _assert_tree_close(wt, wj, 1e-6)
    np.testing.assert_allclose(stk.fusion_uncertainty(dt, w_t), jstk.fusion_uncertainty(dj, w_j), rtol=0, atol=1e-6)


def test_fusion_helpers_match_jax():
    rng = np.random.default_rng(2)
    preds, target = rng.random((4, 300)), rng.random(300)
    np.testing.assert_allclose(stk.simplex_lstsq(preds, target), jstk.simplex_lstsq(preds, target), rtol=0, atol=1e-6)
    folds = [(0.2 * k, rng.random((3, 12, 10)), rng.random((12, 10))) for k in range(1, 4)]
    for sigma, temp in ((2.0, 2.0), (0.0, 1.0)):
        np.testing.assert_allclose(stk.spatial_weight_field(folds, sigma, temp),
                                   jstk.spatial_weight_field(folds, sigma, temp), rtol=0, atol=1e-6)
    deploy, truth = rng.random((3, 12, 10, 4)), rng.random((12, 10, 4))
    got, want = stk.fusion_oracles(deploy, truth), jstk.fusion_oracles(deploy, truth)
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) < 1e-6 for k in got)
    w_time, w_field = rng.random((4, 3)), rng.random((12, 10, 4, 3))
    for w in (w_time, w_field):
        np.testing.assert_allclose(stk.fusion_uncertainty(deploy, w), jstk.fusion_uncertainty(deploy, w), rtol=0,
                                   atol=1e-6)
    sigma, err = rng.random(500), rng.standard_normal(500)
    got, want = stk.uncertainty_calibration(sigma, err), jstk.uncertainty_calibration(sigma, err)
    _assert_tree_close({k: v for k, v in got.items() if k != "risk_coverage"},
                       {k: v for k, v in want.items() if k != "risk_coverage"}, 1e-12)
    for k in ("coverage", "rmse"):
        np.testing.assert_allclose(got["risk_coverage"][k], want["risk_coverage"][k], rtol=0, atol=1e-12)
    vol = rng.random((6, 5, 3, 7)) * 50.0
    sl = vol[:, :, 1, :]
    sl = (sl - sl.min()) / (sl.max() - sl.min())
    v4 = (vol - vol.min()) / (vol.max() - vol.min())
    assert stk.slice_affine_norm(v4, sl, 1) == pytest.approx(jstk.slice_affine_norm(v4, sl, 1), abs=1e-12)
    with pytest.raises(AssertionError):
        stk.slice_affine_norm(v4, sl[::-1], 1)
    for name in ("DEFAULT_INTERP_INCLUDE", "DEFAULT_STACK_2DT", "DEFAULT_STACK_Z4D", "DEFAULT_STACK_4D"):
        assert getattr(stk, name) == getattr(jstk, name)
    assert set(stk.__all__) >= set(jstk.__all__)


def test_committed_caches_read_bit_for_bit():
    """The JAX package's committed fold and deploy caches (``.npy`` and the
    fp16 ``.npz``), read by both packages' readers."""
    cache = os.path.join(REPO, "runs", "stacked_cache_ep100_anneal")
    if not os.path.isdir(cache):
        pytest.skip("the committed stacked caches are not in this checkout")
    assert stk.cached_family_names(cache) == jstk.cached_family_names(cache)
    for key in ("deploy_cubic", "deploy_warp_distill_fused2", "fold1_registration", "fold3_warp_transfer"):
        assert stk.has_cached_prediction(cache, key) == jstk.has_cached_prediction(cache, key) is True
        got, want = stk.load_cached_prediction(cache, key), jstk.load_cached_prediction(cache, key)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert stk.load_cached_prediction(cache, "deploy_absent") is None


def test_a_cache_written_by_either_package_is_read_by_the_other(tmp_path):
    pred = np.random.default_rng(3).random((6, 5, 2)).astype(np.float32)
    for writer, reader, sub in ((stk, jstk, "port"), (jstk, stk, "jax")):
        d = str(tmp_path / sub)
        first = writer._cached_call(d, "deploy_x", lambda: pred)
        np.testing.assert_array_equal(reader.load_cached_prediction(d, "deploy_x"), first)
        np.testing.assert_array_equal(first, pred.astype(np.float16).astype(np.float32))
        assert reader._cached_call(d, "deploy_x", lambda: 1 / 0) is not None
        assert reader.cached_family_names(d) == ["x"]


@pytest.mark.parametrize("family", ["cubic", "linear", "registration", "registration_group", "registration_cubic"])
def test_cheap_families_match_jax(family):
    """Each family on a uniform deployment and on a non-uniform LOO fold."""
    frames = _moving(9)[..., ::2]
    make = {"cubic": lambda m: m._cubic_family(), "linear": lambda m: m._linear_family(),
            "registration": lambda m: m._registration_family(**SMALL, **dev(m)),
            "registration_group": lambda m: m._registration_group_family(**SMALL, **dev(m)),
            "registration_cubic": lambda m: m._registration_group_family(appearance="cubic", **SMALL, **dev(m))}
    atol = {"cubic": 0.0, "linear": 0.0, "registration": 1e-4}.get(family, 3e-3)
    t_keep = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0])
    for keep, t_eval in (([0, 1, 2, 3, 4], [0.125, 0.375, 0.625, 0.875]), ([0, 1, 3, 4], [0.5])):
        args = (frames[..., keep], t_keep[keep], np.asarray(t_eval))
        got, want = make[family](stk)(*args), make[family](jstk)(*args)
        assert got.shape == want.shape == frames.shape[:-1] + (len(t_eval),)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def dev(module):
    return {"device": "cpu"} if module is stk else {}


def _shared_init(monkeypatch, kw, seeds):
    """The JAX trainer and the port's stacking module start every warp fit
    of a seed from one JAX init."""
    jm = jwarp.make_warp_inr(dim_in=3, **kw)
    inits = {s: jax.device_get(jm.init(jax.random.key(s))) for s in seeds}
    jfit = JaxTrainer.fit
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, m, c, v, **k: jfit(
        self, m, c, v, params=inits[self.config.seed][0], state=inits[self.config.seed][1]))
    make = twarp.make_warp_inr

    def make_port(dim_in, seed=0, device=None, **k):
        model = make(dim_in, seed=seed, device=device, **k)
        model.load_state_dict(params_from_jax(*inits[seed]))
        return model

    monkeypatch.setattr(stk, "make_warp_inr", make_port)


def test_stacked_interp_eval_with_warp_transfer_matches_jax(monkeypatch):
    """The even-frame protocol on a moving blob: warp_transfer (one seed,
    one epoch through the data in order) beside cubic and linear, the LOO
    weights and the held-out scores."""
    seeds = (1337,)
    kw = dict(TINY_WARP, warp_scale=0.05, residual_scale=0.05, warp_w0=5.0, warp_accel=1.0)
    _shared_init(monkeypatch, kw, seeds)
    img = _moving(9)
    roster = ("warp_transfer", "cubic", "linear")
    cfg = dict(batch_size=128, epochs=1, lr=1e-2, optimizer="adam_tcnn", shuffle=False)
    jf = jstk.default_interp_families(JaxTrainConfig(**cfg), img.shape, seeds, include=roster, **TINY_WARP)
    tf = stk.default_interp_families(TrainConfig(**cfg), img.shape, seeds, include=roster, device="cpu", **TINY_WARP)
    jrecon, jq = jstk.stacked_interp_eval(img, JaxTrainConfig(**cfg), families=jf)
    recon, q = stk.stacked_interp_eval(img, TrainConfig(**cfg), families=tf, device="cpu")
    np.testing.assert_array_equal(recon[..., ::2], img[..., ::2])
    assert abs(q["odd"]["psnr"] - jq["odd"]["psnr"]) < 0.05 and abs(q["odd"]["ssim"] - jq["odd"]["ssim"]) < 5e-3
    assert abs(sum(q["weights"]["global"].values()) - 1.0) < 1e-6
    for name in roster:
        assert abs(q["weights"]["global"][name] - jq["weights"]["global"][name]) < 0.05, name
    assert q["uncertainty"]["sigma_mean"] == pytest.approx(jq["uncertainty"]["sigma_mean"], rel=0.05)
    assert "_components" not in q["weights"]


def _count_fits(monkeypatch):
    calls = {"n": 0}
    fit = port_trainer.Trainer.fit

    def counting_fit(self, *a, **k):
        calls["n"] += 1
        return fit(self, *a, **k)

    monkeypatch.setattr(port_trainer.Trainer, "fit", counting_fit)
    return calls


def test_warp_and_transfer_families_share_fits(monkeypatch):
    """warp and warp_transfer train identical models on identical data: the
    fit memo makes the pair cost one ensemble."""
    calls = _count_fits(monkeypatch)
    even = np.random.default_rng(3).random((8, 8, 5), dtype=np.float32)[..., ::2]
    t_keep, t_eval = np.asarray([0.0, 0.5, 1.0]), np.asarray([0.25, 0.75])
    cfg = TrainConfig(batch_size=64, epochs=1, lr=1e-2)
    kw = dict(n_levels=2, n_features_per_level=1, log2_hashmap_size=8, base_resolution=(4, 4),
              finest_resolution=(8, 8), warp_hidden=8, warp_layers=2, dim_hidden=8, n_layers=2, warp_w0=5.0,
              warp_accel=1.0, warp_scale=0.05)
    stk._warp_family(cfg, (0, 1), (8, 8, 5), device="cpu", **kw)(even, t_keep, t_eval)
    assert calls["n"] == 2
    stk._warp_transfer_family(cfg, (0, 1), device="cpu", **kw)(even, t_keep, t_eval)
    assert calls["n"] == 2, "warp_transfer retrained instead of reusing fits"


def test_warp_fit_disk_cache_survives_memo_eviction(monkeypatch, tmp_path):
    """After the in-process memo is cleared (a new process), the same family
    loads its state dicts from disk instead of refitting, and predicts the
    same; the files are the port's own (``.pt``)."""
    monkeypatch.setattr(stk, "_FIT_DISK_DIR", str(tmp_path / "fit_cache"))
    calls = _count_fits(monkeypatch)
    even = np.random.default_rng(4).random((8, 8, 5), dtype=np.float32)[..., ::2]
    t_keep, t_eval = np.asarray([0.0, 0.5, 1.0]), np.asarray([0.25, 0.75])
    cfg = TrainConfig(batch_size=64, epochs=1, lr=1e-2)
    kw = dict(n_levels=2, n_features_per_level=1, log2_hashmap_size=8, base_resolution=(4, 4),
              finest_resolution=(8, 8), warp_hidden=8, warp_layers=2, dim_hidden=8, n_layers=2, warp_w0=5.0,
              warp_accel=1.0, warp_scale=0.05, residual_scale=0.05)
    fam = stk._warp_transfer_family(cfg, (0,), use_residual=True, device="cpu", **kw)
    first = fam(even, t_keep, t_eval)
    assert calls["n"] == 1
    assert [p.endswith(".pt") for p in os.listdir(tmp_path / "fit_cache")] == [True]
    stk._FIT_MEMO.clear()
    second = fam(even, t_keep, t_eval)
    assert calls["n"] == 1, "refit despite a valid disk cache entry"
    np.testing.assert_allclose(second, first, rtol=0, atol=1e-6)
    avg = stk._warp_transfer_family(cfg, (0,), use_residual=True, average_motion=True, device="cpu", **kw)
    np.testing.assert_allclose(avg(even, t_keep, t_eval), first, rtol=0, atol=1e-6)  # one seed: the same
    assert calls["n"] == 1


def test_default_families_and_rosters():
    fams = stk.default_interp_families(TrainConfig(epochs=1), (16, 16, 9), include="all", device="cpu")
    assert list(fams) == list(jstk.default_interp_families(JaxTrainConfig(epochs=1), (16, 16, 9), include="all"))
    assert list(stk.default_interp_families(TrainConfig(epochs=1), (16, 16, 9), device="cpu")) == list(
        stk.DEFAULT_INTERP_INCLUDE)


def test_stacking_cli_replays_its_cache(tmp_path, capsys, monkeypatch):
    """``python -m ...train.stacking`` on a 4-D volume's z slice with a
    cache: the second run calls no family and writes the same volume."""
    img = _moving(5, (16, 16))
    src = str(tmp_path / "seq.nii.gz")
    nifti.save(img[:, :, None, :], src)
    calls = {"n": 0}
    make = stk.default_interp_families

    def counting(*a, **k):
        fams = make(*a, **k)

        def wrap(f):
            def family(*args):
                calls["n"] += 1
                return f(*args)

            return family

        return {n: wrap(f) for n, f in fams.items()}

    monkeypatch.setattr(stk, "default_interp_families", counting)
    outs = []
    for run in range(2):
        dst = str(tmp_path / f"sr{run}.nii.gz")
        stk._main([src, "--out", dst, "--factor", "2", "--epochs", "1", "--families", "cubic,linear", "--slice_z",
                   "0", "--cache_dir", str(tmp_path / "cache"), "--uncertainty_out", str(tmp_path / "u.nii.gz"),
                   "--device", "cpu"])
        outs.append(nifti.load(dst).get_fdata(np.float32))
        assert calls["n"] == 2 * (1 + 3), calls  # deploy + 3 folds a family, in the first run only
    assert outs[0].shape == (16, 16, 9)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][..., ::2], normalize_intensity(img.reshape(-1)).reshape(img.shape))
    assert '"global_weights"' in capsys.readouterr().out
