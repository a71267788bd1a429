"""Port parity: the stacking analysis (``mri_interpolation_tpu_torch.experiments.
stacking_analysis``) against ``scripts/stacking_analysis.py``, which is
imported by file path and not edited.

- The numpy functions on seeded inputs: the two solvers, ``solve_weights``
  and ``nested_score`` to 1e-12; ``_box_blur``, ``motion_feature``,
  ``gated_solve`` and ``gated_fuse`` exactly.
- ``main``, ``--gated`` and ``--uncertainty`` on one synthetic cache (the
  port's linear and cubic families and a seeded noisy linear one, written by
  ``train.stacking.stacked_fuse`` in the port's layout) with both packages'
  volume loaders returning the same image: every printed line equal, except
  ``odd_ssim`` within 5e-3 (the pipeline's SSIM tolerance) and the panel's
  path (the JAX script writes ``runs/figures/``, the port ``<out_dir>/figures/``).
- The panel: three tiles, the middle one matplotlib's ``magma`` of the
  confidence map, row 0 at the bottom; the titles in ``tEXt``.
- The selected row's SSIM, the analysis's only device work, runs on
  ``--device``.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import mri_interpolation_tpu.utils as jutils
from mri_interpolation_tpu import io as jio
from mri_interpolation_tpu_torch import io
from mri_interpolation_tpu_torch.experiments import common, stacking_analysis as sa
from mri_interpolation_tpu_torch.io import png
from mri_interpolation_tpu_torch.train import stacking

REPO = Path(__file__).resolve().parents[1]
VOLUME = (24, 24, 6, 15)
SWEEP = ["--lams", "0,1", "--shrinks", "0,0.5"]


@pytest.fixture(scope="module")
def jsa():
    saved = jutils.setup_compilation_cache
    jutils.setup_compilation_cache = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location("jax_stacking_analysis", REPO / "scripts" / "stacking_analysis.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jutils.setup_compilation_cache = saved
    return module


def image() -> np.ndarray:
    return io.dataset_from_array(io.synthetic_volume(VOLUME, seed=4)[common.SLICE]).image()


def write_cache(cache_dir: str, img: np.ndarray) -> None:
    """Fold and deploy predictions of three families in the port's layout."""
    train, _ = io.even_frame_split(img)
    t_full = img.shape[-1]
    t_keep = np.asarray([2 * j / (t_full - 1) for j in range(train.shape[-1])])
    t_odd = np.asarray([(2 * j + 1) / (t_full - 1) for j in range(t_full // 2)])
    linear = stacking._linear_family()

    def noisy(frames, tk, te):
        base = linear(frames, tk, te)
        rng = np.random.default_rng(len(tk) * 1000 + int(round(float(te[0]) * 997)))
        return (base + 0.05 * rng.standard_normal(base.shape)).astype(np.float32)

    stacking.stacked_fuse(train, t_keep, t_odd, {"linear": linear, "cubic": stacking._cubic_family(),
                                                 "noisy_linear": noisy}, cache_dir=cache_dir)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache"))
    write_cache(d, image())
    return d


def seeded_folds(rng, F=3, S=40, n=5):
    target = [rng.random(S) for _ in range(n)]
    return [(0.1 * (k + 1), np.stack([t + 0.1 * (f + 1) * rng.standard_normal(S) for f in range(F)]), t)
            for k, t in enumerate(target)]


@pytest.mark.parametrize("lam", [0.0, 0.3, 10.0])
def test_solvers_match_jax(jsa, lam):
    rng = np.random.default_rng(int(lam * 10))
    preds, target = rng.random((4, 200)), rng.random(200)
    np.testing.assert_allclose(sa.simplex_lstsq_ridge(preds, target, lam), jsa.simplex_lstsq_ridge(preds, target, lam),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sa.affine_lstsq_ridge(preds, target, lam), jsa.affine_lstsq_ridge(preds, target, lam),
                               rtol=0, atol=1e-12)
    folds = seeded_folds(rng)
    names = ["a", "b", "c"]
    t_new = np.linspace(0.05, 0.55, 6)
    for solver, clip in ((sa.simplex_lstsq_ridge, True), (sa.affine_lstsq_ridge, False)):
        jsolver = getattr(jsa, solver.__name__)
        for got, want in zip(sa.solve_weights(folds, names, t_new, lam, 0.25, solver=solver, clip=clip),
                             jsa.solve_weights(folds, names, t_new, lam, 0.25, solver=jsolver, clip=clip)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert abs(sa.nested_score(folds, names, lam, 0.5, solver, clip)
                   - jsa.nested_score(folds, names, lam, 0.5, jsolver, clip)) <= 1e-12


@pytest.mark.parametrize("shape,rad", [((24, 24), 4), ((5, 30), 3), ((11, 9, 7), 2)])
def test_blur_and_motion_feature_match_jax(jsa, shape, rad):
    rng = np.random.default_rng(sum(shape))
    a, b = rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(sa._box_blur(a, rad), jsa._box_blur(a, rad))
    np.testing.assert_array_equal(sa.motion_feature(a, b, rad), jsa.motion_feature(a, b, rad))


@pytest.mark.parametrize("n_bins", [1, 3, 5])
def test_gated_solve_and_fuse_match_jax(jsa, n_bins):
    rng = np.random.default_rng(n_bins)
    folds_feats = [(rng.random((3, 60)), rng.random(60), rng.random(60)) for _ in range(4)]
    names = ["a", "b", "c"]
    qs, W = sa.gated_solve(folds_feats, names, n_bins, 0.1)
    jqs, jW = jsa.gated_solve(folds_feats, names, n_bins, 0.1)
    np.testing.assert_array_equal(qs, jqs)
    np.testing.assert_array_equal(W, jW)
    preds, feat = rng.random((3, 8, 9)), rng.random((8, 9))
    np.testing.assert_array_equal(sa.gated_fuse(preds, feat, qs, W), jsa.gated_fuse(preds, feat, jqs, jW))


def test_load_folds_matches_jax(jsa, cache):
    img = image()
    got, want = sa.load_folds(cache, img), jsa.load_folds(cache, img)
    assert got[0] == want[0] == ["cubic", "linear", "noisy_linear"]
    assert len(got[1]) == len(want[1]) == 6
    for (tg, pg, yg), (tw, pw, yw) in zip(got[1], want[1]):
        assert tg == tw
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(yg, yw)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def run_both(jsa, monkeypatch, capsys, tmp_path, flags):
    """The JAX script's main and the port's with ``flags``: their printed
    lines, and the devices the port's SSIM ran on (its only device work)."""
    vol = io.synthetic_volume(VOLUME, seed=4)
    ssim_devices = []
    real = sa.evaluate_reconstruction

    def spy(pred, target, data_range=1.0, device=None):
        ssim_devices.append(torch.device(device).type)
        return real(pred, target, data_range=data_range, device=device)

    monkeypatch.setattr(sa, "evaluate_reconstruction", spy)
    monkeypatch.setattr(jsa, "load_volume", lambda path, slice_axes=None, **kw: jio.dataset_from_array(vol[slice_axes]))
    monkeypatch.setattr(common, "load_volume", lambda path, slice_axes=None, **kw: io.dataset_from_array(
        vol[slice_axes]))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.argv", ["stacking_analysis.py", *flags])
    jsa.main()
    want = capsys.readouterr().out.splitlines()
    sa.main([*flags, "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    return got, want, ssim_devices


def assert_same_lines(got, want):
    assert len(got) == len(want) > 3
    ssims = 0
    for g, w in zip(got, want):
        if "odd_ssim" in w:
            gj, wj = json.loads(g), json.loads(w)
            assert abs(gj.pop("odd_ssim") - wj.pop("odd_ssim")) < 5e-3
            assert gj == wj
            ssims += 1
        elif w.startswith('{"panel"'):
            assert g.startswith('{"panel"')
        else:
            assert g == w
    return ssims


def test_main_sweep_matches_jax(jsa, cache, monkeypatch, capsys, tmp_path):
    got, want, ssim_devices = run_both(jsa, monkeypatch, capsys, tmp_path, ["--cache_dir", cache, *SWEEP])
    assert assert_same_lines(got, want) == 1 and ssim_devices == ["cpu"]
    assert len([ln for ln in got if ln.startswith('{') and '"nested_mse"' in ln]) == 2 * 2 * 2


def test_main_gated_matches_jax(jsa, cache, monkeypatch, capsys, tmp_path):
    got, want, ssim_devices = run_both(jsa, monkeypatch, capsys, tmp_path, ["--cache_dir", cache, "--gated"])
    assert assert_same_lines(got, want) == 1 and ssim_devices == ["cpu"]
    assert len([ln for ln in got if ln.startswith('{') and '"nested_mse"' in ln]) == 16


def test_main_uncertainty_matches_jax_and_draws_the_panel(jsa, cache, monkeypatch, capsys, tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    from PIL import Image

    got, want, ssim_devices = run_both(jsa, monkeypatch, capsys, tmp_path, ["--cache_dir", cache, "--uncertainty"])
    assert_same_lines(got, want)
    assert ssim_devices == []
    path = tmp_path / "out" / "figures" / "uncertainty_panel.png"
    assert json.loads(got[-1]) == {"panel": str(path)}
    assert (tmp_path / "runs" / "figures" / "uncertainty_panel.png").exists()  # the JAX script's, in its cwd
    assert not (tmp_path / "out" / "results.json").exists()
    im = Image.open(path)
    pixels = np.asarray(im.convert("RGB"))
    assert pixels.shape == (24, 3 * 24 + 8, 3)
    assert im.text["panel 1"].startswith("confidence map sigma (no ground truth) (range ")
    # the middle tile: magma of sigma at the middle odd frame, imshow(sigma.T, origin="lower")
    img = image()
    names, folds, deploy, t_odd = sa.load_folds(cache, img)
    w_new, _ = sa.solve_weights(folds, names, t_odd, lam=0.0, shrink=0.5)
    sigma = stacking.fusion_uncertainty(deploy, w_new)[..., len(t_odd) // 2]
    norm = matplotlib.colors.Normalize(vmin=sigma.min(), vmax=sigma.max())
    want_tile = matplotlib.colormaps["magma"](norm(sigma.T[::-1]), bytes=True)[..., :3]
    np.testing.assert_array_equal(pixels[:, 28:52], want_tile)
    assert (pixels[:, 24:28] == 255).all() and (pixels[:, 52:56] == 255).all()


def test_magma_equals_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    np.testing.assert_array_equal(png.MAGMA, matplotlib.colormaps["magma"](np.arange(256), bytes=True)[:, :3])


def test_main_without_a_cache_names_the_flag(monkeypatch, tmp_path):
    vol = io.synthetic_volume(VOLUME, seed=4)
    monkeypatch.setattr(common, "load_volume", lambda path, slice_axes=None, **kw: io.dataset_from_array(
        vol[slice_axes]))
    with pytest.raises(SystemExit, match="--cache_dir"):
        sa.main(["--cache_dir", str(tmp_path / "empty"), "--device", "cpu"])
    assert not os.listdir(tmp_path)
