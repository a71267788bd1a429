"""Port parity: the occlusion probe (``mri_interpolation_tpu_torch.experiments.
occlusion_probe``) against ``scripts/occlusion_probe.py``, which is imported by
file path and not edited.

Both run on one small synthetic 2-D+t image (24 x 24, 9 and 10 frames: the
10-frame case takes the clamped last gap, whose tau extrapolates) with the
same warp INRs: the JAX script's ``_fit_warp_memoized`` returns small JAX warp
INRs (random tables, the warp field's last layer drawn so the motion is not
the identity), the port's returns the same models through
``convert.params_from_jax``. Their ``warp_scale`` is 0.6, so that 8
fixed-point iterations leave residuals of 0.07-1 (at 0.05 they converge to
~2e-8, float32 rounding, and ~70 of 576 voxels of the residual pick fall to
the other side in either package: that row would compare rounding). The
unrounded PSNRs then agree to ~1e-5 dB. Both read the same ``deploy_warp`` prediction
(the port's cache layout). Each of the 8 printed PSNRs agrees within 0.01 dB
(one step of their 2-decimal rounding); the two packages hand the fit the
same training set, seeds, config and widths.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

import mri_interpolation_tpu.models.warp as jwarp
import mri_interpolation_tpu.train.stacking as jstacking
import mri_interpolation_tpu.utils as jutils
from mri_interpolation_tpu import io as jio
from mri_interpolation_tpu_torch import io
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.experiments import common, occlusion_probe
from mri_interpolation_tpu_torch.models import make_warp_inr
from mri_interpolation_tpu_torch.train import stacking

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=16, base_resolution=(4, 4),
            finest_resolution=(24, 24), dim_hidden=16, warp_hidden=16, warp_scale=0.6, residual_scale=0.05,
            warp_w0=5.0)
KEYS = ["transfer_baseline", "oracle_best_side", "oracle_per_voxel_tau", "pick_by_fp_residual", "pick_by_seed_sigma",
        "pick_by_inr_arbiter", "inr_projection_blend_075", "photometric_soft"]


def load_script():
    import importlib.util

    saved = jutils.setup_compilation_cache
    jutils.setup_compilation_cache = lambda *a, **k: None  # the script would point JAX's cache outside the repo
    try:
        spec = importlib.util.spec_from_file_location("jax_occlusion_probe", REPO / "scripts" / "occlusion_probe.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jutils.setup_compilation_cache = saved
    return module


def jax_warp(seed: int):
    """A small JAX warp INR whose motion is not the identity: (model, params, state)."""
    jm = jwarp.make_warp_inr(dim_in=3, **TINY)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["encoder"]["table"] = rng.uniform(-0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    for layer in params["warp"][-1:]:
        layer["w"] = rng.uniform(-0.5, 0.5, layer["w"].shape).astype(np.float32)
    return jm, params, state


def image_of(n_frames: int) -> np.ndarray:
    """The z = 3 slice's 2-D+t image as both packages load it (min-max to [0, 1])."""
    return io.dataset_from_array(io.synthetic_volume((24, 24, 6, n_frames), seed=5)[common.SLICE]).image()


def write_deploy_warp(cache_dir: str, image: np.ndarray) -> None:
    """A stand-in for the warp family's deployment prediction at the odd
    times: the odd frames plus seeded noise, in the port's cache layout."""
    odd = image[..., 1::2]
    noise = 0.03 * np.random.default_rng(9).standard_normal(odd.shape)
    stacking._cached_call(cache_dir, "deploy_warp", lambda: (odd + noise).astype(np.float32))


@pytest.mark.parametrize("n_frames", [9, 10])
def test_probe_matches_the_jax_script(n_frames, tmp_path, monkeypatch, capsys):
    image = image_of(n_frames)
    cache = str(tmp_path / "cache")
    write_deploy_warp(cache, image)
    models = {s: jax_warp(s) for s in occlusion_probe.SEEDS}
    calls = {"jax": [], "port": []}

    jscript = load_script()

    def jfit(cfg, seed, coords, values, dim_in, wk):
        calls["jax"].append((cfg, seed, coords, values, dim_in, wk))
        return models[seed]

    def tfit(cfg, seed, coords, values, dim_in, wk, device):
        calls["port"].append((cfg, seed, coords, values, dim_in, wk))
        _, params, state = models[seed]
        tm = make_warp_inr(3, device=device, **TINY)
        tm.load_state_dict(params_from_jax(params, state))
        return tm

    monkeypatch.setattr(jscript, "load_volume", lambda path, slice_axes=None, **kw: jio.dataset_from_array(
        io.synthetic_volume((24, 24, 6, n_frames), seed=5)[slice_axes]))
    monkeypatch.setattr(jscript, "_fit_warp_memoized", jfit)
    monkeypatch.setattr(jscript, "load_cached_prediction", lambda d, key: jstacking.load_cached_prediction(cache, key))
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")  # no results.json here: the script writes nothing
    jscript.main()
    printed = capsys.readouterr().out
    want = json.loads(printed[printed.index("\n{") + 1:])
    assert list(os.listdir(tmp_path / "jax")) == []

    monkeypatch.setattr(occlusion_probe, "_fit_warp_memoized", tfit)
    monkeypatch.setattr(common, "load_volume", lambda path, slice_axes=None, **kw: io.dataset_from_array(
        io.synthetic_volume((24, 24, 6, n_frames), seed=5)[slice_axes]))
    out_dir = tmp_path / "out"
    got = occlusion_probe.main(["--cache_dir", cache, "--out_dir", str(out_dir), "--device", "cpu"])

    assert list(want) == list(got) == KEYS
    for k in KEYS:
        assert abs(got[k] - want[k]) <= 0.01 + 1e-9, (k, got[k], want[k])
    assert len(calls["jax"]) == len(calls["port"]) == 4
    for (jc, js, jx, jy, jd, jw), (tc, ts, tx, ty, td, tw) in zip(calls["jax"], calls["port"]):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc) and (ts, td, tw) == (js, jd, jw)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    saved = json.loads((out_dir / "results.json").read_text())
    assert saved == {"occlusion_probe": got}
    doc = (out_dir / "RESULTS.md").read_text()
    assert "## Occlusion-aware transfer: a measured negative result" in doc
    assert "`python -m mri_interpolation_tpu_torch.experiments.occlusion_probe`" in doc
    assert f"against the transfer baseline's {got['transfer_baseline']} dB" in doc


def test_probe_without_the_cache_leaves_out_the_arbiter_rows(monkeypatch):
    image = image_of(9)

    def tfit(cfg, seed, coords, values, dim_in, wk, device):
        _, params, state = jax_warp(seed)
        tm = make_warp_inr(3, device=device, **TINY)
        tm.load_state_dict(params_from_jax(params, state))
        return tm

    monkeypatch.setattr(occlusion_probe, "_fit_warp_memoized", tfit)
    got = occlusion_probe.occlusion_probe(image, seeds=(1, 2), cache_dir=None, device="cpu")
    assert list(got) == [k for k in KEYS if "inr" not in k]
    assert all(np.isfinite(v) for v in got.values())
    assert got["oracle_best_side"] >= got["transfer_baseline"] - 0.01  # an oracle reads the odd frames


def test_main_fits_the_even_frames_with_the_deployment_config(monkeypatch, tmp_path):
    """The CLI's fits are the stacked protocol's deployment fits (``CFG``,
    ``WK``, the 4 seeds) on the even frames at their times, on the device
    asked for."""
    seen = []

    def tfit(cfg, seed, coords, values, dim_in, wk, device):
        seen.append((cfg, seed, coords, values, wk, device))
        return make_warp_inr(3, device=device, **TINY)

    monkeypatch.setattr(occlusion_probe, "_fit_warp_memoized", tfit)
    monkeypatch.setattr(common, "load_volume", lambda path, slice_axes=None, **kw: io.dataset_from_array(
        io.synthetic_volume((24, 24, 6, 9), seed=5)[slice_axes]))
    occlusion_probe.main(["--cache_dir", str(tmp_path / "none"), "--out_dir", str(tmp_path / "o"), "--device", "cpu"])
    assert [s[1] for s in seen] == list(occlusion_probe.SEEDS)
    cfg, _, coords, values, wk, device = seen[0]
    assert cfg == occlusion_probe.CFG and (cfg.epochs, cfg.cosine_t_max, cfg.batch_size) == (100, 100, 10000)
    assert wk == occlusion_probe.WK and str(device) == "cpu"
    image = image_of(9)
    assert coords.shape == (24 * 24 * 5, 3)
    np.testing.assert_array_equal(np.unique(coords[:, 2]), np.asarray([0, 0.25, 0.5, 0.75, 1.0], np.float32))
    np.testing.assert_array_equal(values[:, 0], np.moveaxis(image[..., ::2], -1, 0).reshape(-1))
