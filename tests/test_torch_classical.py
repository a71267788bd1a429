"""Port parity: the classical interpolation baselines
(``infer/classical.py``: the multilinear resampler, the per-voxel cubic
Hermite, the temporal upsampling dispatch and the CLI) against the JAX
package, on volumes made with numpy from a seed.

Tolerances and their reasons:

- the multilinear resampler: 1e-6 absolute on values in [0, 1]. The port
  lerps one axis at a time, JAX's ``map_coordinates`` sums 2^d weighted
  corners, and XLA rounds some ``linspace`` sample positions an ulp apart
  from the port's (the exact positions rounded to float32 once);
- the cubic Hermite: exactly equal (the same numpy operations);
- the CLI's files: 1e-6, as the resampler.
"""

import numpy as np
import pytest

from mri_interpolation_tpu.infer import classical as jclassical
from mri_interpolation_tpu_torch.infer import classical
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume

RESAMPLES = {
    "2d_up": ((7, 5), (13, 9)),
    "2d_down": ((9, 8), (5, 3)),
    "3d_time": ((6, 5, 4), (6, 5, 7)),
    "3d_all": ((5, 6, 7), (9, 4, 13)),
    "4d": ((4, 3, 5, 6), (4, 3, 5, 11)),
    "single": ((5, 4), (1, 4)),
}


@pytest.mark.parametrize("name", sorted(RESAMPLES))
def test_linear_interpolate_volume_matches_jax(name):
    shape, out = RESAMPLES[name]
    vol = np.random.default_rng(len(shape)).uniform(0, 1, shape).astype(np.float32)
    got = classical.linear_interpolate_volume(vol, out, device="cpu")
    want = jclassical.linear_interpolate_volume(vol, out)
    assert got.shape == out and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_linear_interpolate_volume_keeps_the_source_frames():
    """Doubling the time axis puts source frame t at output frame 2t
    exactly, and the frames between at the midpoints."""
    vol = synthetic_volume((6, 5, 4), seed=3)
    got = classical.linear_interpolate_volume(vol, (6, 5, 7), device="cpu")
    np.testing.assert_array_equal(got[..., ::2], vol)
    np.testing.assert_allclose(got[..., 1::2], 0.5 * (vol[..., :-1] + vol[..., 1:]), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="rank"):
        classical.linear_interpolate_volume(vol, (6, 5), device="cpu")


@pytest.mark.parametrize("t_full", [7, 8])
def test_cubic_interpolate_frames_matches_jax(t_full):
    frames = np.random.default_rng(t_full).uniform(0, 1, (5, 4, 4)).astype(np.float32)
    t_keep = [min(2 * j, t_full - 1) / (t_full - 1) for j in range(4)]
    t_eval = [i / (t_full - 1) for i in range(t_full)]
    got = classical.cubic_interpolate_frames(frames, t_keep, t_eval)
    np.testing.assert_array_equal(got, jclassical.cubic_interpolate_frames(frames, t_keep, t_eval))


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_temporal_upsample_classical_matches_jax(method):
    src = synthetic_volume((6, 5, 4), seed=2)
    for t_full in (7, 8):
        got = classical.temporal_upsample_classical(src, t_full, method=method, device="cpu")
        np.testing.assert_allclose(got, jclassical.temporal_upsample_classical(src, t_full, method=method),
                                   rtol=0, atol=1e-6)


def test_temporal_upsample_refusals():
    src = synthetic_volume((6, 5, 4), seed=2)
    with pytest.raises(ValueError, match="incompatible"):
        classical.temporal_upsample_classical(src, 12, method="cubic", device="cpu")
    for method in ("registration", "registration_group"):
        with pytest.raises(ValueError, match="incompatible"):
            classical.temporal_upsample_classical(src, 12, method=method, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        classical.temporal_upsample_classical(src, 7, method="nearest", device="cpu")


@pytest.mark.parametrize("argv", [["--method", "linear"], ["--method", "cubic"], ["--no-even_frames"],
                                  ["--method", "cubic", "--slice_z", "1"]], ids=["linear", "cubic", "all_frames",
                                                                                "cubic_z1"])
def test_cli_file_matches_jax(tmp_path, argv, capsys):
    """``python -m ...infer.classical`` on a 4-D volume (the (x, y, t)
    slice at z) against the JAX CLI's file."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((8, 7, 4, 9), seed=4) * 3.0, path)
    out, jout = str(tmp_path / "port.nii.gz"), str(tmp_path / "jax.nii.gz")
    got = classical.main([path, "--out", out, "--device", "cpu", *argv])
    jclassical.main([path, "--out", jout, *argv])
    assert "wrote" in capsys.readouterr().out
    port_file = nifti.load(out).get_fdata(np.float32)
    jax_file = nifti.load(jout).get_fdata(np.float32)
    assert port_file.shape == jax_file.shape == (8, 7, 9)
    np.testing.assert_array_equal(port_file, got)
    np.testing.assert_allclose(port_file, jax_file, rtol=0, atol=1e-6)


def test_cli_refuses_other_methods_on_all_frames(tmp_path):
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((6, 5, 7), seed=4), path)
    with pytest.raises(SystemExit):
        classical.main([path, "--out", str(tmp_path / "o.nii.gz"), "--no-even_frames", "--method", "cubic",
                        "--device", "cpu"])
