"""Port parity: the helpers (``utils/__init__.py``: ``time_fn``,
``capture_trace``, ``enable_nan_debugging``; ``utils/imaging.py``:
``psf_kernel``, ``apply_psf``, the viewers; ``metrics.param_count``)
against the JAX package.

Tolerances: ``psf_kernel`` exact (the same numpy); ``apply_psf`` within
1e-6 of JAX's (a float32 convolution, its products summed in another
order); ``param_count`` exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mri_interpolation_tpu.metrics import param_count as jax_param_count
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.models import make_siren as jax_make_siren
from mri_interpolation_tpu.utils import imaging as jimaging
from mri_interpolation_tpu_torch import utils
from mri_interpolation_tpu_torch.io import png
from mri_interpolation_tpu_torch.metrics import param_count
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
from mri_interpolation_tpu_torch.utils import imaging


@pytest.mark.parametrize("dim, n", [(2, 5), (3, 3), (3, 5), (2, 4)])
def test_psf_kernel_is_exact(dim, n):
    got = imaging.psf_kernel(dim, n)
    want = jimaging.psf_kernel(dim, n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape, dim, n", [((17, 23), 2, 5), ((9, 8, 11), 3, 3), ((6, 7, 5), 3, 5)])
def test_apply_psf_matches_jax(shape, dim, n):
    values = np.random.default_rng(0).random((int(np.prod(shape)), 1)).astype(np.float32)
    kernel = imaging.psf_kernel(dim, n)
    got = imaging.apply_psf(values, kernel, shape, device="cpu")
    want = jimaging.apply_psf(values, kernel, shape)
    assert got.shape == want.shape == (values.shape[0], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_psf_flips_an_asymmetric_kernel_as_jax():
    values = np.random.default_rng(1).random((12 * 9, 1)).astype(np.float32)
    kernel = np.random.default_rng(2).random((3, 5)).astype(np.float32)
    np.testing.assert_allclose(imaging.apply_psf(values, kernel, (12, 9), device="cpu"),
                               jimaging.apply_psf(values, kernel, (12, 9)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", ["hash_mlp", "siren"])
def test_param_count_matches_jax(model):
    if model == "hash_mlp":
        kw = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=10, base_resolution=(4, 4, 2),
                  finest_resolution=(16, 16, 8), dim_hidden=16)
        jm, tm = jax_make_hash_mlp(dim_in=3, **kw), make_hash_mlp(3, device="cpu", **kw)
    else:
        jm, tm = jax_make_siren(dim_in=3, dim_hidden=32, n_layers=3), make_siren(3, dim_hidden=32, n_layers=3,
                                                                                  device="cpu")
    params, _ = jm.init(jax.random.key(0))
    want = jax_param_count(params)
    assert param_count(tm) == param_count(dict(tm.named_parameters())) == param_count(list(tm.parameters())) == want


def test_time_fn_and_capture_trace(tmp_path):
    calls = []
    ms = utils.time_fn(lambda x: calls.append(x) or torch.ones(4) * x, 2.0, iters=3)
    assert ms >= 0 and len(calls) == 4  # one untimed call, three timed
    out = utils.capture_trace(lambda: torch.ones(8).sum(), str(tmp_path / "trace"), iters=2)
    assert float(out) == 8.0
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any("aten::sum" in e.get("name", "") for e in trace["traceEvents"])


def test_enable_nan_debugging_checks_the_backward():
    utils.enable_nan_debugging()
    try:
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()  # sqrt of -1: NaN in the backward
    finally:
        utils.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_viewers_write_pngs(tmp_path):
    vol = np.random.default_rng(3).random((9, 7, 5)).astype(np.float32)
    img = imaging.show_slices(vol, str(tmp_path / "s.png"))
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "s.png")), img)
    # the first panel: the x mid-slice, transposed, row 0 at the bottom, gray over itself
    np.testing.assert_array_equal(img[4:4 + 5, 4:4 + 7], png.colorize(vol[4].T[::-1], png.GRAY))
    assert img.shape == (7 + 8, 7 + 9 + 9 + 16, 3)
    two = imaging.show(np.random.default_rng(4).random((6, 4)) + 1j, str(tmp_path / "t.png"))
    assert two.shape == (4 + 8, 6 + 8, 3) and os.path.exists(tmp_path / "t.png")
    with pytest.raises(ValueError, match="2D/3D"):
        imaging.show(np.zeros((2, 2, 2, 2)))
    path = imaging.tensor_visualisation(np.random.default_rng(5).random((3, 4, 6)), str(tmp_path / "d.png"))
    assert np.array(Image.open(path)).shape == (6 + 8, 3 * 4 + 4 * 4, 3)
