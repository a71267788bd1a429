"""Port parity: the native IO runtime (``mri_interpolation_tpu_torch.native``,
the port's own copy of ``nifti_codec.cc``) and ``io.load_volume``'s native
path, against the JAX package's codec, bit for bit.

JAX's codec is built from its own source with its own ``build()``, into a
directory of each test's own (its ``_LIB_PATH`` monkeypatched), so that no
other test's build of the library in its package directory races this
one. The port's builds into the gitignored ``native/_build/`` through a
temporary file and ``os.replace``, so processes that build at once load
whole files.
"""

import gzip
import importlib
import os
import struct

import numpy as np
import pytest

from mri_interpolation_tpu import native as jax_native
from mri_interpolation_tpu.io import load_volume as jax_load_volume
from mri_interpolation_tpu.io import nifti as jax_nifti
from mri_interpolation_tpu_torch import native
from mri_interpolation_tpu_torch.io import load_volume, nifti

native_build = importlib.import_module("mri_interpolation_tpu_torch.native.build")  # the module: `native.build` is the function

DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64]


@pytest.fixture
def jax_codec(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(tmp_path / "jax_native" / "libmit_native.so"))
    os.makedirs(tmp_path / "jax_native")
    jax_native.build()
    assert jax_native.available()
    return jax_native


def _volume(tmp_path, dtype, shape=(9, 8, 5, 3), name="v.nii.gz", seed=0):
    data = (np.random.default_rng(seed).standard_normal(shape) * 40).astype(dtype)
    path = str(tmp_path / name)
    jax_nifti.save(data, path, pixdim=(0.5, 0.5, 2.0, 0.1)[:len(shape)])
    return data, path


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_load_volume_native_matches_jax_bitwise(tmp_path, jax_codec, dtype, zero_centered):
    _, path = _volume(tmp_path, dtype)
    got, shape, pixdim = native.load_volume_native(path, zero_centered=zero_centered)
    want, jshape, jpixdim = jax_codec.load_volume_native(path, zero_centered=zero_centered)
    assert got.dtype == np.float32 and shape == jshape == (9, 8, 5, 3) and pixdim == jpixdim
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,lo", [((7, 5, 4), 0.0), ((3, 6), -1.0), ((11,), 0.0), ((4, 3, 2, 5), -1.0)])
def test_make_coords_native_matches_jax_bitwise(jax_codec, shape, lo):
    got = native.make_coords_native(shape, lo=lo, hi=1.0)
    assert got.shape == (int(np.prod(shape)), len(shape)) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_codec.make_coords_native(shape, lo=lo, hi=1.0))


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=lambda d: np.dtype(d).name)
def test_save_volume_native_round_trip(tmp_path, jax_codec, dtype):
    """The port's encoder writes the bytes JAX's does; both decoders read
    them back to the data; numpy reads them too."""
    data = np.random.default_rng(3).standard_normal((6, 5, 4)).astype(dtype)
    mine, theirs = str(tmp_path / "port.nii.gz"), str(tmp_path / "jax.nii.gz")
    native.save_volume_native(mine, data, pixdim=(0.5, 0.25, 3.0))
    jax_codec.save_volume_native(theirs, data, pixdim=(0.5, 0.25, 3.0))
    with gzip.open(mine) as a, gzip.open(theirs) as b:
        assert a.read() == b.read()
    img = nifti.load(mine)
    np.testing.assert_array_equal(img.get_fdata(np.float32), data.astype(np.float32))
    assert img.pixdim[:3] == pytest.approx((0.5, 0.25, 3.0))
    got, _, _ = native.load_volume_native(mine)
    want, _, _ = jax_codec.load_volume_native(theirs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", DTYPES + [np.int8, np.uint16], ids=lambda d: np.dtype(d).name)
def test_load_volume_matches_jax_native_load_bitwise(tmp_path, jax_codec, dtype, zero_centered):
    """The port's ``load_volume()`` against JAX's with its codec built: the
    coordinates, values, shape and pixdim bit for bit. int8 and uint16 are
    datatypes neither codec decodes: both read them with numpy."""
    _, path = _volume(tmp_path, dtype)
    got = load_volume(path, zero_centered=zero_centered)
    want = jax_load_volume(path, zero_centered=zero_centered)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.shape == want.shape and got.pixdim == want.pixdim


def test_native_load_is_within_an_ulp_of_numpy(tmp_path):
    """The codec's normalisation scales by a reciprocal and its grid steps by
    a product: at most an ulp of the result (2^-24 below 1, 2^-23 on
    [-1, 1]) from numpy's division, and the slicing path is numpy's."""
    _, path = _volume(tmp_path, np.int16)
    for zero_centered, ulp in ((False, 2.0**-24), (True, 2.0**-23)):
        fast = load_volume(path, zero_centered=zero_centered)
        slow = load_volume(path, zero_centered=zero_centered, use_native=False)
        assert np.abs(fast.values - slow.values).max() <= ulp
        assert np.abs(fast.coords - slow.coords).max() <= ulp
    whole = load_volume(path, slice_axes=(slice(None), slice(None), 2))
    numpy_path = load_volume(path, slice_axes=(slice(None), slice(None), 2), use_native=False)
    np.testing.assert_array_equal(whole.values, numpy_path.values)


def test_unsupported_datatype_is_reported_not_decoded(tmp_path):
    _, path = _volume(tmp_path, np.uint16)
    with pytest.raises(native.UnsupportedLayout):
        native.load_volume_native(path)


def test_unreadable_file_raises(tmp_path):
    """A file the codec cannot read raises: ``load_volume`` takes numpy only
    for an unsupported datatype, so numpy is not asked either."""
    bad = str(tmp_path / "bad.nii")
    with open(bad, "wb") as f:
        f.write(struct.pack("<i", 540) + bytes(400))  # a NIfTI-2 header size
    with pytest.raises(ValueError, match="native probe failed"):
        native.load_volume_native(bad)
    with pytest.raises(ValueError, match="native probe failed"):
        load_volume(bad)
    with pytest.raises(ValueError, match="native probe failed"):
        native.load_volume_native(str(tmp_path / "absent.nii.gz"))


def test_build_is_atomic_and_raises_without_a_compiler(tmp_path, monkeypatch):
    """A build lands under its content-hashed name and leaves no temporary
    file; with no g++ it raises instead of falling back."""
    lib = native_build.build(build_dir=tmp_path / "b")
    assert lib == native_build.library_path(tmp_path / "b") and lib.exists()
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [lib.name]
    assert native_build.build(build_dir=tmp_path / "b") == lib  # built: nothing to do
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build(build_dir=tmp_path / "c")
    assert native_build.library_path().parent.name == "_build"


def test_build_directory_is_ignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "mri_interpolation_tpu_torch/native/_build/" in f.read().splitlines()
