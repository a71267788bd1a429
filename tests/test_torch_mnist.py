"""Port parity: the 28x28 digit datamodule (``io/mnist.py``, numpy, copied)
against the JAX package. Exact: the arrays are equal for synthetic digits
and for an IDX file (plain and gzipped) that the test writes."""

import gzip
import struct

import numpy as np
import pytest

from mri_interpolation_tpu.io import mnist as jmnist
from mri_interpolation_tpu_torch.io import mnist


def _write_idx(path, arr, code, gz):
    data = struct.pack(">I", (code << 8) | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    data += arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("digit", range(10))
def test_synthetic_digits_equal_jax(digit):
    for seed in (0, 3):
        np.testing.assert_array_equal(mnist.synthetic_digit(digit, seed), jmnist.synthetic_digit(digit, seed))


@pytest.mark.parametrize("mode", ["single", "mean", "random"])
@pytest.mark.parametrize("source", ["synthetic", "idx", "idx.gz"])
def test_dataset_equals_jax(tmp_path, mode, source):
    data_dir = None
    if source != "synthetic":
        rng = np.random.default_rng(1)
        gz = source.endswith(".gz")
        suffix = ".gz" if gz else ""
        _write_idx(tmp_path / f"train-images-idx3-ubyte{suffix}", rng.integers(0, 256, (40, 28, 28), dtype=np.uint8),
                   0x08, gz)
        _write_idx(tmp_path / f"train-labels-idx1-ubyte{suffix}", rng.integers(0, 10, 40, dtype=np.uint8), 0x08, gz)
        data_dir = str(tmp_path)
    got = mnist.mnist_digit_dataset((2, 7), mode=mode, data_dir=data_dir)
    want = jmnist.mnist_digit_dataset((2, 7), mode=mode, data_dir=data_dir)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_load_idx_reads_every_dtype(tmp_path):
    rng = np.random.default_rng(2)
    for code, dtype in ((0x08, np.uint8), (0x09, np.int8), (0x0B, np.int16), (0x0C, np.int32), (0x0D, np.float32),
                        (0x0E, np.float64)):
        arr = (rng.random((3, 4, 5)) * 100).astype(dtype)
        path = str(tmp_path / f"a{code}.idx")
        _write_idx(path, arr, code, False)
        np.testing.assert_array_equal(mnist.load_idx(path), arr)
        np.testing.assert_array_equal(mnist.load_idx(path), jmnist.load_idx(path))
