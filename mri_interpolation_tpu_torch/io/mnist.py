"""2D digit datamodule for fast sanity runs (a copy of
``mri_interpolation_tpu/io/mnist.py``; numpy, gzip and struct).

A 28x28 2D stand-in so models validate in seconds without MRI data, with
three selection modes: "single" (the first digit matching a target),
"mean" (the average of all matching digits), "random" (all matching digits
stacked). It reads raw MNIST IDX files when they are present
(``train-images-idx3-ubyte`` and its labels, optionally .gz) and otherwise
synthesises deterministic digit-like 28x28 images, so tests and demos never
need a download.

Output convention: coords on a [-1, 1]^2 grid, intensity normalised to
[-1, 1].
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_idx", "mnist_digit_dataset", "synthetic_digit"]


def load_idx(path: str) -> np.ndarray:
    """Parse an IDX file (the raw MNIST format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dtype_code = (magic >> 8) & 0xFF
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
    shape = struct.unpack(f">{ndim}I", data[4 : 4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=np.dtype(dtypes[dtype_code]).newbyteorder(">"), offset=4 + 4 * ndim)
    return arr.reshape(shape)


def synthetic_digit(digit: int, seed: int = 0) -> np.ndarray:
    """Deterministic 28x28 digit-like image in [0, 1]: a thick parametric
    stroke unique per digit class. Stands in for MNIST when the dataset is
    absent."""
    rng = np.random.default_rng(seed * 10 + digit)
    t = np.linspace(0, 2 * np.pi, 200)
    # per-digit Lissajous-style stroke
    a, b = 1 + digit % 3, 1 + (digit * 7) % 4
    phase = digit * 0.7
    xs = 14 + 9 * np.sin(a * t + phase)
    ys = 14 + 9 * np.sin(b * t)
    img = np.zeros((28, 28), dtype=np.float32)
    for x, y in zip(xs, ys):
        xi, yi = int(round(x)), int(round(y))
        img[max(0, xi - 1) : xi + 2, max(0, yi - 1) : yi + 2] = 1.0
    img += 0.05 * rng.random((28, 28), dtype=np.float32)
    return np.clip(img, 0, 1)


def _load_digits(data_dir: Optional[str], targets: Sequence[int], limit: int = 256):
    """All images matching ``targets``: real MNIST if IDX files exist under
    data_dir, else synthetic."""
    if data_dir:
        for img_name, lbl_name in [
            ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
            ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        ]:
            ip, lp = os.path.join(data_dir, img_name), os.path.join(data_dir, lbl_name)
            if os.path.exists(ip) and os.path.exists(lp):
                images = load_idx(ip).astype(np.float32) / 255.0
                labels = load_idx(lp)
                sel = np.isin(labels, list(targets))
                return images[sel][:limit]
    return np.stack([synthetic_digit(t, seed=s) for t in targets for s in range(3)])[:limit]


def mnist_digit_dataset(
    targets: Sequence[int] = (2,),
    mode: str = "single",
    data_dir: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(coords, values) regression pairs for digit fitting.

    mode: "single": the first matching digit; "mean": the pixel-wise mean
    of all matching digits; "random": all matching digits stacked (coords
    tiled).
    """
    digits = _load_digits(data_dir, targets)
    if mode == "single":
        img = digits[0]
    elif mode == "mean":
        img = digits.mean(axis=0)
    elif mode == "random":
        img = None
    else:
        raise ValueError(f"unknown mode {mode!r}")

    x = np.linspace(-1, 1, 28, dtype=np.float32)
    grid = np.stack(np.meshgrid(x, x, indexing="ij"), axis=-1).reshape(-1, 2)

    if mode == "random":
        coords = np.tile(grid, (len(digits), 1))
        values = (digits.reshape(-1, 1) * 2.0 - 1.0).astype(np.float32)
    else:
        coords = grid
        values = (img.reshape(-1, 1) * 2.0 - 1.0).astype(np.float32)
    assert len(coords) == len(values)
    return coords, values
