"""Volume -> (coordinates, intensities) dataset construction.

A copy of ``mri_interpolation_tpu/io/volume.py`` (numpy only) without its
``native`` fast path: the port imports nothing of the JAX package. The whole
normalized dataset is built once as numpy arrays; the trainer moves it to the
device in one copy and batches by on-device gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from . import nifti

__all__ = [
    "make_mgrid",
    "flat_coords",
    "normalize_intensity",
    "VoxelDataset",
    "load_volume",
    "dataset_from_array",
    "synthetic_volume",
]


def make_mgrid(shape: Sequence[int], lo: float = 0.0, hi: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Dense coordinate grid over ``shape``: linspace(lo, hi, s) per axis,
    'ij' indexing, stacked on the last axis. ``lo=-1`` gives the SIREN
    convention."""
    axes = [np.linspace(lo, hi, s, dtype=dtype) for s in shape]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def flat_coords(shape: Sequence[int], lo: float = 0.0, hi: float = 1.0, dtype=np.float32) -> np.ndarray:
    """(prod(shape), ndim) flattened coordinate matrix in C order."""
    return make_mgrid(shape, lo, hi, dtype).reshape(-1, len(tuple(shape)))


def normalize_intensity(values: np.ndarray, zero_centered: bool = False) -> np.ndarray:
    """Min-max normalize to [0,1], or [-1,1] when ``zero_centered``."""
    values = np.asarray(values, dtype=np.float32)
    vmin, vmax = values.min(), values.max()
    out = (values - vmin) / (vmax - vmin)
    if zero_centered:
        out = out * 2.0 - 1.0
    return out


@dataclass
class VoxelDataset:
    """Flattened (coords, values) pairs for one volume plus its metadata."""

    coords: np.ndarray  # (N, dim_in) float32
    values: np.ndarray  # (N, 1) float32
    shape: Tuple[int, ...]
    pixdim: Tuple[float, ...] = ()

    def __post_init__(self):
        if len(self.coords) != len(self.values):
            raise ValueError("coords/values length mismatch")

    @property
    def dim_in(self) -> int:
        return self.coords.shape[-1]

    def __len__(self) -> int:
        return len(self.values)

    def image(self) -> np.ndarray:
        """The normalized volume back in grid shape."""
        return self.values.reshape(self.shape)


def dataset_from_array(
    image: np.ndarray,
    zero_centered: bool = False,
    pixdim: Tuple[float, ...] = (),
) -> VoxelDataset:
    """Build the (coords, values) regression dataset from a dense array."""
    image = np.asarray(image, dtype=np.float32)
    lo = -1.0 if zero_centered else 0.0
    coords = flat_coords(image.shape, lo=lo, hi=1.0)
    values = normalize_intensity(image.reshape(-1), zero_centered=zero_centered)[:, None]
    return VoxelDataset(coords=coords, values=values, shape=tuple(image.shape), pixdim=pixdim)


def load_volume(
    path: str,
    zero_centered: bool = False,
    slice_axes: Optional[Tuple] = None,
) -> VoxelDataset:
    """Load a NIfTI file into a VoxelDataset. ``slice_axes`` is an optional
    tuple of slices applied to the raw volume before gridding, e.g.
    ``(slice(None), slice(None), 3, slice(None))`` for the (x, y, t) slice at
    z=3."""
    img = nifti.load(path)
    data = img.get_fdata(dtype=np.float32)
    if slice_axes is not None:
        data = data[slice_axes]
    return dataset_from_array(data, zero_centered=zero_centered, pixdim=img.pixdim)


def synthetic_volume(
    shape: Sequence[int] = (16, 16, 16),
    seed: int = 0,
    kind: str = "smooth",
) -> np.ndarray:
    """Deterministic synthetic test volumes. kind='smooth' is a band-limited
    signal every model family can fit in a few hundred steps; kind='random'
    is white noise."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(tuple(shape)).astype(np.float32)
    grid = make_mgrid(shape, 0.0, 1.0)
    phases = rng.uniform(0, 2 * np.pi, size=(3, grid.shape[-1]))
    freqs = rng.uniform(1.0, 3.0, size=(3, grid.shape[-1]))
    out = np.zeros(tuple(shape), dtype=np.float32)
    for k in range(3):
        out += np.prod(np.sin(2 * np.pi * freqs[k] * grid + phases[k]), axis=-1)
    return out.astype(np.float32)
