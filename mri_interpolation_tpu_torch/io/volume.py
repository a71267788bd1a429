"""Volume -> (coordinates, intensities) dataset construction.

A copy of ``mri_interpolation_tpu/io/volume.py``: whole-volume loads go
through the port's own native codec (``mri_interpolation_tpu_torch.native``,
as the JAX package's do), the rest through numpy. The whole normalized
dataset is built once as numpy arrays; the trainer moves it to the device
in one copy and batches by on-device gathers.
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
    "even_frame_split",
    "even_frame_training_set",
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
    use_native: bool = True,
) -> VoxelDataset:
    """Load a NIfTI file into a VoxelDataset. ``slice_axes`` is an optional
    tuple of slices applied to the raw volume before gridding, e.g.
    ``(slice(None), slice(None), 3, slice(None))`` for the (x, y, t) slice at
    z=3.

    A whole-volume load goes through the native codec (decode, normalise and
    coordinates in C++, built with g++ at first use), as the JAX package's
    does when its codec is built: the two agree bit for bit, and differ from
    numpy's by an ulp (the codec scales by a reciprocal and steps its grid by
    a product). Slicing or ``use_native=False`` takes numpy, and so does a
    datatype the codec does not decode (``native.UnsupportedLayout``: int8,
    uint16, uint32, int64, uint64). Unlike the JAX package, no other error is
    swallowed: a missing compiler or a failed build raises."""
    if use_native and slice_axes is None:
        from .. import native

        try:
            data, shape, pixdim = native.load_volume_native(path, zero_centered=zero_centered)
        except native.UnsupportedLayout:
            pass
        else:
            coords = native.make_coords_native(shape, lo=-1.0 if zero_centered else 0.0, hi=1.0)
            return VoxelDataset(coords=coords, values=data.reshape(-1, 1), shape=shape, pixdim=pixdim)
    img = nifti.load(path)
    data = img.get_fdata(dtype=np.float32)
    if slice_axes is not None:
        data = data[slice_axes]
    return dataset_from_array(data, zero_centered=zero_centered, pixdim=img.pixdim)


def even_frame_split(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a (..., T) volume into (even frames, odd frames) along time:
    the interpolation-quality protocol trains on ``image[..., ::2]`` and
    scores the held-out ``image[..., 1::2]``."""
    return image[..., ::2], image[..., 1::2]


def even_frame_training_set(image: np.ndarray, zero_centered: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(coords, values) of the even frames of ``image`` (time last): the
    coordinates of ``image[..., ::2]``'s own grid with the time axis remapped
    by ``2 (t_even - 1) / (t_full - 1)``, so that even frame k sits at frame
    2k of the whole volume; float32 in the JAX package's order of
    operations."""
    train_img, _ = even_frame_split(image)
    lo = -1.0 if zero_centered else 0.0
    coords = flat_coords(train_img.shape, lo=lo)
    scale = 2.0 * (train_img.shape[-1] - 1) / max(image.shape[-1] - 1, 1)
    coords[:, -1] = lo + (coords[:, -1] - lo) * scale
    return coords, train_img.reshape(-1, 1)


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
