"""Imaging utilities (port of ``mri_interpolation_tpu/utils/imaging.py``):
the undersampling mask, the PSF kernel and its application, and the
mid-slice viewers.

- ``create_rn_mask``: a random undersampling mask, drawn from a
  ``torch.Generator`` in place of a JAX key;
- ``psf_kernel``: the normalised separable Gaussian PSF, numpy, as the JAX
  package computes it; ``apply_psf``: its convolution with a volume, edges
  replicated (scipy's ``mode="nearest"``), as a torch convolution on the
  caller's device;
- ``show_slices``, ``show``, ``tensor_visualisation``: the viewers. The
  JAX package draws them with matplotlib; here each panel is a tile of the
  image (transposed, row 0 at the bottom as ``origin="lower"`` draws it;
  gray min-max over the tile for the first two, viewer's viridis for the
  third) in a row with 4-pixel white gutters, written through
  ``io/png.py`` when ``save_path`` is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io import png

__all__ = ["create_rn_mask", "psf_kernel", "apply_psf", "show_slices", "show", "tensor_visualisation"]


def create_rn_mask(shape: Sequence[int], percentage: float, key: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Random undersampling mask keeping each voxel with probability
    ``percentage / 100``, drawn on the CPU from
    ``torch.Generator().manual_seed(key)``. Returns (mask float32 of {0, 1}
    and ``shape``, the flat indices of the kept voxels). One seed gives one
    mask; it is not JAX's ``bernoulli`` draw for the same seed."""
    shape = tuple(int(s) for s in shape)
    gen = torch.Generator().manual_seed(int(key))
    mask = (torch.rand(shape, generator=gen, dtype=torch.float64) < percentage * 0.01).numpy().astype(np.float32)
    return mask, np.flatnonzero(mask.reshape(-1))


def psf_kernel(dim: int = 2, n_samples: int = 5, sigma: float = 1.0 / 2.3548) -> np.ndarray:
    """Normalised separable Gaussian PSF on linspace(-0.5, 0.5, n)^dim."""
    unit = np.linspace(-0.5, 0.5, n_samples)
    grids = np.meshgrid(*([unit] * dim), indexing="ij")
    psf = np.ones_like(grids[0])
    for g in grids:
        psf = psf * np.exp(-g * g / (2 * sigma * sigma))
    return (psf / psf.sum()).astype(np.float32)


def apply_psf(values: np.ndarray, kernel: np.ndarray, image_shape: Sequence[int],
              device: DeviceLike = None) -> np.ndarray:
    """Convolve a flat intensity vector (reshaped to ``image_shape``, 2-D
    or 3-D as the kernel) with ``kernel``, edges replicated, on ``device``
    (``cuda`` unless "cpu"); returns the flattened result, (N, 1) float32."""
    import torch.nn.functional as F

    dev = resolve_device(device)
    image_shape = tuple(int(s) for s in image_shape)
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=dev)
    image = torch.as_tensor(np.asarray(values, np.float32), device=dev).reshape(image_shape)
    pad = [p for s in reversed(k.shape) for p in (s // 2, s // 2)]
    padded = F.pad(image[None, None], pad, mode="replicate")
    conv = F.conv2d if k.ndim == 2 else F.conv3d
    out = conv(padded, torch.flip(k, dims=tuple(range(k.ndim)))[None, None])[0, 0]
    return out.reshape(-1, 1).cpu().numpy()


def _mid_slices(data: np.ndarray):
    xm, ym, zm = (s // 2 for s in data.shape[:3])
    return [data[xm, :, :], data[:, ym, :], data[:, :, zm]]


def _row(tiles, rgb: bool = False) -> np.ndarray:
    """Tiles side by side, top-aligned, with 4-pixel white gutters."""
    g = 4
    h = max(t.shape[0] for t in tiles)
    w = sum(t.shape[1] for t in tiles) + g * (len(tiles) + 1)
    out = np.full((h + 2 * g, w) + ((3,) if rgb else ()), 255, np.uint8)
    x = g
    for t in tiles:
        out[g:g + t.shape[0], x:x + t.shape[1]] = t
        x += t.shape[1] + g
    return out


def _gray_tile(sl: np.ndarray) -> np.ndarray:
    return png.colorize(sl.T[::-1], png.GRAY)


def show_slices(image, save_path: Optional[str] = None) -> np.ndarray:
    """The three orthogonal mid-slices of a 3-D array or NiftiImage, gray;
    returns the image (uint8), written as PNG to ``save_path`` if given."""
    from ..io.nifti import NiftiImage

    if isinstance(image, NiftiImage):
        data = np.asarray(image.get_fdata(np.float32)).reshape(image.shape[0:3])
    else:
        data = np.asarray(image)
    out = _row([_gray_tile(sl) for sl in _mid_slices(data)], rgb=True)
    if save_path:
        png.write_png(save_path, out)
    return out


def show(array: np.ndarray, save_path: Optional[str] = None) -> np.ndarray:
    """A 2-D array, or a 3-D one's three mid-slices, gray (the real part of
    a complex array); returns the image, written to ``save_path`` if given."""
    array = np.asarray(array)
    if np.iscomplexobj(array):
        array = array.real
    if array.ndim == 2:
        out = _row([_gray_tile(array)], rgb=True)
    elif array.ndim == 3:
        out = _row([_gray_tile(sl) for sl in _mid_slices(array)], rgb=True)
    else:
        raise ValueError(f"show() supports 2D/3D arrays, got {array.ndim}D")
    if save_path:
        png.write_png(save_path, out)
    return out


def tensor_visualisation(tensor: np.ndarray, save_path: str = "debug.png") -> str:
    """A (n, h, w) stack as a row of viridis tiles in a PNG; returns the path."""
    tensor = np.asarray(tensor)
    png.write_png(save_path, _row([png.colorize(sl.T[::-1]) for sl in tensor], rgb=True))
    return save_path
