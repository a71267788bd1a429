"""ctypes bindings of the native IO runtime (``nifti_codec.cc``).

Port of ``mri_interpolation_tpu/native``: the same C ABI and entry points
(``available``, ``build``, ``load_volume_native``, ``save_volume_native``,
``make_coords_native``), built with the same g++ flags, so the two load a
file to the same bits. Unlike the JAX package, an entry point builds the
library at first use (``build.py``, into the gitignored ``native/_build/``)
and raises where it cannot: nothing falls back on its own. The one layout
question it answers instead of raising is :class:`UnsupportedLayout`: a
datatype the codec does not decode (int8, uint16, uint32, int64, uint64),
which ``io.volume.load_volume`` then reads with numpy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

# imported before ``build`` below is defined: importing the submodule sets the
# package's attribute ``build`` to it, once, and the function then takes the name
from . import build as _build_module

__all__ = ["UnsupportedLayout", "available", "build", "load_volume_native", "save_volume_native",
           "make_coords_native"]

_lib: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


class UnsupportedLayout(ValueError):
    """The file is a NIfTI-1 volume of a datatype the codec does not decode."""


def build(force: bool = False) -> str:
    """Compile the library (g++ -O3, zlib); returns its path. Raises on failure."""
    global _lib
    path = _build_module.build(force=force)
    _lib = None  # the next call loads what was built
    return str(path)


def available() -> bool:
    """Whether the library of the current source is built (nothing is built here)."""
    return _lib is not None or _build_module.library_path().exists()


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.mit_nifti_probe.restype = ctypes.c_int64
        lib.mit_nifti_probe.argtypes = [ctypes.c_char_p, _I64P, ctypes.POINTER(ctypes.c_int), _F32P]
        lib.mit_nifti_decode.restype = ctypes.c_int
        lib.mit_nifti_decode.argtypes = [ctypes.c_char_p, _F32P]
        lib.mit_nifti_encode.restype = ctypes.c_int
        lib.mit_nifti_encode.argtypes = [ctypes.c_char_p, _F32P, _I64P, ctypes.c_int, _F32P]
        lib.mit_minmax_normalize.restype = None
        lib.mit_minmax_normalize.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int]
        lib.mit_make_coords.restype = None
        lib.mit_make_coords.argtypes = [_I64P, ctypes.c_int, ctypes.c_float, ctypes.c_float, _F32P]
        _lib = lib
    return _lib


def load_volume_native(path: str, zero_centered: bool = False
                       ) -> Tuple[np.ndarray, Tuple[int, ...], Tuple[float, ...]]:
    """Decode and min-max normalise a NIfTI-1 volume (``.nii`` or
    ``.nii.gz``): (C-order float32 array, shape, pixdim). Raises
    :class:`UnsupportedLayout` for a datatype the codec does not decode and
    ValueError for a file it cannot read."""
    lib = _load()
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    pixdim = (ctypes.c_float * 8)()
    n = lib.mit_nifti_probe(path.encode(), shape, ctypes.byref(ndim), pixdim)
    if n == -2:
        raise UnsupportedLayout(f"{path}: a NIfTI-1 datatype that the native codec does not decode")
    if n < 0:
        raise ValueError(f"native probe failed for {path}")
    out = np.empty(n, dtype=np.float32)
    rc = lib.mit_nifti_decode(path.encode(), out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"native decode failed (code {rc}) for {path}")
    lib.mit_minmax_normalize(out.ctypes.data_as(_F32P), n, int(zero_centered))
    shp = tuple(int(shape[i]) for i in range(ndim.value))
    pd = tuple(float(pixdim[i]) for i in range(ndim.value))
    return out.reshape(shp), shp, pd


def save_volume_native(path: str, data: np.ndarray, pixdim: Optional[Sequence[float]] = None) -> None:
    """Encode a C-ordered array as gzipped float32 NIfTI-1 (identity
    orientation, vox_offset 352)."""
    lib = _load()
    arr = np.ascontiguousarray(data, dtype=np.float32)
    d = arr.ndim
    shape = (ctypes.c_int64 * d)(*arr.shape)
    pd_vals = tuple(pixdim) if pixdim else tuple(1.0 for _ in range(d))
    pd = (ctypes.c_float * d)(*(list(pd_vals) + [1.0] * d)[:d])
    rc = lib.mit_nifti_encode(path.encode(), arr.ctypes.data_as(_F32P), shape, d, pd)
    if rc != 0:
        raise ValueError(f"native encode failed (code {rc}) for {path}")


def make_coords_native(shape: Sequence[int], lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """The (prod(shape), ndim) float32 C-order coordinate grid, axis k
    ``lo + (hi - lo) / (s_k - 1) * i``."""
    lib = _load()
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    out = np.empty((int(np.prod(shape)), d), dtype=np.float32)
    lib.mit_make_coords((ctypes.c_int64 * d)(*shape), d, lo, hi, out.ctypes.data_as(_F32P))
    return out
