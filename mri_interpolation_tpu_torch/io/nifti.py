"""Minimal, dependency-free NIfTI-1 reader/writer.

The reference uses ``nibabel`` for all volume IO (reference:
``datamodules.py:135-138``, ``launcher.py:189``). nibabel is not part of this
environment, so we implement the tiny subset of NIfTI-1 the framework needs in
pure NumPy: header parse, scaled float decode, Fortran-order data layout, and
gzip transparently by file magic.

This is a copy of ``mri_interpolation_tpu/io/nifti.py`` (the port imports
nothing of the JAX package); the two are held equal by the port's tests.

NIfTI-1 layout (348-byte header, little-endian here):
  offset 0   int32   sizeof_hdr (must be 348)
  offset 40  int16*8 dim        (dim[0]=ndim, dim[1..7]=shape)
  offset 70  int16   datatype
  offset 72  int16   bitpix
  offset 76  float*8 pixdim
  offset 108 float32 vox_offset
  offset 112 float32 scl_slope
  offset 116 float32 scl_inter
  offset 344 char*4  magic ("n+1\\0" single-file)
"""

from __future__ import annotations

import gzip
import io as _io
import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["NiftiImage", "load", "save", "nifti_bytes", "from_bytes"]

# NIfTI-1 datatype codes -> numpy dtypes.
_DTYPES = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
    1280: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"


@dataclass
class NiftiImage:
    """In-memory NIfTI volume: raw data + the header fields we preserve."""

    dataobj: np.ndarray
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    pixdim: Tuple[float, ...] = ()
    scl_slope: float = 0.0
    scl_inter: float = 0.0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.dataobj.shape)

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """Scaled float data, mirroring nibabel's get_fdata semantics."""
        out = np.asarray(self.dataobj, dtype=dtype)
        # NIfTI: slope == 0 means "no scaling stored" — both slope AND inter
        # are ignored then (nibabel semantics; matches mri_interpolation_tpu/native/nifti_codec.cc).
        if self.scl_slope != 0.0 and (self.scl_slope != 1.0 or self.scl_inter != 0.0):
            out = out * dtype(self.scl_slope) + dtype(self.scl_inter)
        return out


def _parse_header(hdr: bytes):
    if len(hdr) < _HDR_SIZE:
        raise ValueError(f"NIfTI header truncated: {len(hdr)} bytes")
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    if sizeof_hdr != _HDR_SIZE:
        raise ValueError(f"not a little-endian NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", hdr, 40)
    (datatype, bitpix) = struct.unpack_from("<2h", hdr, 70)
    pixdim = struct.unpack_from("<8f", hdr, 76)
    (vox_offset,) = struct.unpack_from("<f", hdr, 108)
    (scl_slope, scl_inter) = struct.unpack_from("<2f", hdr, 112)
    # sform affine (srow_x/y/z at 280/296/312), falls back to identity.
    srow = np.frombuffer(hdr[280:328], dtype="<f4").reshape(3, 4)
    affine = np.eye(4, dtype=np.float64)
    if np.any(srow != 0):
        affine[:3, :] = srow
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    return shape, _DTYPES[datatype], pixdim[1 : 1 + ndim], int(vox_offset), scl_slope, scl_inter, affine


def from_bytes(raw: bytes) -> NiftiImage:
    """Decode a (possibly gzipped) NIfTI-1 byte string."""
    if raw[:2] == b"\x1f\x8b":  # gzip magic
        raw = gzip.decompress(raw)
    shape, dtype, pixdim, vox_offset, slope, inter, affine = _parse_header(raw)
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype.newbyteorder("<"), count=n, offset=max(vox_offset, _HDR_SIZE + 4))
    # NIfTI stores data Fortran-ordered (first axis fastest).
    data = data.reshape(shape, order="F")
    return NiftiImage(
        dataobj=data,
        affine=affine,
        pixdim=tuple(float(p) for p in pixdim),
        scl_slope=float(slope),
        scl_inter=float(inter),
    )


def load(path: str) -> NiftiImage:
    """Load a .nii or .nii.gz file (parity: nibabel.load at datamodules.py:135)."""
    with open(path, "rb") as f:
        raw = f.read()
    return from_bytes(raw)


def peek_shape(path: str) -> tuple:
    """Volume shape from the header alone — no voxel IO. For gzipped files
    only the first deflate blocks are decompressed (the header is at the
    front), so peeking a multi-GB archive is O(KB). Used by the capacity
    planner (`--plan`), which must not pay a full load to size a run."""
    with open(path, "rb") as f:
        head = f.read(_HDR_SIZE + 4)
        if head[:2] == b"\x1f\x8b":
            f.seek(0)
            with gzip.GzipFile(fileobj=f) as g:
                head = g.read(_HDR_SIZE + 4)
    shape, *_ = _parse_header(head)
    return tuple(int(s) for s in shape)


def load_memmap(path: str) -> NiftiImage:
    """Memory-mapped NIfTI: the returned image's ``dataobj`` is a read-only
    ``np.memmap`` (Fortran-ordered, NIfTI's on-disk layout) — voxels are read
    from disk on access, so a volume far larger than host RAM can feed
    ``Trainer.fit_streaming`` directly. Uncompressed ``.nii`` only (gzip
    streams cannot be mapped); raises with a pointer to ``load`` otherwise.

    Intensity scaling note: min-max normalization (the framework's default,
    io.normalize_intensity) is invariant under the header's affine
    scl_slope/inter scaling, so streaming the RAW dataobj with
    ``value_range=None`` matches streaming ``get_fdata()``.
    """
    with open(path, "rb") as f:
        head = f.read(_HDR_SIZE + 4)
    if head[:2] == b"\x1f\x8b":
        raise ValueError(
            f"{path!r} is gzip-compressed; a gzip stream cannot be "
            f"memory-mapped — decompress to .nii first or use load()")
    shape, dtype, pixdim, vox_offset, slope, inter, affine = _parse_header(head)
    mm = np.memmap(path, dtype=dtype.newbyteorder("<"), mode="r",
                   offset=max(vox_offset, _HDR_SIZE + 4),
                   shape=tuple(shape), order="F")
    return NiftiImage(
        dataobj=mm,
        affine=affine,
        pixdim=tuple(float(p) for p in pixdim),
        scl_slope=float(slope),
        scl_inter=float(inter),
    )


def nifti_bytes(
    data: np.ndarray,
    affine: Optional[np.ndarray] = None,
    pixdim: Optional[Sequence[float]] = None,
) -> bytes:
    """Serialize an array to single-file NIfTI-1 bytes (uncompressed)."""
    data = np.asarray(data)
    if data.ndim > 7:
        raise ValueError("NIfTI supports at most 7 dimensions")
    dtype = np.dtype(data.dtype).newbyteorder("=")
    base = np.dtype(dtype.base.str.lstrip("<>=|"))
    if base not in _DTYPE_CODES:
        # Fall back to float32 for exotic dtypes (e.g. float16, bool).
        data = data.astype(np.float32)
        base = np.dtype(np.float32)
    code = _DTYPE_CODES[base]
    bitpix = base.itemsize * 8

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, bitpix)
    pd = [1.0] * 8
    if pixdim is not None:
        for i, p in enumerate(pixdim[:7]):
            pd[i + 1] = float(p)
    struct.pack_into("<8f", hdr, 76, *pd)
    vox_offset = float(_HDR_SIZE + 4)
    struct.pack_into("<f", hdr, 108, vox_offset)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    # qform/sform codes: use sform=1 with the provided affine.
    struct.pack_into("<2h", hdr, 252, 0, 1)
    aff = np.eye(4, dtype=np.float64) if affine is None else np.asarray(affine, dtype=np.float64)
    hdr[280:328] = aff[:3, :].astype("<f4").tobytes()
    hdr[344:348] = _MAGIC_SINGLE

    buf = _io.BytesIO()
    buf.write(bytes(hdr))
    buf.write(b"\x00\x00\x00\x00")  # extension flag
    buf.write(np.asarray(data, dtype=base).tobytes(order="F"))
    return buf.getvalue()


def save(
    data: np.ndarray,
    path: str,
    affine: Optional[np.ndarray] = None,
    pixdim: Optional[Sequence[float]] = None,
) -> None:
    """Save array to .nii / .nii.gz (parity: nib.save at launcher.py:189)."""
    raw = nifti_bytes(data, affine=affine, pixdim=pixdim)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=4) as f:
            f.write(raw)
    else:
        with open(path, "wb") as f:
            f.write(raw)
