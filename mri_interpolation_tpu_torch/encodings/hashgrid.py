"""Multiresolution hash-grid encoding geometry (Instant-NGP family).

Port of ``mri_interpolation_tpu/encodings/hashgrid.py``: the same per-level
geometry (resolutions, dense/hashed switch, sizes, offsets into ONE fused
``(total_size, F)`` table), the same initialisation range and the same corner
enumeration. The encode itself (gather + multilinear sum, and its table
gradient) lives in ``ops/hash_encode.py``: a CUDA kernel pair on the card,
the plain PyTorch version built on :meth:`HashGridEncoding.corner_ids_and_weights`
on the CPU.

Semantics kept from the reference:

- the cell index is the TRUNCATED scaled coordinate (``astype(int32)``);
- dense levels clamp the cell index to ``res - 1`` (at x == 1.0 the weight
  moves onto the far corner: same value, always in bounds);
- dense rows are row-major over the level's VERTEX grid (strides of res+1);
- hashed rows are tcnn's spatial hash: per-dim uint32 prime multiply, XOR
  fold, modulo the level size. Here it runs in int64 masked to 32 bits,
  because torch's CPU ``%`` is not implemented for uint32.

``apply_grid`` encodes a regular axis-aligned grid of an all-dense encoding
one axis at a time (two slab gathers and a lerp per axis), in plain tensor
code as the JAX original is plain XLA; ``infer/grid.py`` dispatches to it.

``level_cellview`` marks the JAX package's cell-view levels (dense, at most
``CELL_VIEW_MAX_CELLS`` cells): the only ones whose corner weights carry a
gradient to the coordinates (``ops.hash_encode.hash_encode_coord_grad``).

``temporal_table_tv`` is the time-axis smoothness prior of the HashMLP's
``temporal_tv`` option, in plain tensor code (the JAX package has no kernel
for it either).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["HashGridEncoding", "PRIMES", "LEVEL_CONST_WIDTH", "CELL_VIEW_MAX_CELLS", "temporal_table_tv"]

# Hash primes (up to 7-D input), tcnn grid.h constants.
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)

_MASK32 = 0xFFFFFFFF

_STORAGE_CODES = {"auto": 0, "hashed": 1, "dense": 2}

# int32 words per level in the kernels' constant block (ops/csrc/hash_encode.cu
# struct Level): res[4], vertex strides[4], size, offset, dense, source (the
# coarse kernels' first row of the level in the fused table; 0 here).
LEVEL_CONST_WIDTH = 12

# the JAX HashGridEncoding's default cell_view_max_cells: dense levels of at most this many cells
# take its cell-view path (the others its packed path, which gives the coordinates no gradient)
CELL_VIEW_MAX_CELLS = 1 << 18


def _level_geometry(
    dim: int,
    n_levels: int,
    log2_hashmap_size: int,
    base_resolution: Union[int, Sequence[int]],
    finest_resolution: Union[int, Sequence[int], None],
    per_level_scale: Union[float, None],
    growth: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-level (resolutions, hashmap sizes), as in the reference."""
    isotropic = isinstance(base_resolution, (int, float))
    base = np.full(dim, base_resolution, dtype=np.float64) if isotropic else np.asarray(base_resolution, np.float64)
    if not isotropic and len(base) != dim:
        raise ValueError(f"base_resolution has {len(base)} axes but dim={dim}")

    if per_level_scale is not None:
        b = np.full(dim, float(per_level_scale))
    else:
        if finest_resolution is None:
            raise ValueError("need finest_resolution or per_level_scale")
        fine = (
            np.full(dim, finest_resolution, dtype=np.float64)
            if isinstance(finest_resolution, (int, float))
            else np.asarray(finest_resolution, np.float64)
        )
        if growth == "reference":
            denom = base - 1.0  # the reference divides by (base_resolution - 1)
        elif growth == "paper":
            denom = np.full(dim, max(n_levels - 1, 1), dtype=np.float64)  # Instant-NGP eq. (3)
        else:
            raise ValueError(f"unknown growth {growth!r}")
        b = np.exp((np.log(fine) - np.log(base)) / denom)

    res = np.stack([np.floor(base * b**lvl) for lvl in range(n_levels)]).astype(np.int64)  # (L, d)
    if isotropic:
        sizes = np.minimum(res[:, 0].astype(object) ** dim, 2**log2_hashmap_size)
    else:
        sizes = np.minimum(res.max(axis=1).astype(object) ** dim, 2**log2_hashmap_size)
    return res.astype(np.int32), sizes.astype(np.int64)


class HashGridEncoding:
    """Geometry of a multiresolution hash grid with one fused table.

    ``storage``: ``"auto"`` stores a level dense when its whole vertex grid
    fits the 2^log2 budget (tcnn's switch), else hashed; ``"hashed"`` hashes
    every level; ``"dense"`` forces dense and raises if a level exceeds the
    budget.
    """

    def __init__(
        self,
        dim: int,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 15,
        base_resolution: Union[int, Sequence[int]] = 16,
        finest_resolution: Union[int, Sequence[int], None] = 512,
        per_level_scale: Union[float, None] = None,
        growth: str = "reference",
        init_scale: float = 1e-4,
        storage: str = "auto",
    ):
        if dim > len(PRIMES):
            raise ValueError(f"hash grid supports at most {len(PRIMES)}-D inputs, got {dim}")
        if storage not in ("auto", "hashed", "dense"):
            raise ValueError(f"unknown storage {storage!r}")
        self.input_dim = dim
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.output_dim = n_levels * n_features_per_level
        self.init_scale = init_scale
        self.storage = storage

        res, sizes = _level_geometry(
            dim, n_levels, log2_hashmap_size, base_resolution, finest_resolution, per_level_scale, growth
        )
        self._set_levels(res, sizes, isinstance(base_resolution, (int, float)))

    def _set_levels(self, res: np.ndarray, sizes: np.ndarray, isotropic: bool) -> None:
        """The per-level tables from the resolutions (L, d) and the hashed
        levels' sizes, and the key that :meth:`from_key` rebuilds them from."""
        budget = 2**self.log2_hashmap_size
        n_levels = res.shape[0]
        self.level_resolutions = res  # (L, d) int32
        vertex_counts = np.prod(res.astype(np.int64) + 1, axis=1)
        if self.storage == "hashed":
            dense = np.zeros(n_levels, dtype=bool)
        elif self.storage == "dense":
            if (vertex_counts > budget).any():
                raise ValueError(
                    f"storage='dense' but some level's vertex grid exceeds the 2^{self.log2_hashmap_size} "
                    f"budget: {vertex_counts}"
                )
            dense = np.ones(n_levels, dtype=bool)
        else:
            dense = vertex_counts <= budget
        self.level_dense = dense  # (L,) bool
        self.level_sizes = np.where(dense, vertex_counts, sizes).astype(np.int64)
        self.level_offsets = np.concatenate([[0], np.cumsum(self.level_sizes)]).astype(np.int64)
        self.total_size = int(self.level_offsets[-1])
        # the JAX package's cell-view levels: dense with at most CELL_VIEW_MAX_CELLS cells. There
        # the coordinates' gradient flows through the corner weights; elsewhere it is zero.
        cell_counts = np.prod(res.astype(np.int64), axis=1)
        self.level_cellview = dense & (cell_counts <= CELL_VIEW_MAX_CELLS)  # (L,) bool
        self.kernel_constants = self.level_constants()  # host block for the CUDA kernels
        self._key = (self.input_dim, self.n_features_per_level, self.log2_hashmap_size,
                     _STORAGE_CODES[self.storage], int(isotropic), *(int(r) for r in res.ravel()))

    def geometry_key(self) -> Tuple[int, ...]:
        """The geometry as ints, the kernels' ops' ``int[] geometry``
        argument: dim, F, log2_hashmap_size, the storage code, whether a
        hashed level's size counts its first axis (an isotropic base
        resolution) or its largest, then the (L, d) level resolutions row by
        row. :meth:`from_key` rebuilds an equal geometry from it."""
        return self._key

    @staticmethod
    def from_key(key: Sequence[int]) -> "HashGridEncoding":
        """The geometry of :meth:`geometry_key` ``key`` (cached: one object a
        key). Its ``init_scale`` is the default: a key carries no table."""
        return _encoding_from_key(tuple(key))

    def init(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The fused table, U(-init_scale, init_scale), drawn on the CPU so one
        seed gives one table whatever device it then moves to."""
        table = torch.empty((self.total_size, self.n_features_per_level), dtype=torch.float32)
        return table.uniform_(-self.init_scale, self.init_scale, generator=generator)

    def vertex_strides(self, level: int) -> np.ndarray:
        """Row-major strides over the level's VERTEX grid (res + 1 per axis)."""
        verts = self.level_resolutions[level].astype(np.int64) + 1
        return np.concatenate([np.cumprod(verts[::-1])[::-1][1:], [1]])

    def level_constants(self) -> np.ndarray:
        """(L, LEVEL_CONST_WIDTH) int32 block the CUDA kernels read per level:
        res, vertex strides (zero-padded to 4 axes), size (as uint32 bits),
        offset, dense flag."""
        out = np.zeros((self.n_levels, LEVEL_CONST_WIDTH), dtype=np.int64)
        d = self.input_dim
        for l in range(self.n_levels):
            out[l, 0:d] = self.level_resolutions[l]
            out[l, 4 : 4 + d] = self.vertex_strides(l)
            out[l, 8] = self.level_sizes[l]
            out[l, 9] = self.level_offsets[l]
            out[l, 10] = int(self.level_dense[l])
        return (out & _MASK32).astype(np.uint32).view(np.int32)

    def supports_grid_path(self) -> bool:
        """True when every level is dense: the separable regular-grid
        evaluation (:meth:`apply_grid`) covers the whole encoding."""
        return bool(self.level_dense.all())

    def apply_grid(self, table: torch.Tensor, out_shape: Sequence[int], lo: float = 0.0,
                   hi: float = 1.0) -> torch.Tensor:
        """Encode the regular grid ``linspace(lo, hi, s)`` per axis of
        ``out_shape``: (prod(out_shape), L*F) in logical level order, row r
        the encoding of row r of ``infer.flat_index_to_coords``.

        Multilinear interpolation on a regular grid is separable: each dense
        level's vertex grid (its rows viewed as the C-ordered ``(verts..., F)``
        array, which :meth:`vertex_strides` describes) is resampled one axis
        at a time, with the per-point arithmetic of
        :meth:`corner_ids_and_weights`: ``scaled = x * res``, the cell index
        its truncation clamped to ``[0, res - 1]``, the weight ``scaled - xi``.
        Needs all-dense storage (:meth:`supports_grid_path`)."""
        if not self.supports_grid_path():
            raise ValueError("apply_grid requires all-dense storage")
        d, F = self.input_dim, self.n_features_per_level
        out_shape = tuple(int(s) for s in out_shape)
        if len(out_shape) != d:
            raise ValueError(f"grid rank {len(out_shape)} != encoder dim {d}")
        n = int(np.prod(out_shape))
        feats = []
        for l in range(self.n_levels):
            res = self.level_resolutions[l]
            verts = tuple(int(r) + 1 for r in res)
            g = table[int(self.level_offsets[l]):int(self.level_offsets[l + 1])].reshape(*verts, F)
            for k in range(d):
                denom = max(out_shape[k] - 1, 1)
                x = lo + (hi - lo) * (torch.arange(out_shape[k], dtype=torch.float32, device=table.device) / denom)
                scaled = x * float(res[k])
                xi = torch.clamp(scaled.to(torch.int32), 0, int(res[k]) - 1)
                w = (scaled - xi.to(torch.float32)).reshape([out_shape[k] if j == k else 1 for j in range(d + 1)])
                xi = xi.to(torch.int64)
                g = torch.index_select(g, k, xi) * (1.0 - w) + torch.index_select(g, k, xi + 1) * w
            feats.append(g.reshape(n, F))
        return torch.cat(feats, dim=-1)

    def level_cells(self, xs: Sequence[torch.Tensor], level: int) -> Tuple[list, list]:
        """Per axis k of ``xs`` (d tensors (N,)): the cell index (int64; the
        truncated ``x * res``, clamped to [0, res - 1] on a dense level) and
        the fraction ``x * res - index`` (float32)."""
        res = self.level_resolutions[level]
        scaled = [x * float(res[k]) for k, x in enumerate(xs)]
        xi = [s.to(torch.int32) for s in scaled]  # truncation, as astype(int32)
        if self.level_dense[level]:
            xi = [torch.clamp(i, 0, int(res[k]) - 1) for k, i in enumerate(xi)]
        xf = [s - i.to(torch.float32) for s, i in zip(scaled, xi)]
        return [i.to(torch.int64) for i in xi], xf

    def corner_ids_and_weights(self, x: torch.Tensor, levels: Optional[Sequence[int]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global table rows and multilinear weights of every corner.

        x: (N, d) float32, in [0, 1] as a rule (outside it, dense levels clamp
        the cell index and the weights extrapolate). Returns (ids int64,
        weights float32), each (N, L, 2^d), over ``levels`` (default: all, in
        order) as L; corner c takes xi + 1 on the axes whose bit is set.
        """
        d, C = self.input_dim, 1 << self.input_dim
        xs = [x[:, k] for k in range(d)]
        ids_levels, w_levels = [], []
        for l in (range(self.n_levels) if levels is None else levels):
            dense = bool(self.level_dense[l])
            xi, xf = self.level_cells(xs, l)
            ids_c, w_c = [], []
            for c in range(C):
                w = None
                for k in range(d):
                    f = xf[k] if (c >> k) & 1 else 1.0 - xf[k]
                    w = f if w is None else w * f
                w_c.append(w)
                if dense:
                    vstr = self.vertex_strides(l)
                    idx = None
                    for k in range(d):
                        t = (xi[k] + ((c >> k) & 1)) * int(vstr[k])
                        idx = t if idx is None else idx + t
                else:
                    h = None
                    for k in range(d):
                        t = (((xi[k] + ((c >> k) & 1)) & _MASK32) * PRIMES[k]) & _MASK32
                        h = t if h is None else h ^ t
                    idx = h % int(self.level_sizes[l])
                ids_c.append(idx + int(self.level_offsets[l]))
            ids_levels.append(torch.stack(ids_c, dim=-1))
            w_levels.append(torch.stack(w_c, dim=-1))
        return torch.stack(ids_levels, dim=1), torch.stack(w_levels, dim=1)


@functools.lru_cache(maxsize=None)
def _encoding_from_key(key: Tuple[int, ...]) -> HashGridEncoding:
    dim, F, log2, storage, isotropic = key[:5]
    res = np.asarray(key[5:], dtype=np.int64).reshape(-1, dim)
    basis = res[:, 0] if isotropic else res.max(axis=1)
    sizes = np.minimum(basis.astype(object) ** dim, 2**log2).astype(np.int64)
    enc = HashGridEncoding.__new__(HashGridEncoding)
    enc.input_dim, enc.n_levels, enc.n_features_per_level, enc.log2_hashmap_size = dim, res.shape[0], F, log2
    enc.output_dim, enc.init_scale = res.shape[0] * F, 1e-4
    enc.storage = {code: name for name, code in _STORAGE_CODES.items()}[storage]
    enc._set_levels(res.astype(np.int32), sizes, bool(isotropic))
    return enc


def temporal_table_tv(enc: HashGridEncoding, table: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of adjacent vertices along the last (time)
    axis of every dense level's grid: each dense level's rows are viewed as
    its C-ordered ``(verts..., F)`` grid, as the JAX package does. Levels
    with fewer than two time vertices, and hashed levels, take no part. Its
    gradient into the table is dense over the dense levels."""
    total, count = table.new_zeros(()), 0
    for l in range(enc.n_levels):
        if not enc.level_dense[l]:
            continue
        verts = tuple(int(r) + 1 for r in enc.level_resolutions[l])
        if verts[-1] < 2:
            continue
        seg = table[int(enc.level_offsets[l]):int(enc.level_offsets[l + 1])]
        diff = torch.diff(seg.reshape(*verts, enc.n_features_per_level), dim=len(verts) - 1)
        total = total + torch.sum(diff**2)
        count += diff.numel()
    return total / max(count, 1)
