"""Hash-encode forward and table gradient: CUDA kernels and plain versions.

Port of ``mri_interpolation_tpu/ops/pallas/hash_encode.py``: the encode of
all levels (``hash_encode_forward``, ``pallas_hash_encode``: kernels 1-2)
and of the coarse dense levels alone (``coarse_onehot_levels``,
``pallas_hash_encode_coarse``: kernels 3-4). The kernels are in
``csrc/hash_encode.cu`` (built by ``ops/build.py``, bound with ctypes).

Dispatch: each wrapper calls its op ``torch.ops.mri_torch.<name>``
(``ops/library.py``), whose CPU impl is the plain PyTorch version
(:func:`hash_encode_reference`, :func:`hash_encode_table_grad_reference`, ...)
and whose CUDA impl launches the kernel or raises. There is no fallback from
the card to the plain version. The CUDA impls add one to their entry of
:data:`LAUNCHES` per kernel launch, and nowhere else. An op takes the
geometry as ``HashGridEncoding.geometry_key()`` and rebuilds it with
``HashGridEncoding.from_key`` (cached).

The coordinates' gradient (:func:`hash_encode_coord_grad`, which the warp
INR's warped points need) is plain torch on both devices, as JAX takes it
from XLA's autodiff and not from a Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..encodings.hashgrid import HashGridEncoding
from . import build
from .build import H100_SMS

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "hash_encode_forward",
    "hash_encode_table_grad",
    "hash_encode_reference",
    "hash_encode_table_grad_reference",
    "TableGradPlan",
    "table_grad_plan",
    "plan_words",
    "HashEncode",
    "hash_encode_coord_grad",
    "coarse_onehot_levels",
    "coarse_constants",
    "CoarseGradPlan",
    "coarse_grad_plan",
    "coarse_plan_words",
    "hash_encode_coarse_forward",
    "hash_encode_coarse_table_grad",
    "hash_encode_coarse_reference",
    "hash_encode_coarse_table_grad_reference",
    "HashEncodeCoarse",
    "hash_encode_coarse",
    "table_grad_abs_sum",
    "atomic_sum_bound",
]

LAUNCHES = {"hash_encode_forward": 0, "hash_encode_table_grad": 0,
            "hash_encode_coarse_forward": 0, "hash_encode_coarse_table_grad": 0}

ONEHOT_MAX_ROWS = 2048  # the JAX package's _ONEHOT_MAX_ROWS
_MAX_SHARED_BYTES = 232448  # Hopper's opt-in shared memory per block
_SM_SHARED_BYTES = 233472  # Hopper's shared memory per SM
_BLOCK_RESERVED_BYTES = 1024  # the shared memory that CUDA keeps for each resident block
# fp32 sums taken in another order: |error| <= ATOMIC_SUM_C * 2^-24 * sum|terms|
# (see atomic_sum_bound)
ATOMIC_SUM_C = 8.0
# The table gradient's plan (table_grad_plan). A level is privatised when its
# rows take at least PRIVATE_MIN_UPDATES updates each on average: about the
# private kernel's blocks (two per SM on 132 SMs), so that its flush, one
# global atomic per (row, feature) and block, adds no more than it removes.
# Its rows must fit PRIVATE_MAX_BYTES, half a block's opt-in shared memory,
# so that two blocks share an SM.
PRIVATE_MIN_UPDATES = 256
PRIVATE_MAX_BYTES = _MAX_SHARED_BYTES // 2
# two blocks of 256 threads on each of an H100's 132 SMs: the global levels'
# corners are split into groups until the grid holds at least this many
# threads, the fewest groups that give every SM work (each group recomputes
# its point's cell and weights)
MIN_GRID_THREADS = 2 * 132 * 256
# the coarse table gradient's plan (coarse_grad_plan): blocks of 256 threads,
# at most COARSE_BLOCKS_PER_SM an SM (the kernel is bound by the latency of
# its warp sums and shared atomics: more warps an SM hide more of it), in
# clusters of up to COARSE_MAX_CLUSTER (the portable limit); a block takes
# at least one update of its points for each accumulator entry that the
# cluster's flush reads from it
COARSE_THREADS = 256
COARSE_BLOCKS_PER_SM = 4
COARSE_MAX_CLUSTER = 8
# kernel 4 gives each of a block's warps its own copy of the accumulator
# (plain adds, no shared atomics) where the copies of every coarse row fit
# this many bytes, enough that several blocks still share an SM
COARSE_WARPS = COARSE_THREADS // 32
COARSE_WARP_COPIES_BYTES = 48 * 1024

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_PLAN_SIGNATURE = _SIGNATURE[:-1] + [ctypes.c_void_p, ctypes.c_void_p]  # ..., level_consts, plan, stream


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = build.load("hash_encode")
    if lib.hash_encode_forward.argtypes is None:
        for fn in (lib.hash_encode_forward, lib.hash_encode_table_grad,
                   lib.hash_encode_coarse_forward, lib.hash_encode_coarse_table_grad):
            fn.argtypes = _SIGNATURE
            fn.restype = ctypes.c_int
        lib.hash_encode_table_grad.argtypes = _PLAN_SIGNATURE
        lib.hash_encode_coarse_table_grad.argtypes = _PLAN_SIGNATURE
        lib.hash_encode_error_string.argtypes = [ctypes.c_int]
        lib.hash_encode_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side yardstick)


def hash_encode_reference(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, d) coords -> (N, L*F) features: corner-row gather + weighted sum."""
    return _encode_levels(enc, table, x, range(enc.n_levels))


def _encode_levels(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor, levels) -> torch.Tensor:
    """The features of ``levels`` (N, len(levels)*F), in their order."""
    ids, w = enc.corner_ids_and_weights(x, levels)  # (N, L, C)
    rows = table[ids]  # (N, L, C, F)
    return (rows * w.unsqueeze(-1)).sum(dim=2).reshape(x.shape[0], len(levels) * enc.n_features_per_level)


def hash_encode_table_grad_reference(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dtable for upstream g (N, L*F): scatter-add g*w into a zeroed
    (total_size, F) table with ``index_add_``."""
    return _scatter_levels(enc, x, g, range(enc.n_levels))


def _scatter_levels(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor, levels) -> torch.Tensor:
    """``index_add_`` of the terms g*w of ``levels`` into a zeroed fused
    table; the rows of the other levels stay 0."""
    ids, contrib = _scatter_terms(enc, x, g, levels)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=g.dtype, device=g.device)
    return dtable.index_add_(0, ids, contrib)


def _scatter_terms(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor, levels):
    """(rows, terms): the fused-table row and the F-wide term g*w of every
    (point, level, corner) of ``levels``, g holding len(levels)*F columns."""
    F = enc.n_features_per_level
    ids, w = enc.corner_ids_and_weights(x, levels)
    contrib = g.reshape(x.shape[0], len(levels), 1, F) * w.unsqueeze(-1)  # (N, L, C, F)
    return ids.reshape(-1), contrib.reshape(-1, F)


# ---------------------------------------------------------------------------
# the table gradient's per-level plan (kernel 2)


class TableGradPlan(NamedTuple):
    """Which levels the table-gradient call privatises in shared memory and
    which it adds with global atomics, and how it shapes each kernel."""

    private_levels: Tuple[int, ...]  # level order; their rows packed in this order
    global_levels: Tuple[int, ...]
    corner_split: int  # threads per (point, global level), each 2^d / corner_split corners
    shared_bytes: int  # the private kernel's accumulator (a group of levels at a time)


def table_grad_plan(enc: HashGridEncoding, n: int) -> TableGradPlan:
    """The plan of ``hash_encode_table_grad`` for ``n`` points: a level is
    privatised when it is dense, its rows fit ``PRIVATE_MAX_BYTES`` and they
    take at least ``PRIVATE_MIN_UPDATES`` updates each on average
    (n * 2^d / rows); every other level is global, its corners split until
    the grid holds ``MIN_GRID_THREADS`` threads."""
    corners, F = 1 << enc.input_dim, enc.n_features_per_level
    sizes = [int(s) for s in enc.level_sizes]
    private = tuple(l for l in range(enc.n_levels)
                    if enc.level_dense[l] and 4 * F * sizes[l] <= PRIVATE_MAX_BYTES
                    and n * corners >= PRIVATE_MIN_UPDATES * sizes[l])
    global_ = tuple(l for l in range(enc.n_levels) if l not in private)
    split = 1
    while global_ and split < corners and n * len(global_) * split < MIN_GRID_THREADS:
        split *= 2
    shared = min(4 * F * sum(sizes[l] for l in private), PRIVATE_MAX_BYTES)
    return TableGradPlan(private, global_, split, shared)


def plan_words(enc: HashGridEncoding, plan: TableGradPlan) -> np.ndarray:
    """The plan as the kernel reads it (int32): n_private, n_global,
    corner_split, shared_bytes, the private levels, each one's first row in
    the accumulator's packing, the global levels."""
    packed = np.concatenate([[0], np.cumsum([int(enc.level_sizes[l]) for l in plan.private_levels])])[:-1]
    words = [len(plan.private_levels), len(plan.global_levels), plan.corner_split, plan.shared_bytes,
             *plan.private_levels, *packed.tolist(), *plan.global_levels]
    return np.asarray(words, dtype=np.int32)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_geometry(enc: HashGridEncoding) -> None:
    if enc.total_size * enc.n_features_per_level >= 2**31:
        raise ValueError("the CUDA kernels index the table with int32: total_size * F must be < 2^31")


def _launch(fn_name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            enc: HashGridEncoding, consts: Optional[np.ndarray] = None,
            words: Optional[np.ndarray] = None) -> None:
    """Launch ``fn_name`` with the level constants ``consts`` (default: all
    levels, ``enc.kernel_constants``) and, for the table gradient, its plan
    ``words``."""
    lib = _library()
    consts = enc.kernel_constants if consts is None else consts
    extra = () if words is None else (words.ctypes.data,)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                                    enc.input_dim, enc.n_features_per_level, consts.shape[0],
                                    consts.ctypes.data, *extra, stream)
    if err != 0:
        msg = lib.hash_encode_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (cudaError {err})")
    if a.shape[0] > 0:
        LAUNCHES[fn_name] += 1


def hash_encode_forward(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Encode x (N, d) in [0, 1] -> (N, L*F) with the fused table (T, F),
    through the op ``hash_encode_forward``: CUDA tensors launch the forward
    kernel; CPU tensors take the plain version."""
    return torch.ops.mri_torch.hash_encode_forward.default(table, x, enc.geometry_key())


def _forward_cpu(table: torch.Tensor, x: torch.Tensor, geometry: List[int]) -> torch.Tensor:
    return hash_encode_reference(HashGridEncoding.from_key(geometry), table, x)


def _forward_cuda(table: torch.Tensor, x: torch.Tensor, geometry: List[int]) -> torch.Tensor:
    enc = HashGridEncoding.from_key(geometry)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), table.device)
    build.check_tensor("table", table, (enc.total_size, enc.n_features_per_level), table.device)
    _check_geometry(enc)
    out = torch.empty((n, enc.output_dim), dtype=torch.float32, device=x.device)
    _launch("hash_encode_forward", x, table, out, enc)
    return out


def hash_encode_table_grad(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dtable (T, F) for upstream g (N, L*F), through the op
    ``hash_encode_table_grad``: CUDA tensors launch the table-gradient
    kernels after :func:`table_grad_plan` (one call, one count); CPU tensors
    take the plain version."""
    return torch.ops.mri_torch.hash_encode_table_grad.default(x, g, enc.geometry_key())


def _table_grad_cpu(x: torch.Tensor, g: torch.Tensor, geometry: List[int]) -> torch.Tensor:
    return hash_encode_table_grad_reference(HashGridEncoding.from_key(geometry), x, g)


@functools.lru_cache(maxsize=1024)
def _table_grad_words(enc: HashGridEncoding, n: int) -> np.ndarray:
    """:func:`plan_words` of :func:`table_grad_plan` for ``n`` points (cached:
    ``enc`` is the one object of its key)."""
    return plan_words(enc, table_grad_plan(enc, n))


def _table_grad_cuda(x: torch.Tensor, g: torch.Tensor, geometry: List[int]) -> torch.Tensor:
    enc = HashGridEncoding.from_key(geometry)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), g.device)
    build.check_tensor("g", g, (n, enc.output_dim), g.device)
    _check_geometry(enc)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=torch.float32, device=g.device)
    _launch("hash_encode_table_grad", x, g, dtable, enc, words=_table_grad_words(enc, n))
    return dtable


def hash_encode_coord_grad(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """dL/dx (N, d) for upstream g (N, L*F), in plain torch on either device
    (the JAX package takes it from XLA's autodiff, not from a kernel).

    As in JAX, the gradient flows only through the corner weights of the
    cell-view levels (``enc.level_cellview``): the cell index is an integer
    (no gradient), so for such a level
    ``dx_k = res_k * sum_c <g_l, row_c> * dw_c/dxf_k``, with
    ``dw_c/dxf_k`` the product of the other axes' factors, signed + where
    corner c takes xi + 1 on axis k and - where it takes xi. The other
    levels (hashed, or dense with more cells) contribute zero: JAX's packed
    path returns no coordinate cotangent. The corner rows are gathered once;
    the features are not recomputed."""
    n, d, F = x.shape[0], enc.input_dim, enc.n_features_per_level
    levels = [l for l in range(enc.n_levels) if enc.level_cellview[l]]
    if not levels or n == 0:
        return torch.zeros_like(x)
    ids, _ = enc.corner_ids_and_weights(x, levels)  # (N, Lc, C)
    rows = table[ids]  # (N, Lc, C, F): the one gather
    gl = g.reshape(n, enc.n_levels, F)[:, levels]  # (N, Lc, F)
    s = torch.einsum("nlcf,nlf->nlc", rows, gl)
    xs = [x[:, k] for k in range(d)]
    cols = [torch.zeros_like(xs[0]) for _ in range(d)]
    for i, l in enumerate(levels):
        _, xf = enc.level_cells(xs, l)
        for k in range(d):
            acc = torch.zeros_like(xs[0])
            for c in range(1 << d):
                term = s[:, i, c]
                for j in range(d):
                    if j != k:
                        term = term * (xf[j] if (c >> j) & 1 else 1.0 - xf[j])
                acc = acc + term if (c >> k) & 1 else acc - term
            cols[k] = cols[k] + float(enc.level_resolutions[l][k]) * acc
    return torch.stack(cols, dim=-1)


class HashEncode(torch.autograd.Function):
    """Differentiable encode: the forward launches kernel 1; the backward
    kernel 2 for the table and, where the coordinates need a gradient (the
    warp INR's warped points), :func:`hash_encode_coord_grad` for them."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor, enc: HashGridEncoding) -> torch.Tensor:
        ctx.enc = enc
        ctx.save_for_backward(x, table)
        return hash_encode_forward(enc, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, table = ctx.saved_tensors
        g = g.contiguous()
        dtable = hash_encode_table_grad(ctx.enc, x, g) if ctx.needs_input_grad[0] else None
        dx = hash_encode_coord_grad(ctx.enc, table, x, g) if ctx.needs_input_grad[1] else None
        return dtable, dx, None


# ---------------------------------------------------------------------------
# the coarse dense levels alone (kernels 3-4)


def coarse_onehot_levels(enc: HashGridEncoding, max_rows: int = ONEHOT_MAX_ROWS) -> List[int]:
    """Dense levels of at most ``max_rows`` rows, in level order (the JAX
    package's name: there they take the one-hot matmul path)."""
    return [l for l in range(enc.n_levels)
            if enc.level_dense[l] and int(enc.level_sizes[l]) <= max_rows]


def coarse_constants(enc: HashGridEncoding, levels: Sequence[int]) -> np.ndarray:
    """The coarse kernels' (len(levels), 12) int32 constant block: the
    levels' rows of ``enc.kernel_constants`` with word 9 (offset) set to the
    level's first row in the unpadded packing of ``levels`` and word 11
    (source) to its first row in the fused table."""
    levels = list(levels)
    consts = enc.kernel_constants[levels].copy()
    consts[:, 9] = np.concatenate([[0], np.cumsum(enc.level_sizes[levels])[:-1]])
    consts[:, 11] = enc.level_offsets[levels]
    return consts


def _coarse_levels(enc: HashGridEncoding, max_rows: int) -> List[int]:
    levels = coarse_onehot_levels(enc, max_rows)
    if not levels:
        raise ValueError(f"no dense level of at most {max_rows} rows: nothing for the coarse path")
    return levels


def _level_too_large(F: int, rows: int) -> Optional[str]:
    largest = 4 * F * rows
    if largest > _MAX_SHARED_BYTES:
        return (f"a coarse level of {largest} bytes exceeds a block's {_MAX_SHARED_BYTES} bytes "
                "of shared memory: lower max_rows")
    return None


def _check_coarse(enc: HashGridEncoding, levels: Sequence[int]) -> None:
    _check_geometry(enc)
    msg = _level_too_large(enc.n_features_per_level, max(int(enc.level_sizes[l]) for l in levels))
    if msg:
        raise ValueError(msg)


class CoarseGradPlan(NamedTuple):
    """How kernel 4 walks the points and flushes its accumulators."""

    grid: int  # blocks of COARSE_THREADS threads, a whole number of clusters
    cluster: int  # blocks a cluster: 1, 2, 4 or 8
    copies: int  # accumulators a block: 1 (shared atomics) or COARSE_WARPS (one a warp, plain adds)
    shared_bytes: int  # a block's accumulators: copies x the largest group's rows
    group_ends: Tuple[int, ...]  # groups of consecutive coarse levels [0, e0), [e0, e1), ...


def coarse_grad_plan(enc: HashGridEncoding, levels: Sequence[int], n: int, sms: int = H100_SMS) -> CoarseGradPlan:
    """The plan of ``hash_encode_coarse_table_grad`` for ``n`` points on the
    coarse ``levels`` of ``enc``, on a card of ``sms`` SMs. A pure function
    of them, cached.

    Accumulators: one a warp where ``COARSE_WARPS`` copies of every coarse
    row fit ``COARSE_WARP_COPIES_BYTES`` (one group of levels), else one a
    block, in groups: the longest runs of consecutive levels whose rows fit
    a block's shared memory, one after another (a level that alone does not
    fit is refused with ValueError). Grid: at most ``COARSE_BLOCKS_PER_SM``
    blocks an SM, and no more than the SM's shared memory holds (at one
    block's accumulators and the 1 KB that CUDA keeps a block), at most as
    many as give each block one update (points x levels x 2^d corners x F)
    per accumulator entry of every group; of those, the fewest whole
    clusters that walk the points in as few rounds
    of ``COARSE_THREADS`` points a block, so that no block takes a round
    more than the others (one point a thread where the card holds them
    all). Cluster: the largest power of two up to ``COARSE_MAX_CLUSTER``
    that the grid holds."""
    sizes = tuple(int(enc.level_sizes[l]) for l in levels)
    return _coarse_grad_plan(sizes, int(enc.input_dim), int(enc.n_features_per_level), int(n), int(sms))


@functools.lru_cache(maxsize=1024)
def _coarse_grad_plan(sizes: Tuple[int, ...], d: int, F: int, n: int, sms: int) -> CoarseGradPlan:
    budget = _MAX_SHARED_BYTES // (4 * F)
    for rows in sizes:
        msg = _level_too_large(F, rows)
        if msg:
            raise ValueError(msg)
    ends, used, rows_max = [], 0, 0
    for j, rows in enumerate(sizes):
        if used + rows > budget:
            ends.append(j)
            used = 0
        used += rows
        rows_max = max(rows_max, used)
    ends.append(len(sizes))
    starts = [0, *ends[:-1]]
    copies = COARSE_WARPS if COARSE_WARPS * 4 * F * sum(sizes) <= COARSE_WARP_COPIES_BYTES else 1
    shared_bytes = copies * 4 * F * rows_max
    per_sm = min(COARSE_BLOCKS_PER_SM, _SM_SHARED_BYTES // (shared_bytes + _BLOCK_RESERVED_BYTES))
    want = max(1, -(-n // COARSE_THREADS))  # one point a thread
    limit = per_sm * sms
    for j0, j1 in zip(starts, ends):
        updates = n * (j1 - j0) * (1 << d) * F
        limit = min(limit, updates // (F * sum(sizes[j0:j1])))
    limit = max(limit, 1)
    cluster = min(COARSE_MAX_CLUSTER, 1 << (min(want, limit).bit_length() - 1))
    most = max(1, limit // cluster)  # clusters
    # as few clusters as take every point in as many rounds as `most` would:
    # each thread walks the same number of points, give or take one
    rounds = -(-want // (most * cluster))
    grid = cluster * -(-want // (rounds * cluster))
    return CoarseGradPlan(grid, cluster, copies, shared_bytes, tuple(ends))


@functools.lru_cache(maxsize=1024)
def coarse_plan_words(plan: CoarseGradPlan):
    """The plan as kernel 4 reads it (int32): grid, cluster, copies, shared
    bytes, the number of groups, then each group's end level."""
    words = [plan.grid, plan.cluster, plan.copies, plan.shared_bytes, len(plan.group_ends), *plan.group_ends]
    return np.asarray(words, dtype=np.int32)


def _card_coarse_grad_plan(enc: HashGridEncoding, levels: Sequence[int], n: int,
                           device: torch.device) -> CoarseGradPlan:
    """coarse_grad_plan for the SMs of the card that holds ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return coarse_grad_plan(enc, levels, n, build.sm_count(index))


def hash_encode_coarse_reference(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                                 max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """(N, d) coords -> (N, n_coarse*F): the coarse levels' columns of the
    encode, corner-row gather + weighted sum."""
    return _encode_levels(enc, table, x, _coarse_levels(enc, max_rows))


def hash_encode_coarse_table_grad_reference(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor,
                                            max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """dL/dtable (T, F) for upstream g (N, n_coarse*F): ``index_add_`` of g*w
    into a zeroed fused table; rows outside the coarse levels stay 0."""
    return _scatter_levels(enc, x, g, _coarse_levels(enc, max_rows))


def hash_encode_coarse_forward(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                               max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """The coarse levels' features (N, n_coarse*F) in level order from the
    fused table (T, F), through the op ``hash_encode_coarse_forward`` (its
    levels as ``int[]``): CUDA tensors launch kernel 3; CPU tensors take the
    plain version. Raises ValueError when no level qualifies or when one
    level's rows alone exceed a block's shared memory: kernel 3 stages no
    rows, but it refuses the levels that kernel 4's accumulator refuses, so
    that ``hash_encode_coarse`` fails in its forward, not in its backward."""
    return torch.ops.mri_torch.hash_encode_coarse_forward.default(table, x, enc.geometry_key(),
                                                                  _coarse_levels(enc, max_rows))


def _coarse_forward_cpu(table: torch.Tensor, x: torch.Tensor, geometry: List[int],
                        levels: List[int]) -> torch.Tensor:
    return _encode_levels(HashGridEncoding.from_key(geometry), table, x, levels)


def _coarse_forward_cuda(table: torch.Tensor, x: torch.Tensor, geometry: List[int],
                         levels: List[int]) -> torch.Tensor:
    enc = HashGridEncoding.from_key(geometry)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), table.device)
    build.check_tensor("table", table, (enc.total_size, enc.n_features_per_level), table.device)
    _check_coarse(enc, levels)
    out = torch.empty((n, len(levels) * enc.n_features_per_level), dtype=torch.float32, device=x.device)
    _launch("hash_encode_coarse_forward", x, table, out, enc, coarse_constants(enc, levels))
    return out


def hash_encode_coarse_table_grad(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor,
                                  max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """dL/dtable (T, F) of the fused table for upstream g (N, n_coarse*F),
    zero outside the coarse levels, through the op
    ``hash_encode_coarse_table_grad``: CUDA tensors launch kernel 4 after
    :func:`coarse_grad_plan` for the card; CPU tensors take the plain
    version."""
    return torch.ops.mri_torch.hash_encode_coarse_table_grad.default(x, g, enc.geometry_key(),
                                                                     _coarse_levels(enc, max_rows))


def _coarse_table_grad_cpu(x: torch.Tensor, g: torch.Tensor, geometry: List[int],
                           levels: List[int]) -> torch.Tensor:
    return _scatter_levels(HashGridEncoding.from_key(geometry), x, g, levels)


def _coarse_table_grad_cuda(x: torch.Tensor, g: torch.Tensor, geometry: List[int],
                            levels: List[int]) -> torch.Tensor:
    enc = HashGridEncoding.from_key(geometry)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), g.device)
    build.check_tensor("g", g, (n, len(levels) * enc.n_features_per_level), g.device)
    _check_coarse(enc, levels)
    plan = _card_coarse_grad_plan(enc, levels, n, g.device)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=torch.float32, device=g.device)
    _launch("hash_encode_coarse_table_grad", x, g, dtable, enc, coarse_constants(enc, levels),
            coarse_plan_words(plan))
    return dtable


class HashEncodeCoarse(torch.autograd.Function):
    """Differentiable coarse encode w.r.t. the fused table: the forward
    launches kernel 3, the backward kernel 4, whose (T, F) gradient is zero
    outside the coarse levels. Coordinates get no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor, enc: HashGridEncoding, max_rows: int) -> torch.Tensor:
        ctx.enc, ctx.max_rows = enc, max_rows
        ctx.save_for_backward(x)
        return hash_encode_coarse_forward(enc, table, x, max_rows)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        dtable = None
        if ctx.needs_input_grad[0]:
            dtable = hash_encode_coarse_table_grad(ctx.enc, x, g.contiguous(), ctx.max_rows)
        return dtable, None, None, None


def hash_encode_coarse(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                       max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """Differentiable encode of the coarse dense levels
    (``coarse_onehot_levels(enc, max_rows)``): (N, n_coarse*F) in level
    order, the counterpart of the JAX package's ``pallas_hash_encode_coarse``.
    The gradient reaches the fused (T, F) table. Raises ValueError when no
    level qualifies. There is no ``tile`` and no ``interpret`` argument: the
    kernels pick their own grid, and the tensor's device picks the kernel
    (CUDA) or the plain version (CPU)."""
    return HashEncodeCoarse.apply(table, x, enc, max_rows)


# ---------------------------------------------------------------------------
# the bound that holds an atomic scatter to its plain version


def table_grad_abs_sum(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor,
                       levels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Per (row, feature) of the fused table, the sum of |g*w| over the
    terms that the table gradient adds there: the plain version's
    ``index_add_`` on |contrib|, over ``levels`` (default all; g then has
    len(levels)*F columns)."""
    levels = list(range(enc.n_levels)) if levels is None else list(levels)
    ids, contrib = _scatter_terms(enc, x, g, levels)
    out = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=g.dtype, device=g.device)
    return out.index_add_(0, ids, contrib.abs())


def atomic_sum_bound(abs_sum: torch.Tensor, atol: float = 1e-5) -> torch.Tensor:
    """Per-entry bound on |kernel - plain version| of a scatter-add whose
    entries sum terms of both signs in run-dependent order:
    ``atol + ATOMIC_SUM_C * 2^-24 * sum|terms|``.

    Why: each fp32 addition rounds by at most 2^-24 of its partial sum. With
    zero-mean terms the partial sums are a random walk, and the error of a
    k-term sum has a standard deviation of about
    2^-24 * sum|terms| * (rms|t| / mean|t|) / sqrt(6), about 0.5 * 2^-24 *
    sum|terms| for the tests' terms (Gaussian g times a weight in [0, 1]).
    The kernel and the plain version (``index_add_``, atomics too on the
    card) err independently, so their difference has a deviation of about
    0.7 * 2^-24 * sum|terms|; ATOMIC_SUM_C = 8 is some 11 deviations. The
    bound scales with sum|terms|, not with |sum|: a row of many terms that
    cancel keeps its rounding error."""
    return atol + ATOMIC_SUM_C * 2.0**-24 * abs_sum
