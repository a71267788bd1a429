"""Hash-encode forward and table gradient: CUDA kernels and plain versions.

Port of ``mri_interpolation_tpu/ops/pallas/hash_encode.py``: the encode of
all levels (``hash_encode_forward``, ``pallas_hash_encode``: kernels 1-2)
and of the coarse dense levels alone (``coarse_onehot_levels``,
``pallas_hash_encode_coarse``: kernels 3-4). The kernels are in
``csrc/hash_encode.cu`` (built by ``ops/build.py``, bound with ctypes).

Dispatch: a CPU tensor goes to the plain PyTorch version
(:func:`hash_encode_reference`, :func:`hash_encode_table_grad_reference`);
a CUDA tensor goes to the kernel, or the wrapper raises. There is no
fallback from the card to the plain version. Each wrapper adds one to its
entry of :data:`LAUNCHES` per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..encodings.hashgrid import HashGridEncoding
from . import build

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
    "coarse_onehot_levels",
    "coarse_constants",
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
    ids, contrib = _scatter_terms(enc, x, g, range(enc.n_levels))
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
    """Encode x (N, d) in [0, 1] -> (N, L*F) with the fused table (T, F).
    CUDA tensors launch the forward kernel; CPU tensors take the plain
    version."""
    if not (x.is_cuda or table.is_cuda):
        return hash_encode_reference(enc, table, x)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), table.device)
    build.check_tensor("table", table, (enc.total_size, enc.n_features_per_level), table.device)
    _check_geometry(enc)
    out = torch.empty((n, enc.output_dim), dtype=torch.float32, device=x.device)
    _launch("hash_encode_forward", x, table, out, enc)
    return out


def hash_encode_table_grad(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dtable (T, F) for upstream g (N, L*F). CUDA tensors launch the
    table-gradient kernels after :func:`table_grad_plan` (one call, one
    count); CPU tensors take the plain version."""
    if not (x.is_cuda or g.is_cuda):
        return hash_encode_table_grad_reference(enc, x, g)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), g.device)
    build.check_tensor("g", g, (n, enc.output_dim), g.device)
    _check_geometry(enc)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=torch.float32, device=g.device)
    _launch("hash_encode_table_grad", x, g, dtable, enc, words=plan_words(enc, table_grad_plan(enc, n)))
    return dtable


class HashEncode(torch.autograd.Function):
    """Differentiable encode w.r.t. the table: the forward launches kernel 1,
    the backward kernel 2. Coordinates get no gradient (they are data)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor, enc: HashGridEncoding) -> torch.Tensor:
        ctx.enc = enc
        ctx.save_for_backward(x)
        return hash_encode_forward(enc, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        dtable = hash_encode_table_grad(ctx.enc, x, g.contiguous()) if ctx.needs_input_grad[0] else None
        return dtable, None, None


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


def _check_coarse(enc: HashGridEncoding, levels: Sequence[int]) -> None:
    _check_geometry(enc)
    largest = 4 * enc.n_features_per_level * max(int(enc.level_sizes[l]) for l in levels)
    if largest > _MAX_SHARED_BYTES:
        raise ValueError(f"a coarse level of {largest} bytes exceeds a block's {_MAX_SHARED_BYTES} bytes "
                         "of shared memory: lower max_rows")


def hash_encode_coarse_reference(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                                 max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """(N, d) coords -> (N, n_coarse*F): the coarse levels' columns of the
    encode, corner-row gather + weighted sum."""
    return _encode_levels(enc, table, x, _coarse_levels(enc, max_rows))


def hash_encode_coarse_table_grad_reference(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor,
                                            max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """dL/dtable (T, F) for upstream g (N, n_coarse*F): ``index_add_`` of g*w
    into a zeroed fused table; rows outside the coarse levels stay 0."""
    ids, contrib = _scatter_terms(enc, x, g, _coarse_levels(enc, max_rows))
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=g.dtype, device=g.device)
    return dtable.index_add_(0, ids, contrib)


def hash_encode_coarse_forward(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor,
                               max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """The coarse levels' features (N, n_coarse*F) in level order from the
    fused table (T, F). CUDA tensors launch kernel 3; CPU tensors take the
    plain version. Raises ValueError when no level qualifies or when one
    level's rows alone exceed a block's shared memory."""
    if not (x.is_cuda or table.is_cuda):
        return hash_encode_coarse_reference(enc, table, x, max_rows)
    levels = _coarse_levels(enc, max_rows)
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
    zero outside the coarse levels. CUDA tensors launch kernel 4; CPU tensors
    take the plain version."""
    if not (x.is_cuda or g.is_cuda):
        return hash_encode_coarse_table_grad_reference(enc, x, g, max_rows)
    levels = _coarse_levels(enc, max_rows)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), g.device)
    build.check_tensor("g", g, (n, len(levels) * enc.n_features_per_level), g.device)
    _check_coarse(enc, levels)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=torch.float32, device=g.device)
    _launch("hash_encode_coarse_table_grad", x, g, dtable, enc, coarse_constants(enc, levels))
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
