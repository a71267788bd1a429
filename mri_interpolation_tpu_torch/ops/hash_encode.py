"""Hash-encode forward and table gradient: CUDA kernels and plain versions.

Port of ``mri_interpolation_tpu/ops/pallas/hash_encode.py``
(``hash_encode_forward``, ``pallas_hash_encode``). The kernels are in
``csrc/hash_encode.cu`` (built by ``ops/build.py``, bound with ctypes).

Dispatch: a CPU tensor goes to the plain PyTorch version
(:func:`hash_encode_reference`, :func:`hash_encode_table_grad_reference`);
a CUDA tensor goes to the kernel, or the wrapper raises. There is no
fallback from the card to the plain version. Each wrapper adds one to its
entry of :data:`LAUNCHES` per kernel launch, and nowhere else.
"""

from __future__ import annotations

import ctypes

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
    "HashEncode",
]

LAUNCHES = {"hash_encode_forward": 0, "hash_encode_table_grad": 0}

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = build.load("hash_encode")
    if lib.hash_encode_forward.argtypes is None:
        for fn in (lib.hash_encode_forward, lib.hash_encode_table_grad):
            fn.argtypes = _SIGNATURE
            fn.restype = ctypes.c_int
        lib.hash_encode_error_string.argtypes = [ctypes.c_int]
        lib.hash_encode_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side yardstick)


def hash_encode_reference(enc: HashGridEncoding, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, d) coords -> (N, L*F) features: corner-row gather + weighted sum."""
    ids, w = enc.corner_ids_and_weights(x)  # (N, L, C)
    rows = table[ids]  # (N, L, C, F)
    return (rows * w.unsqueeze(-1)).sum(dim=2).reshape(x.shape[0], enc.output_dim)


def hash_encode_table_grad_reference(enc: HashGridEncoding, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dtable for upstream g (N, L*F): scatter-add g*w into a zeroed
    (total_size, F) table with ``index_add_``."""
    F = enc.n_features_per_level
    ids, w = enc.corner_ids_and_weights(x)
    contrib = g.reshape(x.shape[0], enc.n_levels, 1, F) * w.unsqueeze(-1)  # (N, L, C, F)
    dtable = torch.zeros((enc.total_size, F), dtype=g.dtype, device=g.device)
    return dtable.index_add_(0, ids.reshape(-1), contrib.reshape(-1, F))


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_geometry(enc: HashGridEncoding) -> None:
    if enc.total_size * enc.n_features_per_level >= 2**31:
        raise ValueError("the CUDA kernels index the table with int32: total_size * F must be < 2^31")


def _launch(fn_name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            enc: HashGridEncoding) -> None:
    lib = _library()
    consts = enc.kernel_constants
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                                    enc.input_dim, enc.n_features_per_level, enc.n_levels,
                                    consts.ctypes.data, stream)
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
    atomic scatter kernel; CPU tensors take the plain version."""
    if not (x.is_cuda or g.is_cuda):
        return hash_encode_table_grad_reference(enc, x, g)
    n = x.shape[0]
    build.check_tensor("x", x, (n, enc.input_dim), g.device)
    build.check_tensor("g", g, (n, enc.output_dim), g.device)
    _check_geometry(enc)
    dtable = torch.zeros((enc.total_size, enc.n_features_per_level), dtype=torch.float32, device=g.device)
    _launch("hash_encode_table_grad", x, g, dtable, enc)
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

