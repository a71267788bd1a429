"""A hash-MLP's dense grid, one chunk an op call: kernel 1 then kernel 5.

The op ``torch.ops.mri_torch.hash_mlp_grid_forward`` (``ops/library.py``;
:func:`grid_forward` calls it) evaluates the voxels ``start``, ...,
``start + len(scratch) - 1`` of a dense grid of ``shape`` over ``[lo, hi]``
on every axis, in C order (voxels past the last one repeat it), through a
hash encoder and a fused decoder: the encoder's features go to ``scratch``
(len(scratch), L*F), the decoder's output to ``out``'s rows ``start``,
... . Nothing is returned; both tensors are written in place.

- CUDA: kernel 1's grid variant (``hash_encode_forward_kernel<D, V, true>``),
  which makes the coordinates from the flat voxel index, bit for bit those
  of :func:`flat_index_to_coords` on the card, into ``scratch``; then
  kernel 5 (``fused_mlp_forward_kernel``) from ``scratch`` straight into
  ``out``'s rows. Two launches, each counted in its module's ``LAUNCHES``
  entry (``hash_encode_forward``, ``fused_mlp_forward``) under its own
  ``mri.op.launch`` span. What the launches need (the checks, the ctypes
  arrays, kernel 5's plan) is built at the first call with a new set of
  arguments, in practice a request's first chunk, and kept for the calls
  that repeat them but for ``start``: the last set alone is kept, by the
  arguments' values and the tensors' addresses, shapes, strides, dtypes
  and devices, and holds no tensor.
- CPU: the plain version, :func:`flat_index_to_coords`, then
  ``hash_encode_reference`` and ``mlp_forward_reference``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..encodings.hashgrid import HashGridEncoding
from . import build
from . import fused_mlp as fm
from . import hash_encode as he

__all__ = ["flat_index_to_coords", "grid_forward"]


def flat_index_to_coords(flat_idx: torch.Tensor, shape: Sequence[int], lo: float = 0.0,
                         hi: float = 1.0) -> torch.Tensor:
    """C-order flat voxel indices -> (N, d) float32 grid coordinates, row
    ``flat_idx`` of ``stack(meshgrid(*[linspace(lo, hi, s)])).reshape(-1, d)``
    in the reference's float32 arithmetic."""
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) >= 2**31:
        raise ValueError(f"grid {shape} exceeds int32 indexing; shard it first")
    strides = np.concatenate([np.cumprod(shape[::-1])[::-1][1:], [1]]).astype(np.int64)
    idx = flat_idx.to(torch.int64)
    coords = []
    for k, size in enumerate(shape):
        digit = (idx // int(strides[k])) % size
        denom = max(size - 1, 1)
        coords.append(lo + (hi - lo) * digit.to(torch.float32) / denom)
    return torch.stack(coords, dim=-1)


def grid_forward(table: torch.Tensor, params: List[torch.Tensor], acts: Sequence[float], geometry: List[int],
                 shape: List[int], lo: float, hi: float, start: int, scratch: torch.Tensor,
                 out: torch.Tensor) -> None:
    """One chunk through the op ``hash_mlp_grid_forward``: ``params`` is the
    decoder's (w_0, b_0, w_1, ...), ``acts`` its ``fused_mlp.act_words``,
    ``geometry`` the encoder's ``geometry_key()``."""
    torch.ops.mri_torch.hash_mlp_grid_forward.default(table, params, acts, geometry, shape, lo, hi, start, scratch,
                                                      out)


def _voxels(shape: Sequence[int]) -> int:
    return int(np.prod([int(s) for s in shape]))


def _forward_cpu(table, params, acts, geometry, shape, lo, hi, start, scratch, out) -> None:
    enc = HashGridEncoding.from_key(geometry)
    rows = scratch.shape[0]
    flat = torch.arange(start, start + rows).clamp_(max=_voxels(shape) - 1)
    scratch.copy_(he.hash_encode_reference(enc, table, flat_index_to_coords(flat, shape, lo, hi)))
    out[start:start + rows] = fm.mlp_forward_reference(params[0::2], params[1::2], scratch,
                                                       fm._acts_of(tuple(acts)))


class _Launches:
    """Both launches of a chunk for one set of the op's arguments but
    ``start``, checked and built once."""

    def __init__(self, table, params, acts, geometry, shape, lo, hi, scratch, out):
        enc = HashGridEncoding.from_key(geometry)
        dev = table.device
        shape = [int(s) for s in shape]
        if len(shape) != enc.input_dim or min(shape) < 1:
            raise ValueError(f"grid {tuple(shape)}: expected {enc.input_dim} axes of at least one voxel")
        if _voxels(shape) >= 2**31:
            raise ValueError(f"grid {tuple(shape)} exceeds int32 indexing; shard it first")
        rows = scratch.shape[0]
        build.check_tensor("table", table, (enc.total_size, enc.n_features_per_level), dev)
        build.check_tensor("scratch", scratch, (rows, enc.output_dim), dev)
        weights, biases, layer_acts = params[0::2], params[1::2], fm._acts_of(tuple(acts))
        dims = fm._chain(weights, biases, scratch, layer_acts)
        build.check_tensor("out", out, (out.shape[0], dims[-1]), dev)
        self.rows, self.width = rows, dims[-1]
        self.encode = he.GridEncodeLaunch(enc, table, scratch, shape, lo, hi)
        self.decode = fm.ForwardLaunch(weights, biases, layer_acts, dims, rows, dev)
        self.scratch, self.out, self.out_rows = scratch.data_ptr(), out.data_ptr(), out.shape[0]

    def launch(self, start: int) -> None:
        if start < 0 or start + self.rows > self.out_rows:
            raise ValueError(f"rows {start}..{start + self.rows} lie outside out's {self.out_rows}")
        self.encode.launch(start)
        self.decode.launch(self.scratch, self.out + 4 * self.width * start)


def _layout(t: torch.Tensor):
    return t.data_ptr(), t.shape, t.stride(), t.dtype, t.device


_last = {}  # the last set of arguments (but start) -> its _Launches


def _forward_cuda(table, params, acts, geometry, shape, lo, hi, start, scratch, out) -> None:
    key = (tuple(geometry), tuple(shape), lo, hi, tuple(acts), _layout(table), _layout(scratch), _layout(out),
           *map(_layout, params))
    launches = _last.get(key)
    if launches is None:
        launches = _Launches(table, params, acts, geometry, shape, lo, hi, scratch, out)
        _last.clear()
        _last[key] = launches
    launches.launch(start)
