"""Dense-grid evaluation: the interpolation / super-resolution path.

Port of ``mri_interpolation_tpu/infer/grid.py``: coordinates are made on the
device from flat voxel indices (index -> mixed-radix digits -> linspace
values), so a grid of any shape costs no host grid and no transfer but the
result. The grid is walked in fixed chunks of ``chunk_size`` voxels, the
padded tail repeating the last voxel. Each chunk's coordinates go through
the model's forward, i.e. the hash-encode kernel on the card.

The JAX package sends an all-dense encoder to the separable ``apply_grid``
path instead; that path is not ported yet (ROADMAP.md). Both compute the same
function: the JAX tests hold ``apply_grid`` equal to ``apply`` to 1e-6.

``predict_batched`` runs the same chunked forward over an explicit
coordinate matrix (the launcher's periodic eval).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.core import Model

__all__ = ["flat_index_to_coords", "evaluate_grid", "predict_batched"]


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


def _check_model_on(model: Model, dev: torch.device) -> None:
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model is on {p.device}, the evaluation runs on {dev}")


def _eval_chunks(model: Model, n: int, chunk_size: int, dev: torch.device, chunk_coords,
                 frame_idx: Optional[int]) -> np.ndarray:
    """The model in eval mode on ``n`` rows, ``chunk_size`` a forward, chunk c's
    coordinates from ``chunk_coords(start, stop)`` (rows past n repeat the
    last); returns (n, dim_out) on the host."""
    chunk_size = min(chunk_size, n)
    n_chunks = -(-n // chunk_size)
    kwargs = {} if frame_idx is None else {"frame_idx": frame_idx}
    out = torch.empty((n_chunks * chunk_size, model.dim_out), dtype=torch.float32, device=dev)
    was_training = model.training
    model.eval()
    try:
        for c in range(n_chunks):
            start = c * chunk_size
            out[start:start + chunk_size] = model(chunk_coords(start, start + chunk_size), **kwargs)
    finally:
        model.train(was_training)
    return out[:n].cpu().numpy()


@torch.no_grad()
def evaluate_grid(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                  chunk_size: int = 1 << 17, device: DeviceLike = None,
                  frame_idx: Optional[int] = None) -> np.ndarray:
    """Evaluate the model in eval mode on a dense grid of ``shape``; returns
    the volume (``shape``, plus a trailing axis when dim_out > 1). The model
    must already be on ``device`` (``cuda`` unless "cpu"). ``frame_idx``
    selects a multi-frame model's frame."""
    dev = resolve_device(device)
    _check_model_on(model, dev)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))

    def chunk_coords(start: int, stop: int) -> torch.Tensor:
        flat = torch.arange(start, stop, device=dev).clamp_(max=n - 1)
        return flat_index_to_coords(flat, shape, lo, hi)

    vol = _eval_chunks(model, n, chunk_size, dev, chunk_coords, frame_idx)
    return vol.reshape(shape) if vol.shape[-1] == 1 else vol.reshape(shape + (vol.shape[-1],))


@torch.no_grad()
def predict_batched(model: Model, coords: np.ndarray, chunk_size: int = 1 << 17, device: DeviceLike = None,
                    frame_idx: Optional[int] = None) -> np.ndarray:
    """The model in eval mode on the rows of ``coords`` (N, d), ``chunk_size``
    rows a forward, the padded tail repeating the last row; returns (N,
    dim_out). The model must already be on ``device`` (``cuda`` unless
    "cpu"). ``frame_idx`` selects a multi-frame model's frame."""
    dev = resolve_device(device)
    _check_model_on(model, dev)
    x = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
    n = x.shape[0]

    def chunk_coords(start: int, stop: int) -> torch.Tensor:
        rows = x[start:stop]
        return rows if len(rows) == stop - start else torch.cat([rows, x[-1:].expand(stop - start - len(rows), -1)])

    return _eval_chunks(model, n, chunk_size, dev, chunk_coords, frame_idx)
