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
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.core import Model

__all__ = ["flat_index_to_coords", "evaluate_grid"]


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


@torch.no_grad()
def evaluate_grid(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                  chunk_size: int = 1 << 17, device: DeviceLike = None,
                  frame_idx: Optional[int] = None) -> np.ndarray:
    """Evaluate the model in eval mode on a dense grid of ``shape``; returns
    the volume (``shape``, plus a trailing axis when dim_out > 1). The model
    must already be on ``device`` (``cuda`` unless "cpu"). ``frame_idx``
    selects a multi-frame model's frame."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model is on {p.device}, evaluate_grid runs on {dev}")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    chunk_size = min(chunk_size, n)
    n_chunks = -(-n // chunk_size)
    kwargs = {} if frame_idx is None else {"frame_idx": frame_idx}
    out = torch.empty((n_chunks * chunk_size, model.dim_out), dtype=torch.float32, device=dev)
    was_training = model.training
    model.eval()
    try:
        for c in range(n_chunks):
            start = c * chunk_size
            flat = torch.arange(start, start + chunk_size, device=dev).clamp_(max=n - 1)
            out[start:start + chunk_size] = model(flat_index_to_coords(flat, shape, lo, hi), **kwargs)
    finally:
        model.train(was_training)
    vol = out[:n].cpu().numpy()
    return vol.reshape(shape) if vol.shape[-1] == 1 else vol.reshape(shape + (vol.shape[-1],))
