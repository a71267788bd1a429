"""Imaging utilities: a copy of ``create_rn_mask`` from
``mri_interpolation_tpu/utils/imaging.py`` (the port imports nothing of the
JAX package), drawn from a ``torch.Generator`` in place of a JAX key."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["create_rn_mask"]


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
