"""NeRF-style frequency (positional) encoding.

Port of ``mri_interpolation_tpu/encodings/frequency.py``: for each input
dimension d the features are [sin(2^0 x_d), ..., sin(2^{L-1} x_d),
cos(2^0 x_d), ..., cos(2^{L-1} x_d)], flattened dim-major, so the output
has dim * n_levels * 2 features. The frequencies are computed in float64 by
numpy and cast to float32, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FrequencyEncoding"]


class FrequencyEncoding:
    """Stateless positional encoding with dyadic frequencies."""

    def __init__(self, dim: int, n_levels: int = 10):
        if n_levels <= 0:
            raise ValueError(f"n_levels must be positive, got {n_levels}")
        self.input_dim = dim
        self.n_levels = n_levels
        self.output_dim = dim * n_levels * 2
        self.freqs = torch.from_numpy((2.0 ** np.linspace(0.0, n_levels - 1, n_levels)).astype(np.float32))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        z = x[..., None] * self.freqs.to(x.device)  # (..., dim, L)
        z = torch.cat([torch.sin(z), torch.cos(z)], dim=-1)  # (..., dim, 2L)
        return z.reshape(*z.shape[:-2], self.output_dim)
