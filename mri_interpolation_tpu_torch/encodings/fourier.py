"""Gaussian random Fourier features.

Port of ``mri_interpolation_tpu/encodings/fourier.py``: gamma(v) =
[cos(2 pi B v), sin(2 pi B v)] with B ~ N(0, sigma^2) of shape
(encoded_size, dim), the parameter ``b`` (the JAX tree ``{"b": B}``).

``B`` is a trained parameter: the JAX trainer updates every leaf of the
tree, though the reference keeps it as a fixed buffer; the port follows the
JAX package (ROADMAP.md, section 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["GaussianFourierEncoding"]

_TWO_PI = 6.283185307179586


class GaussianFourierEncoding(nn.Module):
    """``b`` drawn N(0, sigma^2) on the CPU from ``generator``."""

    def __init__(self, dim: int, encoded_size: int = 128, sigma: float = 10.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim = dim
        self.encoded_size = encoded_size
        self.sigma = float(sigma)
        self.output_dim = encoded_size * 2
        self.b = nn.Parameter(self.sigma * torch.randn((encoded_size, dim), generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = _TWO_PI * (x @ self.b.T)
        return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
