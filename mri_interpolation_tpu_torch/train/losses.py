"""Training objectives (port of ``mri_interpolation_tpu/train/losses.py``).

- ``mse``: the reference's criterion;
- ``relative_l2``: tcnn's RelativeL2, (y_pred - y)^2 / (y_pred^2 + 0.01).
"""

from __future__ import annotations

import torch

__all__ = ["mse_loss", "relative_l2_loss", "get_loss"]


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def relative_l2_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    return torch.mean((pred - target) ** 2 / (pred.square() + eps))


_LOSSES = {"mse": mse_loss, "relative_l2": relative_l2_loss}


def get_loss(name: str):
    if name not in _LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(_LOSSES)}")
    return _LOSSES[name]
