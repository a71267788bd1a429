"""Building blocks shared by the port's models.

Port of ``mri_interpolation_tpu/models/core.py``. Layers keep the JAX
package's parameter layout, so a JAX parameter tree moves into the port as
it is (``convert.params_from_jax``): a dense weight is (dim_in, dim_out)
and the layer computes ``x @ w + b``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

__all__ = ["Model", "Dense", "BatchNorm", "uniform_init", "dense_init", "dense", "batchnorm_apply",
           "dropout"]


def uniform_init(shape: Tuple[int, ...], bound: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """float32 U(-bound, bound) of ``shape``, drawn on the CPU from ``generator``."""
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)


def dense_init(dim_in: int, dim_out: int, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Linear layer parameters {"w": (dim_in, dim_out), "b": (dim_out,)},
    U(-1/sqrt(dim_in), 1/sqrt(dim_in)) as torch's nn.Linear init."""
    bound = 1.0 / dim_in**0.5
    return {"w": uniform_init((dim_in, dim_out), bound, generator),
            "b": uniform_init((dim_out,), bound, generator)}


def dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def batchnorm_apply(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm1d over features with torch semantics: batch statistics in
    training (biased variance to normalise, the UNBIASED variance into the
    running estimate), running statistics in eval. Returns
    (y, new running mean, new running var); nothing is updated in place."""
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        n = x.shape[0]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias, new_mean, new_var


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    """Linear layer in the (dim_in, dim_out) layout holding the parameters
    ``params`` ({"w", "b"}, e.g. from :func:`dense_init`)."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {"w": self.w, "b": self.b}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.w, self.b, x)


class BatchNorm(nn.Module):
    """BatchNorm1d (affine, eps 1e-5, momentum 0.1) whose running
    statistics are buffers named as the JAX state (``mean``, ``var``)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new_mean, new_var = batchnorm_apply(x, self.scale, self.bias, self.mean, self.var,
                                               self.training, self.momentum, self.eps)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return y


class Model(nn.Module):
    """Uniform surface of the port's models: ``forward(x) -> y``; ``train()``
    and ``eval()`` choose batch or running statistics."""

    name = "model"

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dim_in, self.dim_out = dim_in, dim_out
