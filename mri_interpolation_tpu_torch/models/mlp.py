"""Plain coordinate MLPs: BaseMLP (ReLU) and RffNet (Fourier features + MLP).

Port of ``mri_interpolation_tpu/models/mlp.py``:

- ``make_mlp`` (``BaseMLP``): ``n_layers`` Linear layers, each followed by
  the activation, the last one included (the reference's quirk); tree
  ``{"layers": [{"w", "b"}, ...]}``;
- ``make_rff_net`` (``RffNet``): the Gaussian random-Fourier-feature
  encoder (``encodings.fourier``, 2 * n_frequencies features, its ``b``
  trained) before the same stack; tree ``{"encoder": {"b"}, "layers"}``.

Activations as the JAX ``_ACTIVATIONS``: relu, gelu (the tanh
approximation, ``jax.nn.gelu``'s default) and identity. Plain tensor code:
the JAX package fuses none of these models.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.fourier import GaussianFourierEncoding
from .core import Dense, Model, dense_init

__all__ = ["BaseMLP", "RffNet", "make_mlp", "make_rff_net", "ACTIVATIONS"]

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "identity": lambda z: z,
}


def _stack(dims, generator: Optional[torch.Generator]) -> nn.ModuleList:
    return nn.ModuleList(Dense(dense_init(dims[i], dims[i + 1], generator)) for i in range(len(dims) - 1))


class BaseMLP(Model):
    name = "mlp"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, activation: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        self.act = ACTIVATIONS[activation]
        self.layers = _stack([dim_in] + [dim_hidden] * (n_layers - 1) + [dim_out], generator)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            z = self.act(layer(z))  # the activation after every layer, the last one included
        return z

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(x)


class RffNet(BaseMLP):
    name = "rff_net"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, n_frequencies: int,
                 sigma: float, activation: str, generator: Optional[torch.Generator] = None):
        encoder = GaussianFourierEncoding(dim_in, n_frequencies, sigma, generator)
        super().__init__(encoder.output_dim, dim_hidden, dim_out, n_layers, activation, generator)
        self.dim_in = dim_in
        self.encoder = encoder

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encoder(x))


def make_mlp(
    dim_in: int = 2,
    dim_hidden: int = 128,
    dim_out: int = 1,
    n_layers: int = 8,
    activation: str = "relu",
    lr: float = 1e-4,
    seed: int = 0,
    device: DeviceLike = None,
) -> BaseMLP:
    """BaseMLP with the JAX factory's defaults; parameters drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` and moved to ``device``
    (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    model = BaseMLP(dim_in, dim_hidden, dim_out, n_layers, activation, torch.Generator().manual_seed(seed))
    model.hparams = {"lr": lr, "dim_hidden": dim_hidden, "n_layers": n_layers}
    return model.to(dev)


def make_rff_net(
    dim_in: int = 3,
    dim_hidden: int = 128,
    dim_out: int = 1,
    n_layers: int = 8,
    n_frequencies: int = 128,
    sigma: float = 10.0,
    activation: str = "relu",
    lr: float = 1e-4,
    seed: int = 0,
    device: DeviceLike = None,
) -> RffNet:
    """RffNet with the JAX factory's defaults; parameters drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` (B, then the stack) and
    moved to ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    model = RffNet(dim_in, dim_hidden, dim_out, n_layers, n_frequencies, sigma, activation,
                   torch.Generator().manual_seed(seed))
    model.hparams = {"lr": lr, "n_frequencies": n_frequencies, "sigma": sigma}
    return model.to(dev)
