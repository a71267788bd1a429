"""Gabor / WIRE networks: real and complex Gabor wavelet activations.

Port of ``mri_interpolation_tpu/models/gabor.py``. ``make_gabor_net``
(``GaborNet``), ``n_layers`` Gabor layers, the last to dim_out:

- ``kind="real"``: layer ``{"freqs": {"w", "b"}, "scale": {"w", "b"}}``,
  output ``cos(w0 * freqs(x)) * exp(-(sigma * scale(x))^2)``. Init
  ``"auto"``: ``freqs`` U(+-1/d) in the first layer and U(+-sqrt(6/d)/w0)
  after, ``scale`` U(+-0.5/(max(sigma, 1e-3) sqrt(d))); ``"torch"``: both
  Linears at torch's default init;
- ``kind="complex"``: layer ``{"lin": {"w", "b"}}``, real in the first
  layer and complex64 after, output ``exp(i w0 z - |sigma z|^2)`` of ``z =
  lin(x)``; the network's value is the real part of the last layer's. Which
  layers are complex is a Python attribute (the JAX tree's ``"complex"``
  bool leaf, which ``convert.params_from_jax`` skips).

``Trainer.fit`` refuses complex parameters (ROADMAP.md, section 3): the
JAX trainer cannot fit this kind either. Plain tensor code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .core import Dense, Model, dense_init, uniform_init

__all__ = ["GaborNet", "make_gabor_net"]


class RealGaborLayer(nn.Module):
    def __init__(self, freqs, scale):
        super().__init__()
        self.freqs = Dense(freqs)
        self.scale = Dense(scale)

    def forward(self, x: torch.Tensor, w0: float, sigma: float) -> torch.Tensor:
        return torch.cos(w0 * self.freqs(x)) * torch.exp(-((self.scale(x) * sigma) ** 2))


class ComplexGaborLayer(nn.Module):
    def __init__(self, lin, complex_weights: bool):
        super().__init__()
        self.lin = Dense(lin)
        self.complex = complex_weights

    def forward(self, z: torch.Tensor, w0: float, sigma: float) -> torch.Tensor:
        lin = self.lin(z)
        return torch.exp(1j * w0 * lin - torch.abs(sigma * lin) ** 2)


def _complex_dense_init(dim_in: int, dim_out: int, generator: Optional[torch.Generator]):
    """torch's cfloat Linear init: U(+-1/sqrt(dim_in)) for the real and the
    imaginary parts alike."""
    bound = float(1.0 / np.sqrt(dim_in))
    parts = [uniform_init(shape, bound, generator) for shape in ((dim_in, dim_out),) * 2 + ((dim_out,),) * 2]
    return {"w": torch.complex(parts[0], parts[1]), "b": torch.complex(parts[2], parts[3])}


class GaborNet(Model):
    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float, sigma: float,
                 kind: str, init_scheme: str, generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        if kind not in ("real", "complex"):
            raise ValueError(f"unknown gabor kind {kind!r}")
        self.name = f"gabor_{kind}"
        self.w0, self.sigma = w0, sigma
        self.complex = kind == "complex"
        dims = [dim_in] + [dim_hidden] * (n_layers - 1) + [dim_out]
        layers = []
        for i in range(n_layers):
            if self.complex:
                lin = (dense_init(dims[i], dims[i + 1], generator) if i == 0
                       else _complex_dense_init(dims[i], dims[i + 1], generator))
                layers.append(ComplexGaborLayer(lin, i > 0))
            elif init_scheme == "auto":
                fb = 1.0 / dims[i] if i == 0 else float(np.sqrt(6.0 / dims[i]) / w0)
                sb = float(0.5 / (max(sigma, 1e-3) * np.sqrt(dims[i])))
                freqs = {"w": uniform_init((dims[i], dims[i + 1]), fb, generator),
                         "b": uniform_init((dims[i + 1],), fb, generator)}
                scale = {"w": uniform_init((dims[i], dims[i + 1]), sb, generator),
                         "b": uniform_init((dims[i + 1],), sb, generator)}
                layers.append(RealGaborLayer(freqs, scale))
            elif init_scheme == "torch":
                layers.append(RealGaborLayer(dense_init(dims[i], dims[i + 1], generator),
                                             dense_init(dims[i], dims[i + 1], generator)))
            else:
                raise ValueError(f"unknown init_scheme {init_scheme!r}")
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, self.w0, self.sigma)
        return torch.real(x) if self.complex else x


def make_gabor_net(
    dim_in: int = 3,
    dim_hidden: int = 128,
    dim_out: int = 1,
    n_layers: int = 4,
    w0: float = 30.0,
    sigma: float = 10.0,
    lr: float = 3e-4,
    kind: str = "real",
    init_scheme: str = "auto",
    seed: int = 0,
    device: DeviceLike = None,
) -> GaborNet:
    """GaborNet with the JAX factory's defaults (``sigma`` is the Gabor scale
    c); parameters drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and moved to ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    model = GaborNet(dim_in, dim_hidden, dim_out, n_layers, w0, sigma, kind, init_scheme,
                     torch.Generator().manual_seed(seed))
    model.hparams = {"lr": lr, "w0": w0, "sigma": sigma}
    return model.to(dev)
