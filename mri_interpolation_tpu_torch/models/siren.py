"""SIREN: a sine-activated MLP over raw coordinates.

Port of ``make_siren`` and its building blocks in
``mri_interpolation_tpu/models/siren.py`` (reference ``SirenNet``):
``n_layers`` sine layers (the first at ``w0_initial``, the rest at ``w0``),
then a linear output layer. Initialisation: the first layer's weights and
biases U(-1/dim_in, 1/dim_in), later layers U(-sqrt(sigma/dim_in)/w0, ...).

The forward is the whole stack as one ``ops.fused_mlp.FusedMLP``: the
fused-MLP kernel pair on the card, its plain version on the CPU.
:func:`_siren_forward` is the unfused layer-by-layer version of the same
function. Parameter names mirror the JAX tree (``layers.{i}.w``,
``layers.{i}.b``, ``last.w``, ``last.b``), so ``convert.params_from_jax``
moves a JAX SIREN across unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_mlp import fused_siren_apply
from .core import Dense, Model, uniform_init

__all__ = ["Siren", "make_siren", "siren_layer_init", "siren_layer_apply"]


def siren_layer_init(dim_in: int, dim_out: int, w0: float, sigma: float, is_first: bool,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    bound = (1.0 / dim_in) if is_first else (np.sqrt(sigma / dim_in) / w0)
    return {
        "w": uniform_init((dim_in, dim_out), float(bound), generator),
        "b": uniform_init((dim_out,), float(bound), generator),
    }


def siren_layer_apply(params, x: torch.Tensor, w0: float, sine: bool = True) -> torch.Tensor:
    z = x @ params["w"] + params["b"]
    return torch.sin(w0 * z) if sine else z


def _siren_forward(params, x: torch.Tensor, n_layers: int, w0: float, w0_initial: float) -> torch.Tensor:
    """The unfused reference: one layer at a time."""
    for i in range(n_layers):
        x = siren_layer_apply(params["layers"][i], x, w0_initial if i == 0 else w0)
    return siren_layer_apply(params["last"], x, w0, sine=False)


class Siren(Model):
    name = "siren"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float,
                 w0_initial: float, sigma: float, generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        self.n_layers, self.w0, self.w0_initial = n_layers, w0, w0_initial
        self.layers = nn.ModuleList(
            Dense(siren_layer_init(dim_in if i == 0 else dim_hidden, dim_hidden,
                                   w0_initial if i == 0 else w0, sigma, i == 0, generator))
            for i in range(n_layers))
        self.last = Dense(siren_layer_init(dim_hidden, dim_out, w0, sigma, False, generator))

    @property
    def params(self):
        """The parameters as the JAX tree {"layers": [{"w", "b"}, ...], "last": {"w", "b"}}."""
        return {"layers": [layer.params for layer in self.layers], "last": self.last.params}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_siren_apply(self.params, x, self.n_layers, self.w0, self.w0_initial)


def make_siren(
    dim_in: int = 3,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 4,
    w0: float = 30.0,
    w0_initial: float = 30.0,
    sigma: float = 6.0,
    lr: float = 1e-4,
    seed: int = 0,
    device: DeviceLike = None,
) -> Siren:
    """Canonical SIREN with the JAX factory's defaults (``lr`` is recorded in
    ``hparams``, as there, and not used by the model). Parameters are drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` and moved to ``device``
    (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = Siren(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, gen)
    model.hparams = {"lr": lr, "dim_hidden": dim_hidden, "n_layers": n_layers, "w0": w0}
    return model.to(dev)
