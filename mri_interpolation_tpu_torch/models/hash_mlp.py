"""HashMLP: multiresolution hash encoding + small decoder MLP.

Port of ``mri_interpolation_tpu/models/hash_mlp.py`` (the flagship model).
The encoder runs the hash-encode kernel pair on the card
(``ops/hash_encode.py``) and its plain version on the CPU. The decoder:

- ``"norm"``: every block, the last one to dim_out included, is
  Linear -> BatchNorm -> act -> Dropout (the reference's quirk), in plain
  tensor code;
- ``"norm_proper"``: the same, but the final Linear is plain;
- ``"relu_plain"``: the tcnn FullyFusedMLP shape, ReLU between the layers
  and an identity output, no norm and no dropout. The whole stack is one
  ``ops.fused_mlp.FusedMLP`` (the fused-MLP kernel pair on the card), whose
  backward hands the input cotangent on to the hash-encode table gradient.

GELU is the tanh approximation, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.hashgrid import HashGridEncoding
from ..ops.fused_mlp import fused_mlp_apply
from ..ops.hash_encode import HashEncode
from .core import BatchNorm, Dense, Model, dense_init, dropout

__all__ = ["HashGridEncoder", "HashMLP", "make_hash_mlp"]

_ACTS = {
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "relu": F.relu,
}


class HashGridEncoder(nn.Module):
    """The fused hash table as a parameter, encoded by ``ops.hash_encode.HashEncode``."""

    def __init__(self, geometry: HashGridEncoding, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geometry = geometry
        self.table = nn.Parameter(geometry.init(generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HashEncode.apply(self.table, x, self.geometry)


class HashMLP(Model):
    name = "hash_mlp"

    def __init__(self, encoder: HashGridEncoder, widths: Sequence[int], decoder: str,
                 activation: str, dropout_rate: float, generator: Optional[torch.Generator] = None):
        super().__init__(encoder.geometry.input_dim, widths[-1])
        n_layers = len(widths) - 1
        self.dropout_rate = dropout_rate
        self.fused = decoder == "relu_plain"
        self.act = _ACTS[activation]
        self.layers = nn.ModuleList(Dense(dense_init(widths[i], widths[i + 1], generator))
                                    for i in range(n_layers))
        n_normed = {"norm": n_layers, "norm_proper": n_layers - 1, "relu_plain": 0}[decoder]
        self.bn = nn.ModuleList(BatchNorm(widths[i + 1]) for i in range(n_normed))
        self.encoder = encoder

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Dropout draws from torch's default generator of z's device."""
        if self.fused:
            return fused_mlp_apply([layer.params for layer in self.layers], z, "relu")
        for i, layer in enumerate(self.layers):
            z = layer(z)
            if i < len(self.bn):
                z = self.bn[i](z)
                z = self.act(z)
                z = dropout(z, self.dropout_rate, self.training)
        return z

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def make_hash_mlp(
    dim_in: int,
    n_levels: int = 4,
    n_features_per_level: int = 1,
    log2_hashmap_size: int = 23,
    base_resolution: Union[int, Sequence[int]] = (64, 64, 5),
    finest_resolution: Union[int, Sequence[int], None] = (352, 352, 15),
    per_level_scale: Optional[float] = None,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 2,
    activation: str = "gelu",
    dropout_rate: float = 0.0,
    decoder: str = "norm",
    growth: str = "reference",
    storage: str = "auto",
    temporal_tv: float = 0.0,
    level_anneal_steps: int = 0,
    seed: int = 0,
    device: DeviceLike = None,
) -> HashMLP:
    """The flagship HashMLP, with the JAX factory's defaults. Parameters are
    drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and moved
    to ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    if decoder not in ("norm", "norm_proper", "relu_plain"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if level_anneal_steps > 0:
        raise NotImplementedError("level_anneal_steps is not ported yet: ROADMAP.md, queue 1")
    if temporal_tv > 0.0:
        raise NotImplementedError("temporal_tv is not ported yet: ROADMAP.md, queue 1")
    geometry = HashGridEncoding(
        dim=dim_in,
        n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        log2_hashmap_size=log2_hashmap_size,
        base_resolution=base_resolution,
        finest_resolution=finest_resolution,
        per_level_scale=per_level_scale,
        growth=growth,
        storage=storage,
    )
    gen = torch.Generator().manual_seed(seed)
    widths = [geometry.output_dim] + [dim_hidden] * (n_layers - 1) + [dim_out]
    encoder = HashGridEncoder(geometry, gen)
    model = HashMLP(encoder, widths, decoder, activation, dropout_rate, gen)
    return model.to(dev)
