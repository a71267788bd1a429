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

Options, with the JAX factory's semantics:

- ``level_anneal_steps`` > 0: a coarse-to-fine level curriculum. Level l's
  features are scaled by ``clip(alpha * L - l + 1, 0, 1)``, alpha =
  ``anneal_step / level_anneal_steps`` clipped to [0, 1], between encode and
  decode. The counter is an int32 buffer ``anneal_step`` (the JAX
  ``state["anneal_step"]``) that a training forward advances by one;
- ``temporal_tv`` > 0: the model's ``loss`` is MSE plus ``temporal_tv`` x
  ``encodings.hashgrid.temporal_table_tv`` of its table, whatever loss the
  trainer is configured with.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.hashgrid import HashGridEncoding, temporal_table_tv
from ..ops import fused_mlp as fm
from ..ops.hash_encode import HashEncode
from .core import BatchNorm, Dense, Model, dense_init, dropout

__all__ = ["HashGridEncoder", "HashMLP", "make_hash_mlp", "level_anneal_weights"]

_ACTS = {
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "relu": F.relu,
}
_FUSED_ACT = "relu"  # the relu_plain decoder's activation between its layers


class HashGridEncoder(nn.Module):
    """The fused hash table as a parameter, encoded by ``ops.hash_encode.HashEncode``.
    A table stored in another float type (``infer.quantize_tables``' bf16)
    is read as float32: the kernels take float32."""

    def __init__(self, geometry: HashGridEncoding, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geometry = geometry
        self.table = nn.Parameter(geometry.init(generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HashEncode.apply(as_f32(self.table), x, self.geometry)


def as_f32(table: torch.Tensor) -> torch.Tensor:
    """``table`` as float32: itself, or a float32 copy of a table stored
    narrower (the JAX package's "gathered rows promote on first use")."""
    return table if table.dtype == torch.float32 else table.float()


def level_anneal_weights(anneal_step: torch.Tensor, steps: int, geometry: HashGridEncoding) -> torch.Tensor:
    """The coarse-to-fine curriculum's per-feature weights (L*F,) at the
    counter ``anneal_step``: level l's weight is ``clip(alpha * L - l + 1, 0,
    1)``, alpha = ``anneal_step / steps`` clipped to [0, 1]; float32 in the
    JAX package's order of operations."""
    L = geometry.n_levels
    alpha = torch.clamp(anneal_step.to(torch.float32) / steps, 0.0, 1.0)
    levels = torch.arange(L, dtype=torch.float32, device=alpha.device)
    weights = torch.clamp(alpha * L - levels + 1.0, 0.0, 1.0)
    return weights.repeat_interleave(geometry.n_features_per_level)


class HashMLP(Model):
    name = "hash_mlp"

    def __init__(self, encoder: HashGridEncoder, widths: Sequence[int], decoder: str,
                 activation: str, dropout_rate: float, generator: Optional[torch.Generator] = None,
                 temporal_tv: float = 0.0, level_anneal_steps: int = 0):
        super().__init__(encoder.geometry.input_dim, widths[-1])
        self.level_anneal_steps = level_anneal_steps
        self.temporal_tv = temporal_tv
        if level_anneal_steps > 0:
            self.register_buffer("anneal_step", torch.zeros((), dtype=torch.int32))
        if temporal_tv > 0.0:
            self.loss = self.mse_with_temporal_tv
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
            return fm.fused_mlp_apply([layer.params for layer in self.layers], z, _FUSED_ACT)
        for i, layer in enumerate(self.layers):
            z = layer(z)
            if i < len(self.bn):
                z = self.bn[i](z)
                z = self.act(z)
                z = dropout(z, self.dropout_rate, self.training)
        return z

    def anneal_weights(self) -> Optional[torch.Tensor]:
        """The per-feature curriculum weights (L*F,) at the counter, or None
        without a curriculum; float32 in the JAX package's order of
        operations."""
        if self.level_anneal_steps <= 0:
            return None
        return level_anneal_weights(self.anneal_step, self.level_anneal_steps, self.encoder.geometry)

    def fused_grid_args(self) -> Optional[Tuple[torch.Tensor, List[torch.Tensor], List[float], List[int]]]:
        """The op ``hash_mlp_grid_forward``'s model arguments, detached: the float32 table, the decoder's
        ``[w_0, b_0, ...]``, its act words and the geometry key; None for an unfused decoder or a level anneal."""
        if not self.fused or self.level_anneal_steps > 0:
            return None
        params = [t.detach() for layer in self.layers for t in (layer.w, layer.b)]
        acts = list(fm.act_words(fm.mlp_acts(len(self.layers) - 1, _FUSED_ACT)))
        return as_f32(self.encoder.table).detach(), params, acts, list(self.encoder.geometry.geometry_key())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.encode(x)
        w = self.anneal_weights()
        if w is not None:
            z = z * w
            if self.training:
                with torch.no_grad():
                    self.anneal_step.add_(1)
        return self.decode(z)

    def mse_with_temporal_tv(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """MSE plus the time-axis smoothness prior on the table (the model's
        ``loss`` when ``temporal_tv`` > 0)."""
        from ..train.losses import mse_loss

        reg = temporal_table_tv(self.encoder.geometry, self.encoder.table)
        return mse_loss(self(x), y) + self.temporal_tv * reg


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
    model = HashMLP(encoder, widths, decoder, activation, dropout_rate, gen, temporal_tv, level_anneal_steps)
    return model.to(dev)
