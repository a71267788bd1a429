"""The SIREN family: SIREN, the modulated SIREN, the hash SIREN and the PSF
SIREN.

Port of ``mri_interpolation_tpu/models/siren.py``. ``make_siren`` (reference
``SirenNet``):
``n_layers`` sine layers (the first at ``w0_initial``, the rest at ``w0``),
then a linear output layer. Initialisation: the first layer's weights and
biases U(-1/dim_in, 1/dim_in), later layers U(-sqrt(sigma/dim_in)/w0, ...).

The forward is the whole stack as one ``ops.fused_mlp.FusedMLP``: the
fused-MLP kernel pair on the card, its plain version on the CPU.
:func:`_siren_forward` is the unfused layer-by-layer version of the same
function. Parameter names mirror the JAX tree (``layers.{i}.w``,
``layers.{i}.b``, ``last.w``, ``last.b``), so ``convert.params_from_jax``
moves a JAX SIREN across unchanged.

The variants, in plain tensor code (the JAX package fuses only
``make_siren``):

- ``make_modulated_siren`` (``ModulatedSirenNet``): a ReLU modulator over
  the raw coordinates, whose layer i takes ``cat(h, x)`` and scales the
  output of sine layer i. Tree ``{"siren": {"layers", "last"},
  "modulator": [{"w", "b"}, ...]}``;
- ``make_hash_siren`` (``HashSirenNet``): the same with the modulator fed a
  hash encoding of the coordinates (``HashGridEncoder``: the hash-encode
  kernel pair on the card); tree as above plus ``"encoder": {"table"}``;
- ``make_psf_siren`` (``PsfSirenNet``): the unfused SIREN forward, trained
  through ``Model.loss`` on the slice-profile objective: each coordinate
  expands to its ``n_sample^d`` PSF offsets (:func:`psf_offsets_and_weights`),
  whose predictions a normalised Gaussian integrates back to one voxel; the
  MSE whatever loss the trainer is configured with. Tree ``{"layers",
  "last"}``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_mlp import fused_siren_apply
from .core import Dense, Model, uniform_init

__all__ = ["Siren", "make_siren", "siren_layer_init", "siren_layer_apply", "siren_init", "ModulatedSiren",
           "make_modulated_siren", "HashSiren", "make_hash_siren", "PsfSiren", "make_psf_siren",
           "psf_offsets_and_weights"]


def siren_layer_init(dim_in: int, dim_out: int, w0: float, sigma: float, is_first: bool,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    bound = (1.0 / dim_in) if is_first else (np.sqrt(sigma / dim_in) / w0)
    return {
        "w": uniform_init((dim_in, dim_out), float(bound), generator),
        "b": uniform_init((dim_out,), float(bound), generator),
    }


def siren_init(dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float, w0_initial: float,
               sigma: float, generator: Optional[torch.Generator] = None):
    """A SIREN's parameters as the JAX tree {"layers": [{"w", "b"}, ...],
    "last": {"w", "b"}}, drawn layer after layer (JAX ``_siren_init``)."""
    layers = [siren_layer_init(dim_in if i == 0 else dim_hidden, dim_hidden, w0_initial if i == 0 else w0, sigma,
                               i == 0, generator) for i in range(n_layers)]
    return {"layers": layers, "last": siren_layer_init(dim_hidden, dim_out, w0, sigma, False, generator)}


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
        tree = siren_init(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, generator)
        self.layers = nn.ModuleList(Dense(layer) for layer in tree["layers"])
        self.last = Dense(tree["last"])

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


class SineLayers(nn.Module):
    """A SIREN's parameters as the JAX tree {"layers", "last"}, with no
    forward of its own: :class:`ModulatedSiren` applies them unfused, between
    its modulations."""

    def __init__(self, tree):
        super().__init__()
        self.layers = nn.ModuleList(Dense(layer) for layer in tree["layers"])
        self.last = Dense(tree["last"])

    @property
    def params(self):
        return {"layers": [layer.params for layer in self.layers], "last": self.last.params}


class ModulatedSiren(Model):
    """SIREN whose sine layer i is scaled by modulation i of a ReLU network
    over ``latent(x)``: the raw coordinates here, a hash encoding in
    :class:`HashSiren`."""

    name = "modulated_siren"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float, w0_initial: float,
                 sigma: float, dim_latent: int, generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        self.n_layers, self.w0, self.w0_initial = n_layers, w0, w0_initial
        self.siren = SineLayers(siren_init(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, generator))
        mods = []
        for i in range(n_layers):
            d = dim_latent if i == 0 else dim_hidden + dim_latent
            bound = float(1.0 / np.sqrt(d))
            mods.append(Dense({"w": uniform_init((d, dim_hidden), bound, generator),
                               "b": uniform_init((dim_hidden,), bound, generator)}))
        self.modulator = nn.ModuleList(mods)

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lat = self.latent(x)
        h, mods = lat, []
        for layer in self.modulator:
            h = torch.relu(layer(h))
            mods.append(h)
            h = torch.cat([h, lat], dim=-1)
        params = self.siren.params
        y = x
        for i in range(self.n_layers):
            y = siren_layer_apply(params["layers"][i], y, self.w0_initial if i == 0 else self.w0) * mods[i]
        return siren_layer_apply(params["last"], y, self.w0, sine=False)


class HashSiren(ModulatedSiren):
    """The modulated SIREN with its modulator fed the hash encoding of the
    coordinates (``HashGridEncoder``: kernels 1-2 on the card)."""

    name = "hash_siren"

    def __init__(self, encoder, dim_hidden: int, dim_out: int, n_layers: int, w0: float, w0_initial: float,
                 sigma: float, generator: Optional[torch.Generator] = None):
        geometry = encoder.geometry
        super().__init__(geometry.input_dim, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma,
                         geometry.output_dim, generator)
        self.encoder = encoder

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


def psf_offsets_and_weights(coordinates_spacing: Sequence[float], n_sample: int = 5
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """PSF offsets (n_sample^d, d): the 'ij' meshgrid of ``linspace(-s_i,
    s_i, n_sample)`` per axis; and their weights (n_sample^d,): a separable
    Gaussian of sigma 1 / 2.3548 on ``linspace(-0.5, 0.5, n_sample)``,
    normalised to sum 1. Computed in float64, returned as float32, in the JAX
    package's order of operations."""
    d = len(coordinates_spacing)
    axes = [np.linspace(-s, s, n_sample) for s in coordinates_spacing]
    offsets = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, d).astype(np.float32)
    sigma = 1.0 / 2.3548
    unit = np.linspace(-0.5, 0.5, n_sample)
    grids = np.meshgrid(*([unit] * d), indexing="ij")
    psf = np.ones_like(grids[0])
    for g in grids:
        psf = psf * np.exp(-g * g / (2 * sigma * sigma))
    return offsets, (psf / psf.sum()).reshape(-1).astype(np.float32)


class PsfSiren(Siren):
    """SIREN with the PSF slice-profile objective as its ``loss``; the
    forward (inference) is the plain unfused SIREN."""

    name = "psf_siren"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float, w0_initial: float,
                 sigma: float, coordinates_spacing: Sequence[float], n_sample: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, generator)
        offsets, weights = psf_offsets_and_weights(coordinates_spacing, n_sample)
        self.register_buffer("offsets", torch.from_numpy(offsets), persistent=False)  # (K, d)
        self.register_buffer("psf_weights", torch.from_numpy(weights), persistent=False)  # (K,)
        self.loss = self.psf_loss

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _siren_forward(self.params, x, self.n_layers, self.w0, self.w0_initial)

    def psf_loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """MSE of the PSF-integrated prediction: every voxel centre expands
        to its K offsets, one (B*K, d) forward, then the Gaussian weighted
        sum over K."""
        xp = (x[:, None, :] + self.offsets).reshape(-1, x.shape[-1])
        z = self(xp).reshape(x.shape[0], self.offsets.shape[0], -1)
        z = torch.einsum("bkf,k->bf", z, self.psf_weights)
        return torch.mean((z - y) ** 2)


def make_modulated_siren(
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
) -> ModulatedSiren:
    """The modulated SIREN with the JAX factory's defaults; parameters drawn
    on the CPU from ``torch.Generator().manual_seed(seed)`` (the SIREN, then
    the modulator) and moved to ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = ModulatedSiren(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, dim_in, gen)
    model.hparams = {"lr": lr}
    return model.to(dev)


def make_hash_siren(
    dim_in: int = 3,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 4,
    w0: float = 30.0,
    w0_initial: float = 30.0,
    sigma: float = 6.0,
    lr: float = 1e-4,
    n_levels: int = 16,
    n_features_per_level: int = 2,
    log2_hashmap_size: int = 19,
    base_resolution: Union[int, Sequence[int]] = 16,
    per_level_scale: float = 1.4,
    seed: int = 0,
    device: DeviceLike = None,
) -> HashSiren:
    """The hash SIREN with the JAX factory's defaults (its encoder grows by
    ``per_level_scale``; storage dense where a level fits the 2^log2 budget,
    else hashed); parameters drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (the table, the SIREN, the
    modulator) and moved to ``device`` (``cuda`` unless ``"cpu"``)."""
    from ..encodings.hashgrid import HashGridEncoding
    from .hash_mlp import HashGridEncoder

    dev = resolve_device(device)
    geometry = HashGridEncoding(dim=dim_in, n_levels=n_levels, n_features_per_level=n_features_per_level,
                                log2_hashmap_size=log2_hashmap_size, base_resolution=base_resolution,
                                finest_resolution=None, per_level_scale=per_level_scale)
    gen = torch.Generator().manual_seed(seed)
    model = HashSiren(HashGridEncoder(geometry, gen), dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, gen)
    model.hparams = {"lr": lr}
    return model.to(dev)


def make_psf_siren(
    dim_in: int = 3,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 4,
    w0: float = 30.0,
    w0_initial: float = 30.0,
    sigma: float = 6.0,
    lr: float = 1e-4,
    coordinates_spacing: Optional[Sequence[float]] = None,
    n_sample: int = 5,
    seed: int = 0,
    device: DeviceLike = None,
) -> PsfSiren:
    """The PSF SIREN with the JAX factory's defaults; ``coordinates_spacing``
    (the half-voxel extents in normalised coordinates; the launcher passes
    ``0.5 / max(s - 1, 1)`` per spatial axis) is required. Parameters drawn
    on the CPU from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device`` (``cuda`` unless ``"cpu"``)."""
    if coordinates_spacing is None:
        raise ValueError("psf_siren needs coordinates_spacing (half-voxel extents in normalized coords)")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = PsfSiren(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, coordinates_spacing, n_sample,
                     gen)
    model.hparams = {"lr": lr, "n_sample": n_sample, "coordinates_spacing": tuple(coordinates_spacing)}
    return model.to(dev)
