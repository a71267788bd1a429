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

The variants (the JAX package fuses only ``make_siren``):

- ``make_modulated_siren`` (``ModulatedSirenNet``): a ReLU modulator over
  the raw coordinates, whose layer i takes ``cat(h, x)`` and scales the
  output of sine layer i. Tree ``{"siren": {"layers", "last"},
  "modulator": [{"w", "b"}, ...]}``. The sine layers run as the PSF SIREN's
  (:func:`_sine_layers_forward`: cuBLAS's product, then one ``SineLayer``),
  each then multiplied by its modulation; the modulator's layers, ReLUs
  and concatenations run inside the span ``mri.model.modulator``, and
  :data:`MODULATOR_ROWS` counts rows x layers they took;
- ``make_hash_siren`` (``HashSirenNet``): the same with the modulator fed a
  hash encoding of the coordinates (``HashGridEncoder``: the hash-encode
  kernel pair on the card); tree as above plus ``"encoder": {"table"}``;
- ``make_psf_siren`` (``PsfSirenNet``): the SIREN forward layer by layer
  (:func:`_sine_layers_forward`: each product by cuBLAS, each sine layer's
  bias, w0 scale and sine as one ``ops.sine_layer.SineLayer``, the
  sine-layer kernel pair on the card), trained
  through ``Model.loss`` on the slice-profile objective: each coordinate
  expands to its ``n_sample^d`` PSF offsets (:func:`psf_offsets_and_weights`),
  whose predictions a normalised Gaussian integrates back to one voxel; the
  MSE whatever loss the trainer is configured with. Tree ``{"layers",
  "last"}``. The expansion and the integration each open a span
  (``mri.model.psf_expand``, ``mri.model.psf_integrate``), and
  :data:`PSF_ROWS` counts the rows the objective fed the SIREN.

The sine-layer kernels read rows as float4, so on a CUDA device the three
variants take a ``dim_hidden`` that is a multiple of 4: their factories
refuse another width there (:func:`check_card_width`), which runs on the
CPU alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_mlp import fused_siren_apply
from ..ops.sine_layer import SineLayer
from ..tracing import span
from .core import Dense, Model, uniform_init

__all__ = ["Siren", "make_siren", "siren_layer_init", "siren_layer_apply", "siren_init", "ModulatedSiren",
           "make_modulated_siren", "HashSiren", "make_hash_siren", "PsfSiren", "make_psf_siren",
           "psf_offsets_and_weights", "PSF_ROWS", "reset_psf_rows", "MODULATOR_ROWS", "reset_modulator_rows",
           "check_card_width"]

PSF_ROWS = {"psf_siren": 0}  # rows (B * K a call) that PsfSiren.psf_loss fed the SIREN
MODULATOR_ROWS = {"hash_siren": 0, "modulated_siren": 0}  # rows x layers that a model's modulator took


def reset_psf_rows() -> None:
    for name in PSF_ROWS:
        PSF_ROWS[name] = 0


def reset_modulator_rows() -> None:
    for name in MODULATOR_ROWS:
        MODULATOR_ROWS[name] = 0


def check_card_width(name: str, dim_hidden: int, dev: torch.device) -> None:
    """Refuses, on a CUDA device, a width the sine-layer kernels cannot
    take (a multiple of 4 only); any width on the CPU."""
    if dev.type == "cuda" and dim_hidden % 4:
        raise ValueError(f"{name} on {dev}: the sine-layer kernels take a dim_hidden (--dim_hidden) that is a "
                         f"multiple of 4, not {dim_hidden}; other widths run on the CPU alone (device='cpu')")


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


def _sine_layers_forward(params, x: torch.Tensor, n_layers: int, w0: float, w0_initial: float,
                         mods: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """:func:`_siren_forward`'s function with each sine layer's bias, w0
    scale and sine in one :class:`SineLayer` after its product; with
    ``mods``, sine layer i's output multiplied by ``mods[i]`` (the
    modulated SIREN). Leading dimensions are taken as rows: the kernels
    take (n, width)."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    for i in range(n_layers):
        layer = params["layers"][i]
        x = SineLayer.apply(x @ layer["w"], layer["b"], w0_initial if i == 0 else w0)
        if mods is not None:
            x = x * mods[i].reshape(x.shape)
    return (x @ params["last"]["w"] + params["last"]["b"]).reshape(*lead, -1)


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
    forward of its own: :class:`ModulatedSiren` applies them layer by layer,
    each sine layer's output multiplied by its modulation."""

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

    def modulations(self, lat: torch.Tensor) -> List[torch.Tensor]:
        """The modulator's outputs over the latent ``lat``, one a sine layer:
        layer i is ``relu(cat(h_{i-1}, lat) @ w + b)``, the first ``relu(lat
        @ w + b)``."""
        MODULATOR_ROWS[self.name] += lat.numel() // lat.shape[-1] * len(self.modulator)
        with span("mri.model.modulator"):
            h, mods = lat, []
            for i, layer in enumerate(self.modulator):
                if i:
                    h = torch.cat([h, lat], dim=-1)
                h = torch.relu(layer(h))
                mods.append(h)
            return mods

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = self.modulations(self.latent(x))
        return _sine_layers_forward(self.siren.params, x, self.n_layers, self.w0, self.w0_initial, mods)


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
    forward is the SIREN layer by layer, cuBLAS's products and one
    :class:`SineLayer` a sine layer (:func:`_sine_layers_forward`)."""

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
        return _sine_layers_forward(self.params, x, self.n_layers, self.w0, self.w0_initial)

    def psf_loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """MSE of the PSF-integrated prediction: every voxel centre expands
        to its K offsets, one (B*K, d) forward, then the Gaussian weighted
        sum over K."""
        with span("mri.model.psf_expand"):
            xp = (x[:, None, :] + self.offsets).reshape(-1, x.shape[-1])
        PSF_ROWS["psf_siren"] += xp.shape[0]
        z = self(xp).reshape(x.shape[0], self.offsets.shape[0], -1)
        with span("mri.model.psf_integrate"):
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
    check_card_width("modulated_siren", dim_hidden, dev)
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
    check_card_width("hash_siren", dim_hidden, dev)
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
    check_card_width("psf_siren", dim_hidden, dev)
    gen = torch.Generator().manual_seed(seed)
    model = PsfSiren(dim_in, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma, coordinates_spacing, n_sample,
                     gen)
    model.hparams = {"lr": lr, "n_sample": n_sample, "coordinates_spacing": tuple(coordinates_spacing)}
    return model.to(dev)
