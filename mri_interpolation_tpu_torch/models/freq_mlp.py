"""FreqMLP: spatial and temporal encoders and a skip-connected decoder.

Port of ``mri_interpolation_tpu/models/freq_mlp.py`` (the reference's 4-D
experiment model). The input splits into the spatial coordinates
``x[:, :dim_in-1]`` and the time ``x[:, -1]``; each goes through its own
encoder of one family:

- ``"gabor"``: two real Gabor layers in space (``w0``, c = ``sigma``), one
  in time (``w0_t``, ``sigma_t``), torch's default init;
- ``"siren"``: two SIREN layers in space at ``w0``, one in time at ``w0_t``;
- ``"frequency"``: the dyadic frequency encoding (``n_frequencies`` levels
  in space, ``n_frequencies_t`` in time; no parameters);
- ``"rff"``: Gaussian Fourier features (trained ``b``, as in RffNet).

The decoder: ``n_layers`` blocks of spectral-norm Linear -> BatchNorm ->
GELU (tanh), the last block included; before block i in
``skip_connections`` the encoding is concatenated in front of the block's
input. Tree: params ``{"encoder", "encoder_t", "layers", "bn"}``, state
``{"bn": [{"mean", "var"}], "sn": [{"u"}]}``. ``weight_decay`` is recorded
in ``hparams``, as in JAX; the trainer takes its own. Plain tensor code.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.fourier import GaussianFourierEncoding
from ..encodings.frequency import FrequencyEncoding
from .core import BatchNorm, Dense, Model, SpectralNorm, dense_init
from .gabor import RealGaborLayer
from .siren import siren_layer_apply, siren_layer_init

__all__ = ["FreqMLP", "make_freq_mlp", "ENCODER_TYPES"]

ENCODER_TYPES = ("gabor", "siren", "frequency", "rff")


class FreqMLP(Model):
    name = "freq_mlp"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, skip_connections: Sequence[int],
                 encoder_type: str, w0: float, n_frequencies: int, sigma: float, w0_t: float, n_frequencies_t: int,
                 sigma_t: float, generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        if encoder_type not in ENCODER_TYPES:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        d = dim_in - 1
        self.d_space, self.encoder_type = d, encoder_type
        self.w0, self.sigma, self.w0_t, self.sigma_t = w0, sigma, w0_t, sigma_t
        self.skip_connections = tuple(skip_connections)
        g = generator
        if encoder_type == "gabor":
            gabor = lambda a, b: RealGaborLayer(dense_init(a, b, g), dense_init(a, b, g))  # noqa: E731
            self.encoder = nn.ModuleList([gabor(d, n_frequencies), gabor(n_frequencies, n_frequencies)])
            self.encoder_t = gabor(1, n_frequencies_t)
            enc_dim = n_frequencies + n_frequencies_t
        elif encoder_type == "siren":
            self.encoder = nn.ModuleList([Dense(siren_layer_init(d, n_frequencies, w0, sigma, True, g)),
                                          Dense(siren_layer_init(n_frequencies, n_frequencies, w0, sigma, False, g))])
            self.encoder_t = Dense(siren_layer_init(1, n_frequencies_t, w0_t, sigma_t, True, g))
            enc_dim = n_frequencies + n_frequencies_t
        elif encoder_type == "frequency":
            self.freq = FrequencyEncoding(d, n_frequencies)
            self.freq_t = FrequencyEncoding(1, n_frequencies_t)
            enc_dim = self.freq.output_dim + self.freq_t.output_dim
        else:
            self.encoder = GaussianFourierEncoding(d, n_frequencies, sigma, g)
            self.encoder_t = GaussianFourierEncoding(1, n_frequencies_t, sigma_t, g)
            enc_dim = 2 * (n_frequencies + n_frequencies_t)
        widths = []
        for i in range(n_layers):
            w_in = enc_dim if i == 0 else (enc_dim + dim_hidden if i in self.skip_connections else dim_hidden)
            widths.append((w_in, dim_out if i == n_layers - 1 else dim_hidden))
        self.layers = nn.ModuleList(Dense(dense_init(a, b, g)) for a, b in widths)
        self.bn = nn.ModuleList(BatchNorm(b) for _, b in widths)
        self.sn = nn.ModuleList(SpectralNorm(b, g) for _, b in widths)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        coords, t = x[..., :self.d_space], x[..., -1:]
        if self.encoder_type == "gabor":
            z = self.encoder[1](self.encoder[0](coords, self.w0, self.sigma), self.w0, self.sigma)
            zt = self.encoder_t(t, self.w0_t, self.sigma_t)
        elif self.encoder_type == "siren":
            z = siren_layer_apply(self.encoder[0].params, coords, self.w0)
            z = siren_layer_apply(self.encoder[1].params, z, self.w0)
            zt = siren_layer_apply(self.encoder_t.params, t, self.w0_t)
        elif self.encoder_type == "frequency":
            z, zt = self.freq(coords), self.freq_t(t)
        else:
            z, zt = self.encoder(coords), self.encoder_t(t)
        return torch.cat([z, zt], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = skip = self.encode(x)
        for i, (layer, bn, sn) in enumerate(zip(self.layers, self.bn, self.sn)):
            if i in self.skip_connections:
                z = torch.cat([skip, z], dim=-1)
            z = z @ sn(layer.w) + layer.b
            z = F.gelu(bn(z), approximate="tanh")
        return z


def make_freq_mlp(
    dim_in: int = 3,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 4,
    skip_connections: Sequence[int] = (),
    encoder_type: str = "siren",
    w0: float = 30.0,
    n_frequencies: int = 352,
    sigma: float = 6.0,
    w0_t: float = 30.0,
    n_frequencies_t: int = 15,
    sigma_t: float = 6.0,
    lr: float = 5e-3,
    weight_decay: float = 1e-5,
    seed: int = 0,
    device: DeviceLike = None,
) -> FreqMLP:
    """FreqMLP with the JAX factory's defaults; parameters drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` (encoders, decoder,
    spectral-norm vectors) and moved to ``device`` (``cuda`` unless
    ``"cpu"``). ``encoder_type`` is one of :data:`ENCODER_TYPES`; others
    (the RunConfig default ``"hash"`` among them) raise ``ValueError``."""
    dev = resolve_device(device)
    model = FreqMLP(dim_in, dim_hidden, dim_out, n_layers, skip_connections, encoder_type, w0, n_frequencies, sigma,
                    w0_t, n_frequencies_t, sigma_t, torch.Generator().manual_seed(seed))
    model.hparams = {"lr": lr, "weight_decay": weight_decay, "encoder_type": encoder_type}
    return model.to(dev)
