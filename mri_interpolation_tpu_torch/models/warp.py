"""The motion-compensated INR: canonical content under a learned deformation.

Port of ``mri_interpolation_tpu/models/warp.py``: ``f(x, t) = g(x + d(x,
t))`` (+ ``residual_scale * r(x, t)``), with

- ``g``: a spatial hash encoding of the canonical anatomy (``encoder``, the
  hash-encode kernel pair on the card; all 2-D warp encoders are cell-view,
  so the warped points take a coordinate gradient,
  ``ops.hash_encode.hash_encode_coord_grad``) and a ReLU decoder in plain
  matmuls (``layers``);
- ``d``: a SIREN deformation field on ``(x * 2 - 1)`` with the time input
  scaled by ``warp_t_scale``, its last layer zero (the identity warp at
  init), times ``warp_scale`` (``warp``; :meth:`WarpINR.warp_field`);
- ``r``: the optional SIREN residual at ``residual_w0`` (``warp_w0`` when
  0), zero-initialised (``residual``; :meth:`WarpINR.residual_field`).

The warped points are clipped to [0, 1] as ``jnp.clip``: ``maximum`` then
``minimum``, whose gradient splits a tie evenly (0.5 at x + d == 0 or 1,
where ``torch.clamp`` gives 1). With ``level_anneal_steps`` > 0 the
canonical encoder's levels follow HashMLP's curriculum (the int32 buffer
``anneal_step``). The priors ``warp_smooth`` (the mean squared spatial
Jacobian of d, each column by an exact ``torch.func.jvp``), ``warp_accel``
and ``residual_accel`` (the mean squared second difference of d or of
``residual_scale * r`` in time, at +-``warp_accel_dt``) make the model's
``loss``: MSE plus the weighted priors, whatever loss the trainer is
configured with. Tree: ``{"encoder": {"table"}, "layers", "warp",
"residual"}``, state ``{"anneal_step"}``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.hashgrid import HashGridEncoding
from .core import Dense, Model, dense_init, uniform_init
from .hash_mlp import HashGridEncoder, level_anneal_weights

__all__ = ["WarpINR", "make_warp_inr", "clip_balanced"]


def clip_balanced(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``. torch's ``maximum``
    and ``minimum`` split the gradient of a tie evenly, as JAX's do."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _siren_field_layers(dims: Sequence[int], w0: float, generator: Optional[torch.Generator]) -> nn.ModuleList:
    """SIREN init, U(+-1/d) in the first layer and U(+-sqrt(6/d)/w0) after;
    the last layer zero."""
    layers = []
    for i in range(len(dims) - 1):
        if i == len(dims) - 2:
            layers.append(Dense({"w": torch.zeros((dims[i], dims[i + 1])), "b": torch.zeros((dims[i + 1],))}))
        else:
            bound = (1.0 / dims[i]) if i == 0 else float(np.sqrt(6.0 / dims[i]) / w0)
            layers.append(Dense({"w": uniform_init((dims[i], dims[i + 1]), bound, generator),
                                 "b": uniform_init((dims[i + 1],), bound, generator)}))
    return nn.ModuleList(layers)


def _siren_field_apply(layers: nn.ModuleList, h: torch.Tensor, w0: float) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = layer(h)
        if i < len(layers) - 1:
            h = torch.sin(w0 * h)
    return h


class WarpINR(Model):
    name = "warp_inr"

    def __init__(self, encoder: HashGridEncoder, dim_in: int, dim_hidden: int, n_layers: int, dim_out: int,
                 warp_hidden: int, warp_layers: int, warp_w0: float, warp_scale: float, residual_scale: float,
                 residual_w0: float, warp_smooth: float, warp_accel: float, warp_accel_dt: float,
                 residual_accel: float, warp_t_scale: float, level_anneal_steps: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim_in, dim_out)
        s = dim_in - 1
        self.s = s
        self.warp_w0, self.warp_scale = warp_w0, warp_scale
        self.residual_scale = residual_scale
        self.residual_w0 = residual_w0 if residual_w0 > 0.0 else warp_w0
        self.warp_smooth, self.warp_accel, self.residual_accel = warp_smooth, warp_accel, residual_accel
        self.level_anneal_steps = level_anneal_steps
        self.encoder = encoder
        widths = [encoder.geometry.output_dim] + [dim_hidden] * (n_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(Dense(dense_init(widths[i], widths[i + 1], generator)) for i in range(n_layers))
        self.warp = _siren_field_layers([dim_in] + [warp_hidden] * (warp_layers - 1) + [s], warp_w0, generator)
        if residual_scale > 0.0:
            self.residual = _siren_field_layers([dim_in] + [warp_hidden] * (warp_layers - 1) + [dim_out], warp_w0,
                                                generator)
        if level_anneal_steps > 0:
            self.register_buffer("anneal_step", torch.zeros((), dtype=torch.int32))
        t_scale = torch.ones(dim_in)
        t_scale[-1] = warp_t_scale
        self.register_buffer("t_scale", t_scale, persistent=False)
        dt = torch.zeros(dim_in)
        dt[-1] = warp_accel_dt
        self.register_buffer("accel_dt", dt, persistent=False)
        if warp_smooth > 0.0 or warp_accel > 0.0 or residual_accel > 0.0:
            self.loss = self.loss_with_priors

    def warp_field(self, x: torch.Tensor) -> torch.Tensor:
        """The displacement d(x, t) (N, s) in normalised coordinates."""
        return _siren_field_apply(self.warp, (x * 2.0 - 1.0) * self.t_scale, self.warp_w0) * self.warp_scale

    def residual_field(self, x: torch.Tensor) -> torch.Tensor:
        """r(x, t) (N, dim_out), before ``residual_scale``."""
        return _siren_field_apply(self.residual, x * 2.0 - 1.0, self.residual_w0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xw = clip_balanced(x[..., :self.s] + self.warp_field(x), 0.0, 1.0)
        z = self.encoder(xw)
        if self.level_anneal_steps > 0:
            z = z * level_anneal_weights(self.anneal_step, self.level_anneal_steps, self.encoder.geometry)
            if self.training:
                with torch.no_grad():
                    self.anneal_step.add_(1)
        for i, layer in enumerate(self.layers):
            z = layer(z)
            if i < len(self.layers) - 1:
                z = torch.relu(z)
        if self.residual_scale > 0.0:
            z = z + self.residual_scale * self.residual_field(x)
        return z

    def loss_with_priors(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """MSE plus the weighted priors (the model's ``loss`` when any prior
        weight is positive)."""
        from ..train.losses import mse_loss

        loss = mse_loss(self(x), y)
        if self.warp_smooth > 0.0:
            reg = 0.0
            for k in range(self.s):
                e = torch.zeros_like(x)
                e[:, k] = 1.0
                _, gk = torch.func.jvp(self.warp_field, (x,), (e,))
                reg = reg + torch.mean(gk**2)
            loss = loss + self.warp_smooth * reg
        if self.warp_accel > 0.0:
            d0, dp, dm = (self.warp_field(x + o) for o in (0.0, self.accel_dt, -self.accel_dt))
            loss = loss + self.warp_accel * torch.mean((dp - 2.0 * d0 + dm) ** 2)
        if self.residual_accel > 0.0 and self.residual_scale > 0.0:
            r0, rp, rm = (self.residual_field(x + o) for o in (0.0, self.accel_dt, -self.accel_dt))
            loss = loss + self.residual_accel * torch.mean((self.residual_scale * (rp - 2.0 * r0 + rm)) ** 2)
        return loss


def make_warp_inr(
    dim_in: int = 3,
    n_levels: int = 4,
    n_features_per_level: int = 4,
    log2_hashmap_size: int = 23,
    base_resolution: Union[int, Sequence[int]] = (64, 64),
    finest_resolution: Union[int, Sequence[int], None] = (352, 352),
    growth: str = "paper",
    dim_hidden: int = 64,
    n_layers: int = 2,
    dim_out: int = 1,
    warp_hidden: int = 64,
    warp_layers: int = 3,
    warp_w0: float = 5.0,
    warp_scale: float = 0.05,
    residual_scale: float = 0.0,
    residual_w0: float = 0.0,
    warp_smooth: float = 0.0,
    warp_accel: float = 0.0,
    warp_accel_dt: float = 0.5 / 15.0,
    residual_accel: float = 0.0,
    warp_t_scale: float = 1.0,
    level_anneal_steps: int = 0,
    lr: float = 1e-2,
    seed: int = 0,
    device: DeviceLike = None,
) -> WarpINR:
    """The warp INR with the JAX factory's defaults (time is the last input
    axis; resolution tuples longer than the spatial rank are cut to it).
    Parameters drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (table, decoder, warp field, residual) and moved to ``device`` (``cuda``
    unless ``"cpu"``)."""
    dev = resolve_device(device)
    s = dim_in - 1
    if isinstance(base_resolution, (tuple, list)) and len(base_resolution) != s:
        base_resolution = tuple(base_resolution)[:s]
    if isinstance(finest_resolution, (tuple, list)) and len(finest_resolution) != s:
        finest_resolution = tuple(finest_resolution)[:s]
    geometry = HashGridEncoding(dim=s, n_levels=n_levels, n_features_per_level=n_features_per_level,
                                log2_hashmap_size=log2_hashmap_size, base_resolution=base_resolution,
                                finest_resolution=finest_resolution, growth=growth)
    gen = torch.Generator().manual_seed(seed)
    model = WarpINR(HashGridEncoder(geometry, gen), dim_in, dim_hidden, n_layers, dim_out, warp_hidden, warp_layers,
                    warp_w0, warp_scale, residual_scale, residual_w0, warp_smooth, warp_accel, warp_accel_dt,
                    residual_accel, warp_t_scale, level_anneal_steps, gen)
    model.hparams = {"lr": lr, "warp_scale": warp_scale, "warp_w0": warp_w0, "residual_scale": residual_scale}
    return model.to(dev)
