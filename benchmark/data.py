"""What a run feeds both the port and the reference, made from ``--seed`` on
the device: the synthetic volume and the model's weights.

The volume is a frozen torch rewrite of ``io.synthetic_volume(kind="smooth")``:
a sum of three products of sines over the axes, with phases U(0, 2 pi) and
frequencies U(1, 3) per term and axis, on the grid ``linspace(0, 1, s)`` of
each axis, then min-max normalised to [0, 1] as ``io.dataset_from_array``
does. Its draws come from a ``torch.Generator`` on the device, so a seed
gives one volume; the port's own function draws from numpy and is not used.

Weights are drawn in one call a tensor from a ``torch.Generator`` on the
device, under the port's parameter names:

- ``"init"``: the factory's distributions (the table U(-1e-4, 1e-4), each
  Linear U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BatchNorm at scale 1, bias 0,
  running mean 0 and variance 1): what a fit starts from;
- ``"served"``: a fitted model's scale (the table U(-1, 1), the Linears as
  above, BatchNorm scale U(0.5, 1.5), bias U(-0.5, 0.5), running mean
  U(-0.5, 0.5) and variance U(0.5, 1.5)), so that every part of the
  decoder, eval-mode BatchNorm included, shapes the served volume.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .reference import grid_coords, make_grid


def make_volume(shape: Sequence[int], seed: int, device) -> torch.Tensor:
    """The normalised volume of ``shape`` (float32, C order) for ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = len(shape)
    phases = torch.rand((3, d), generator=gen, device=device, dtype=torch.float64) * (2 * math.pi)
    freqs = 1.0 + 2.0 * torch.rand((3, d), generator=gen, device=device, dtype=torch.float64)
    out = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for k in range(3):
        term = None
        for a, s in enumerate(shape):
            x = torch.linspace(0.0, 1.0, s, dtype=torch.float64, device=device)
            f = torch.sin(2 * math.pi * freqs[k, a] * x + phases[k, a]).to(torch.float32)
            f = f.reshape([s if j == a else 1 for j in range(d)])
            term = f if term is None else term * f
        out += term
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo)


def training_set(volume: torch.Tensor):
    """(coords (N, d), values (N, 1)) of the volume on its own grid, C order,
    the coordinates digit / (s - 1) in float32."""
    shape = tuple(volume.shape)
    n = volume.numel()
    return grid_coords(shape, 0, n, volume.device), volume.reshape(n, 1)


def grid_rows(shape: Sequence[int], x: torch.Tensor):
    """(flat C-order indices, on-grid mask) of coordinates ``x`` (N, d) on
    the grid of ``shape``: each axis's digit is the nearest integer to x *
    (s - 1); a row is on the grid where every axis lies within 1e-3 of a
    cell's width of its digit."""
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    on = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for k, s in enumerate(shape):
        scaled = x[:, k].double() * (s - 1)
        digit = torch.round(scaled).clamp(0, s - 1)
        on &= (scaled - digit).abs() <= 1e-3
        flat = flat * s + digit.to(torch.int64)
    return flat, on


def targets(volume: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The volume's values at grid coordinates ``x`` (N, d)."""
    flat, _ = grid_rows(tuple(volume.shape), x)
    return volume.reshape(-1)[flat].reshape(-1, 1)


def rows_short(shape: Sequence[int], xs: Sequence[torch.Tensor], steps: int, batch: int) -> int:
    """How many of ``steps`` batches of ``batch`` distinct grid rows are
    missing from the inputs ``xs``: rows left out, repeated, or off the
    grid."""
    if not xs:
        return steps * batch
    flat, on = grid_rows(shape, torch.cat(list(xs)))
    return steps * batch - int(torch.unique(flat[on]).numel())


def decoder_dims(cfg: Dict) -> List[int]:
    enc, dec = cfg["encoder"], cfg["decoder"]
    width = int(enc["n_levels"]) * int(enc["n_features_per_level"])
    return [width] + [int(dec["dim_hidden"])] * (int(dec["n_layers"]) - 1) + [int(dec["dim_out"])]


def decoder_acts(cfg: Dict) -> List[str]:
    """Each decoder layer's activation as ``roofline.py`` counts it."""
    dec = cfg["decoder"]
    hidden, last = ("relu", "id") if dec["kind"] == "relu_plain" else ("bn_gelu", "bn_gelu")
    return [hidden] * (int(dec["n_layers"]) - 1) + [last]


def buffer_names(cfg: Dict) -> List[str]:
    """The model's buffers among the drawn tensors (not trained)."""
    if cfg["decoder"]["kind"] != "norm":
        return []
    return [f"bn.{i}.{k}" for i in range(int(cfg["decoder"]["n_layers"])) for k in ("mean", "var")]


def draw_weights(cfg: Dict, seed: int, device, kind: str) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers for ``seed``, by the port's names."""
    if kind not in ("init", "served"):
        raise ValueError(f"unknown weights {kind!r}")
    served = kind == "served"
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)

    grid = make_grid(cfg["encoder"])
    scale = 1.0 if served else 1e-4
    out = {"encoder.table": uniform((grid.rows, grid.n_features), -scale, scale)}
    dims = decoder_dims(cfg)
    for i, (k, m) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / math.sqrt(k)
        out[f"layers.{i}.w"] = uniform((k, m), -bound, bound)
        out[f"layers.{i}.b"] = uniform((m,), -bound, bound)
    if cfg["decoder"]["kind"] == "norm":
        for i, m in enumerate(dims[1:]):
            if served:
                out[f"bn.{i}.scale"] = uniform((m,), 0.5, 1.5)
                out[f"bn.{i}.bias"] = uniform((m,), -0.5, 0.5)
                out[f"bn.{i}.mean"] = uniform((m,), -0.5, 0.5)
                out[f"bn.{i}.var"] = uniform((m,), 0.5, 1.5)
            else:
                out[f"bn.{i}.scale"] = torch.ones(m, device=device)
                out[f"bn.{i}.bias"] = torch.zeros(m, device=device)
                out[f"bn.{i}.mean"] = torch.zeros(m, device=device)
                out[f"bn.{i}.var"] = torch.ones(m, device=device)
    return out
