"""The least time an H100 SXM could take for the hash SIREN's training step.

Priced as ``roofline_psf.py`` prices the PSF SIREN's: products at the
3xTF32 rate (164.9 TFLOP/s), every other operation at the CUDA cores' fp32
rate (67 TFLOP/s), bytes at 3.35 TB/s. The step's least time is the
largest of the three over the whole step's work (the pieces' bytes,
products and other operations added, as ``roofline_psf.fit_step`` adds
them), so that no implementation, however it overlaps the pieces, can
read above 100%. The pieces:

- **products** (:func:`products`): both networks' x W, dW of every layer,
  and dX of every layer but the SIREN's first (the coordinates take no
  gradient); the modulator's first layer takes its dX, the latent's
  gradient, which feeds the table gradient. A row takes 263,168 SIREN and
  303,104 modulator multiply-adds forward at the published widths, so the
  step's products are 2 x (3 x 566,272 - 768) = 3,396,096 operations a row
  (5.40 ms at 2^18 rows). Their bytes are the weights read and their
  gradients written;
- **elementwise** (:func:`elementwise`): everything between the products,
  the biases, sines, gates, ReLUs and their gradients, and the MSE. Its
  bytes are a row's coordinates and value, read once: the activations
  between layers, the latent passed from the encoder to the modulator,
  the prediction and their gradients need not leave the chip and count no
  bytes, as ``roofline_psf.siren_train`` and ``roofline.fit_step`` count
  them;
- **hash encoding** (:func:`hash_encoding`): the table rows these points
  touch read once, the dense table gradient that Adam reads written once
  (as ``roofline.fit_step`` counts them), and kernels 1 and 2's operations;
- **Adam**: ``roofline.adam`` over every parameter, the table included.

At the published sizes the products set the step's least time: 5.40 ms a
step of 2^18 rows, against ~0.14 ms of bytes and ~0.09 ms of other
operations. :func:`fit_step` also gives the least time of kernels 1-2 as
``roofline.py`` prices them (``roofline.hash_forward``,
``roofline.hash_table_grad``), for their own share. Operations count two
for a multiply-add and one for any other operation, a sine, a cosine or a
comparison included. Nothing here imports the port.
"""

from __future__ import annotations

from typing import Dict, List

from . import roofline
from .roofline_psf import Work3, add, least_s

# other operations an element of a hidden layer takes: forward the
# modulator's bias add and ReLU (2), the sine layer's bias add, w0 scale and
# sine (3) and the gate's product (1); backward the gate's two products (2),
# the cosine, w0 scale and product (3), the ReLU's mask and product (2) and
# the two bias gradients' adds (2)
ELEMENT_FLOPS, ELEMENT_GRAD_FLOPS = 6, 9


def siren_dims(cfg: Dict) -> List[int]:
    s = cfg["siren"]
    return [int(s["dim_in"])] + [int(s["dim_hidden"])] * int(s["n_layers"]) + [int(s["dim_out"])]


def latent_width(cfg: Dict) -> int:
    return int(cfg["encoder"]["n_levels"]) * int(cfg["encoder"]["n_features_per_level"])


def modulator_shapes(cfg: Dict) -> List[tuple]:
    """(fan_in, width) of each modulator layer: the latent, then cat(h, latent)."""
    s, lat = cfg["siren"], latent_width(cfg)
    h = int(s["dim_hidden"])
    return [(lat if i == 0 else h + lat, h) for i in range(int(s["n_layers"]))]


def macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds a row of each network's forward products."""
    return {"siren": roofline.mlp_macs(siren_dims(cfg)), "modulator": sum(k * m for k, m in modulator_shapes(cfg))}


def n_params(cfg: Dict, table_rows: int) -> int:
    mod = sum(k * m + m for k, m in modulator_shapes(cfg))
    return table_rows * int(cfg["encoder"]["n_features_per_level"]) + roofline.mlp_params(siren_dims(cfg)) + mod


def products(rows: int, cfg: Dict) -> Work3:
    """The products of a training step on ``rows`` rows."""
    dims, m = siren_dims(cfg), macs(cfg)
    ops = 2.0 * rows * (3 * m["siren"] - dims[0] * dims[1] + 3 * m["modulator"])
    weights = roofline.mlp_params(dims) + sum(k * w + w for k, w in modulator_shapes(cfg))
    return 4.0 * 2 * weights, ops, 0.0


def elementwise(rows: int, cfg: Dict) -> Work3:
    """Everything between the products of a training step on ``rows`` rows."""
    dims = siren_dims(cfg)
    h, n = dims[1], len(dims) - 2
    other = float(rows * n * h * (ELEMENT_FLOPS + ELEMENT_GRAD_FLOPS) + rows * 6 * dims[-1])
    return 4.0 * rows * (dims[0] + dims[-1]), 0.0, other


def hash_encoding(rows: int, cfg: Dict, touched_rows: int, table_rows: int) -> Work3:
    """The hash encoding's share of a training step on ``rows`` rows."""
    enc = cfg["encoder"]
    d, levels, f = int(enc["dim"]), int(enc["n_levels"]), int(enc["n_features_per_level"])
    ops = rows * levels * (roofline.flops_per_point_level(d, f, False) + roofline.flops_per_point_level(d, f, True))
    return 4.0 * (touched_rows + table_rows) * f, 0.0, float(ops)


def fit_step(rows: int, cfg: Dict, touched_rows: int, table_rows: int) -> Dict[str, float]:
    """Least seconds of a training step (``"whole"``), and of the parts the
    readers take: the products, kernels 1-2 and Adam."""
    enc = cfg["encoder"]
    d, levels, f = int(enc["dim"]), int(enc["n_levels"]), int(enc["n_features_per_level"])
    adam_bytes, adam_flops = roofline.adam(n_params(cfg, table_rows))
    adam = (adam_bytes, 0.0, adam_flops)
    whole = add(products(rows, cfg), elementwise(rows, cfg), hash_encoding(rows, cfg, touched_rows, table_rows), adam)
    return {
        "products": least_s(products(rows, cfg)),
        "hash": roofline.least_s(roofline.hash_forward(rows, d, levels, f, touched_rows))
        + roofline.least_s(roofline.hash_table_grad(rows, d, levels, f, touched_rows)),
        "adam": least_s(adam),
        "whole": least_s(whole),
    }
