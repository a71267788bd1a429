"""The least time an H100 SXM could take for WIRE's training step.

Priced as ``roofline_psf.py`` prices the PSF SIREN's: products at the
3xTF32 rate (164.9 TFLOP/s), every other operation at the CUDA cores' fp32
rate (67 TFLOP/s), bytes at 3.35 TB/s, a piece's least time the largest of
the three. Operations count two for a real multiply-add and eight for a
complex one (four real products and four adds), one for any other
operation, an exponential, a sine or a cosine included. Nothing here
imports the port.

The products of a step on ``rows`` rows: the forward's ``x W``; ``dW`` of
every layer; ``dX`` of every layer but the first (the coordinates take no
gradient). The first layer is real (real coordinates, real W); the hidden
layers are complex; of the last complex Linear only the real part of the
output is needed, so its products count four a complex multiply-add each
way (``xr wr - xi wi`` forward, and their transposes backward).

Each Gabor layer's activation is memory-bound: its least bytes are one
read of z and one write of the activation forward, and backward the
matching pair, one read of the activation's gradient and one write of z's;
z is real (4 B) in the first layer and complex (8 B) after. The products'
inputs and outputs beyond that (the weights, the coordinates) count once.
"""

from __future__ import annotations

from typing import Sequence

from .roofline import adam
from .roofline_psf import Work3, add

REAL_MAC, COMPLEX_MAC, REAL_PART_MAC = 2, 8, 4
# other operations a complex element of a Gabor layer takes: forward the
# bias add (2), w0 q, p^2, q^2, their sum, the s0^2 scaling, the exponent's
# sum, exp, w0 p, cos, sin and the two products with the envelope (12);
# backward the gradients through those, and the bias gradient's add (20)
GABOR_FLOPS, GABOR_GRAD_FLOPS = 14, 20


def products(rows: int, dims: Sequence[int]) -> float:
    """Product operations of a training step of WIRE on ``rows`` rows."""
    first = dims[0] * dims[1]
    hidden = sum(a * b for a, b in zip(dims[1:-2], dims[2:-1]))
    last = dims[-2] * dims[-1]
    forward = REAL_MAC * first + COMPLEX_MAC * hidden + REAL_PART_MAC * last
    dx = COMPLEX_MAC * hidden + REAL_PART_MAC * last
    return float(rows * (2 * forward + dx))


def n_params(dims: Sequence[int]) -> int:
    """Real parameters: the first layer's real W and b, then two a complex
    weight or bias."""
    first = dims[0] * dims[1] + dims[1]
    return first + 2 * sum(a * b + b for a, b in zip(dims[1:-1], dims[2:]))


def activations(rows: int, dims: Sequence[int]) -> Work3:
    """The Gabor layers' activations and their gradients: the least bytes
    above, and their other operations."""
    widths = dims[1:-1]
    z_bytes = [4.0] + [8.0] * (len(widths) - 1)
    nbytes = rows * sum(2 * (zb + 8.0) * h for zb, h in zip(z_bytes, widths))
    return nbytes, 0.0, float(rows * (GABOR_FLOPS + GABOR_GRAD_FLOPS) * sum(widths))


def fit_step(rows: int, dims: Sequence[int]) -> Work3:
    """A whole full-batch step: the coordinates and values read once, the
    products, the activations, the MSE (4 a row forward, 2 back) and a dense
    Adam over every real parameter."""
    adam_bytes, adam_flops = adam(n_params(dims))
    io = (4.0 * rows * (dims[0] + dims[-1]), products(rows, dims), 6.0 * rows * dims[-1])
    return add(io, activations(rows, dims), (adam_bytes, 0.0, adam_flops))
