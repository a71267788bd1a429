"""The least time the card could take for each piece of work, from its shapes.

The peaks are the NVIDIA H100 SXM data sheet's (dense, no sparsity): HBM3
at 3.35 TB/s and float32 at 67 TFLOP/s on the CUDA cores. A piece of
work's least time is the larger of its bytes over the first and its fp32
operations over the second. Bytes count each input read once and each
output written once, at what these inputs need: the table rows that these
points touch, not the whole table. Operations count two for a multiply-add
and one for any other arithmetic operation, a tanh or a square root
included.

The per-kernel counts are a frozen copy of the arithmetic that
``chip_smoke.py`` states beside its kernel bounds (``flops_per_point_level``,
``table_grad_bytes``, the forward of ``mlp_work``); the step and the
request add up what the algorithm needs end to end. Nothing here imports
the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

Work = Tuple[float, float]  # (bytes, fp32 operations)


def least_s(work: Work) -> float:
    """max(bytes / HBM rate, operations / fp32 rate), in seconds."""
    nbytes, flops = work
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def add(*works: Work) -> Work:
    return sum(w[0] for w in works), sum(w[1] for w in works)


def flops_per_point_level(d: int, f: int, grad: bool) -> int:
    """Operations per (point, level): the scale and the fraction (2d), the
    2^d corner weights (d - 1 products each, and d complements), then F
    weighted sums (forward: C products and C - 1 adds) or F * C products
    and adds into the gradient."""
    c = 1 << d
    return 2 * d + c * (d - 1) + d + (2 * c * f if grad else f * (2 * c - 1))


def hash_forward(n: int, d: int, levels: int, f: int, touched_rows: int) -> Work:
    """Kernel 1 on n points: x read, each touched (row, feature) read, the
    (n, L*F) features written."""
    return 4.0 * (n * d + touched_rows * f + n * levels * f), float(n * levels * flops_per_point_level(d, f, False))


def hash_table_grad(n: int, d: int, levels: int, f: int, touched_rows: int) -> Work:
    """Kernel 2 on n points: x and the features' gradient read, a read and a
    write of each touched (row, feature) of the zeroed gradient (the zero
    fill of the dense gradient is another kernel's)."""
    return (4.0 * (n * d + n * levels * f + 2 * touched_rows * f),
            float(n * levels * flops_per_point_level(d, f, True)))


def mlp_macs(dims: Sequence[int]) -> int:
    """Multiply-adds a row of the products of a stack of widths ``dims``."""
    return sum(k * m for k, m in zip(dims[:-1], dims[1:]))


def mlp_params(dims: Sequence[int]) -> int:
    """Weights and biases of the stack."""
    return sum(k * m + m for k, m in zip(dims[:-1], dims[1:]))


# operations an output element of a layer takes besides its products: the
# bias add, then relu 1, identity 0, or BatchNorm in eval ((z - mean) * inv
# * scale + bias: 4) and the tanh GELU (z^3 2, * 0.044715, + z, *
# sqrt(2/pi), tanh, + 1, * z, * 0.5: 9)
ACT_FLOPS = {"relu": 1 + 1, "id": 1, "bn_gelu": 1 + 4 + 9}
# and in the backward of a fused relu stack: the mask's test and product
ACT_GRAD_FLOPS = {"relu": 2, "id": 0}


def mlp_forward(n: int, dims: Sequence[int], acts: Sequence[str]) -> Work:
    """A stack's forward on n rows: x read, the weights and biases read, the
    (n, dims[-1]) output written; two operations a multiply-add and each
    output element's bias and activation."""
    elems = sum(ACT_FLOPS[a] * w for a, w in zip(acts, dims[1:]))
    return (4.0 * (n * dims[0] + mlp_params(dims) + n * dims[-1]),
            float(n * (2 * mlp_macs(dims) + elems)))


def mlp_train(n: int, dims: Sequence[int], acts: Sequence[str]) -> Work:
    """A stack's forward and backward on n rows, the input's gradient
    included (it feeds the encoder's table gradient): x and the output's
    gradient read, the output and dx written, the weights read and their
    gradients written; the forward's products, dW of every layer and dz
    W^T of every layer; each output element's bias, activation and the
    activation's derivative."""
    elems = sum((ACT_FLOPS[a] + ACT_GRAD_FLOPS[a]) * w for a, w in zip(acts, dims[1:]))
    nbytes = 4.0 * (2 * n * dims[0] + 2 * n * dims[-1] + 2 * mlp_params(dims))
    return nbytes, float(n * (2 * 3 * mlp_macs(dims) + elems))


# Adam's operations a parameter: m = b1 m + (1 - b1) g (3), v = b2 v +
# (1 - b2) g^2 (4), the bias-corrected denominator sqrt(v) / c2 + eps (3),
# the step lr / c1 * m / denom and its subtraction (3)
ADAM_FLOPS_PER_PARAM = 13


def adam(n_params: int) -> Work:
    """A dense Adam step: p, g, m and v read, p, m and v written."""
    return 7 * 4.0 * n_params, float(ADAM_FLOPS_PER_PARAM * n_params)


def fit_step(n: int, d: int, levels: int, f: int, touched_rows: int, table_rows: int, dims: Sequence[int],
             acts: Sequence[str], n_params: int) -> Work:
    """A whole training step of a HashMLP with a fused decoder on a batch of
    n: the batch's coordinates and targets read, the touched rows read, a
    dense table gradient written once, the decoder's weights read and their
    gradients written, a dense Adam over every parameter; the encoder's
    forward and table-gradient operations, the decoder's, the MSE's (4 a
    row) and Adam's. The features and their gradient, which pass between
    encoder and decoder, need not leave the chip and count no bytes."""
    nbytes = 4.0 * (n * (d + 1) + touched_rows * f + table_rows * f + 2 * mlp_params(dims))
    flops = (n * levels * (flops_per_point_level(d, f, False) + flops_per_point_level(d, f, True))
             + mlp_train(n, dims, acts)[1] + 4.0 * n)
    return add((nbytes, float(flops)), adam(n_params))


def grid_request(n: int, d: int, levels: int, f: int, rows_read: int, dims: Sequence[int], acts: Sequence[str]
                 ) -> Work:
    """A whole grid request of n points: each table row it reads read once,
    the decoder's weights read, the n-float volume written; the encoding's
    and the decoder's operations. The coordinates are made on the chip and
    the features need not leave it, so neither counts bytes."""
    flops = n * levels * flops_per_point_level(d, f, False) + mlp_forward(n, dims, acts)[1]
    return 4.0 * (rows_read * f + mlp_params(dims) + n * dims[-1]), float(flops)
