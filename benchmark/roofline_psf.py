"""The least time an H100 SXM could take for the PSF SIREN's training step.

The work is priced by kind, each at the fastest rate known for it on this
card (NVIDIA H100 SXM data sheet, dense, no sparsity):

- the products of the linear layers (and of the PSF's integration) at the
  3xTF32 rate: the TF32 tensor cores' 494.7 TFLOP/s over 3, 164.9 TFLOP/s.
  Three TF32 products (the operands split into a high and a low TF32 part)
  are the fastest known way to products as accurate as float32's on this
  card; ``roofline.FP32_FLOPS`` (67 TFLOP/s on the CUDA cores) is no upper
  bound for them: the fused-MLP kernel ran a SIREN 352 x 5 stack faster
  than that rate allows;
- every other operation (bias adds, the w0 scaling, sines and cosines,
  the expansion, the MSE, Adam) at ``roofline.FP32_FLOPS``;
- bytes at ``roofline.HBM_BYTES_PER_S``.

A piece of work's least time is the largest of the three, so that no
implementation, however it splits the work between tensor cores, CUDA
cores and memory, can read above 100%. Operations count two for a
multiply-add and one for any other operation, a sine included; bytes count
each input read once and each output written once, as ``roofline.py``
counts them. Nothing here imports the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .roofline import FP32_FLOPS, HBM_BYTES_PER_S, adam, mlp_macs, mlp_params

TF32_TENSOR_FLOPS = 494.7e12
PRODUCT_FLOPS = TF32_TENSOR_FLOPS / 3.0

Work3 = Tuple[float, float, float]  # (bytes, product operations, other operations)


def least_s(work: Work3) -> float:
    """max(bytes / HBM rate, products / 3xTF32 rate, other / fp32 rate), in seconds."""
    nbytes, products, other = work
    return max(nbytes / HBM_BYTES_PER_S, products / PRODUCT_FLOPS, other / FP32_FLOPS)


def add(*works: Work3) -> Work3:
    return tuple(sum(w[i] for w in works) for i in range(3))


# operations an element of a hidden layer takes besides its products: forward
# the bias add, the w0 scaling and the sine (3); backward the cosine, the w0
# scaling, the product with the upstream gradient and the add into the bias
# gradient (4). The output layer: its bias add and its bias gradient's add (2)
SINE_FLOPS, SINE_GRAD_FLOPS, OUT_FLOPS = 3, 4, 2


def siren_products(rows: int, dims: Sequence[int]) -> float:
    """Product operations of a training step of the stack on ``rows`` rows:
    the forward's x W, dW = x^T g of every layer, and g W^T of every layer
    but the first (the coordinates take no gradient)."""
    macs = mlp_macs(dims)
    return float(rows * 2 * (3 * macs - dims[0] * dims[1]))


def siren_train(rows: int, dims: Sequence[int]) -> Work3:
    """The stack's forward and backward on ``rows`` rows: its input read and
    its output and the output's gradient passed once each way, its weights
    read and their gradients written; the products, and each element's
    bias, sine and their gradients. The activations between its layers
    need not leave the chip and count no bytes."""
    hidden = sum(dims[1:-1])
    nbytes = 4.0 * (rows * dims[0] + 2 * rows * dims[-1] + 2 * mlp_params(dims))
    other = float(rows * ((SINE_FLOPS + SINE_GRAD_FLOPS) * hidden + OUT_FLOPS * dims[-1]))
    return nbytes, siren_products(rows, dims), other


def psf_objective(batch: int, k: int, d: int, dim_out: int) -> Work3:
    """The expansion of ``batch`` voxel centres into ``k`` points each (d
    adds a point), the integration (a multiply-add a point forward, a
    product a point backward) and the MSE with its gradient (4 and 2 a
    voxel): the centres, their values and the PSF's offsets and weights
    read once."""
    nbytes = 4.0 * (batch * (d + dim_out) + k * (d + 1))
    products = float(batch * k * dim_out * (2 + 1))
    other = float(batch * k * d + batch * dim_out * (4 + 2))
    return nbytes, products, other


def fit_step(batch: int, k: int, dims: Sequence[int], n_params: int) -> Work3:
    """A whole training step: the PSF objective, the stack on ``batch * k``
    rows (whose input and output pass between it and the objective on the
    chip, so count no bytes here) and a dense Adam over every parameter."""
    stack = siren_train(batch * k, dims)
    stack = (4.0 * 2 * mlp_params(dims), stack[1], stack[2])
    adam_bytes, adam_flops = adam(n_params)
    return add(psf_objective(batch, k, dims[0], dims[-1]), stack, (adam_bytes, 0.0, adam_flops))
