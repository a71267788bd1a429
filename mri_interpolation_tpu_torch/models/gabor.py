"""Gabor / WIRE networks: real and complex Gabor wavelet activations.

Port of ``mri_interpolation_tpu/models/gabor.py``. ``make_gabor_net``
(``GaborNet``), ``n_layers`` Gabor layers, the last to dim_out:

- ``kind="real"``: layer ``{"freqs": {"w", "b"}, "scale": {"w", "b"}}``,
  output ``cos(w0 * freqs(x)) * exp(-(sigma * scale(x))^2)``. Init
  ``"auto"``: ``freqs`` U(+-1/d) in the first layer and U(+-sqrt(6/d)/w0)
  after, ``scale`` U(+-0.5/(max(sigma, 1e-3) sqrt(d))); ``"torch"``: both
  Linears at torch's default init;
- ``kind="complex"``: layer ``{"lin": {"w", "b"}}``, real in the first
  layer and complex64 after, output ``exp(i w0 z - |sigma z|^2)`` of ``z =
  lin(x)``; the network's value is the real part of the last layer's. Which
  layers are complex is a Python attribute (the JAX tree's ``"complex"``
  bool leaf, which ``convert.params_from_jax`` skips).

``outermost_linear=True`` (complex kind only) is WIRE's own form
(Saragadam et al., CVPR 2023, arXiv:2301.05187): the last of the
``n_layers`` layers is a plain complex ``Dense`` to dim_out (``last``,
torch's cfloat init) in place of a Gabor layer, and the value is the real
part of its output. WIRE's image INR is ``n_layers=4`` (three Gabor layers,
then the Linear) at dim_hidden ``int(256 / sqrt(2))`` = 181, w0 20, sigma
10. The parameters are drawn as without it, in the same order.

``Trainer.fit`` trains the complex parameters (torch's Adam over their
real views; the gradient of the real loss is dL/dRe + i dL/dIm), held to
``benchmark/reference_wire.py``, a real-arithmetic reference; the JAX
trainer cannot fit this kind. Each complex Gabor layer's activation runs
inside the span ``mri.model.gabor`` and adds its rows to
:data:`GABOR_ROWS`. Plain tensor code.

The layers whose weights are complex (the hidden ``lin`` and WIRE's
``last``) are :class:`ComplexDense`: the forward is ``x @ w + b`` as
``core.dense`` computes it, and so are the backward's ``dX = dY wᴴ`` and
``db``. The weight gradient ``dW = xᴴ dY`` (:func:`weight_grad`) is that one
product, x entering as a conj-transposed view (cuBLAS takes op C, nothing
is copied), but for a column output (dim_out 1, WIRE's ``last``): that is
taken as ``(dYᴴ x)ᴴ``, which cuBLAS runs as a matrix-vector product whose
reduction it splits over the card, where ``xᴴ dY`` runs 3 GEMM tiles over
all the rows (1.0 against 152 ms at 1,858,560 x 181 on an H100); the
conjugates written are dY's, one entry a row, and the result's, not x's.
Each weight gradient adds one to its path in :data:`WEIGHT_GRADS`
(``"matrix"`` or ``"column"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..tracing import span
from .core import Dense, Model, dense, dense_init, uniform_init

__all__ = ["GaborNet", "make_gabor_net", "GABOR_ROWS", "reset_gabor_rows", "ComplexDense", "complex_dense",
           "weight_grad", "WEIGHT_GRADS", "reset_weight_grads"]

GABOR_ROWS = {"gabor_complex": 0}  # rows x layers that complex Gabor activations took
WEIGHT_GRADS = {"matrix": 0, "column": 0}  # complex Dense weight gradients, by the path they took


def reset_gabor_rows() -> None:
    for name in GABOR_ROWS:
        GABOR_ROWS[name] = 0


def reset_weight_grads() -> None:
    for name in WEIGHT_GRADS:
        WEIGHT_GRADS[name] = 0


def weight_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``xᴴ dy`` of (rows, dim_in) and (rows, dim_out) in one product; a
    column dy as ``(dyᴴ x)ᴴ`` (the module's docstring)."""
    if dy.shape[1] == 1 and x.shape[1] > 1:
        WEIGHT_GRADS["column"] += 1
        return dy.mH.mm(x).conj_physical().view(x.shape[1], 1)
    WEIGHT_GRADS["matrix"] += 1
    return x.mH.mm(dy)


class _ComplexDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return dense(w, b, x)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dy.mm(w.mH)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, dy)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=0)
        return dx, dw, db


def complex_dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``core.dense`` of a complex x (any leading dimensions, taken as rows)
    whose weight gradient is :func:`weight_grad`'s."""
    y = _ComplexDense.apply(x.reshape(-1, x.shape[-1]), w, b)
    return y.view(*x.shape[:-1], y.shape[-1])


class ComplexDense(Dense):
    """A ``Dense`` whose weights are complex, through :func:`complex_dense`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return complex_dense(self.w, self.b, x)


class RealGaborLayer(nn.Module):
    def __init__(self, freqs, scale):
        super().__init__()
        self.freqs = Dense(freqs)
        self.scale = Dense(scale)

    def forward(self, x: torch.Tensor, w0: float, sigma: float) -> torch.Tensor:
        return torch.cos(w0 * self.freqs(x)) * torch.exp(-((self.scale(x) * sigma) ** 2))


class ComplexGaborLayer(nn.Module):
    def __init__(self, lin, complex_weights: bool):
        super().__init__()
        self.lin = ComplexDense(lin) if complex_weights else Dense(lin)
        self.complex = complex_weights

    def forward(self, z: torch.Tensor, w0: float, sigma: float) -> torch.Tensor:
        lin = self.lin(z)
        GABOR_ROWS["gabor_complex"] += lin.numel() // lin.shape[-1]
        with span("mri.model.gabor"):
            return torch.exp(1j * w0 * lin - torch.abs(sigma * lin) ** 2)


def _complex_dense_init(dim_in: int, dim_out: int, generator: Optional[torch.Generator]):
    """torch's cfloat Linear init: U(+-1/sqrt(dim_in)) for the real and the
    imaginary parts alike."""
    bound = float(1.0 / np.sqrt(dim_in))
    parts = [uniform_init(shape, bound, generator) for shape in ((dim_in, dim_out),) * 2 + ((dim_out,),) * 2]
    return {"w": torch.complex(parts[0], parts[1]), "b": torch.complex(parts[2], parts[3])}


class GaborNet(Model):
    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, w0: float, sigma: float,
                 kind: str, init_scheme: str, generator: Optional[torch.Generator] = None,
                 outermost_linear: bool = False):
        super().__init__(dim_in, dim_out)
        if kind not in ("real", "complex"):
            raise ValueError(f"unknown gabor kind {kind!r}")
        if outermost_linear and (kind != "complex" or n_layers < 2):
            raise ValueError("outermost_linear is WIRE's form: kind='complex' and n_layers >= 2")
        self.name = f"gabor_{kind}"
        self.w0, self.sigma = w0, sigma
        self.complex = kind == "complex"
        dims = [dim_in] + [dim_hidden] * (n_layers - 1) + [dim_out]
        layers = []
        for i in range(n_layers - int(outermost_linear)):
            if self.complex:
                lin = (dense_init(dims[i], dims[i + 1], generator) if i == 0
                       else _complex_dense_init(dims[i], dims[i + 1], generator))
                layers.append(ComplexGaborLayer(lin, i > 0))
            elif init_scheme == "auto":
                fb = 1.0 / dims[i] if i == 0 else float(np.sqrt(6.0 / dims[i]) / w0)
                sb = float(0.5 / (max(sigma, 1e-3) * np.sqrt(dims[i])))
                freqs = {"w": uniform_init((dims[i], dims[i + 1]), fb, generator),
                         "b": uniform_init((dims[i + 1],), fb, generator)}
                scale = {"w": uniform_init((dims[i], dims[i + 1]), sb, generator),
                         "b": uniform_init((dims[i + 1],), sb, generator)}
                layers.append(RealGaborLayer(freqs, scale))
            elif init_scheme == "torch":
                layers.append(RealGaborLayer(dense_init(dims[i], dims[i + 1], generator),
                                             dense_init(dims[i], dims[i + 1], generator)))
            else:
                raise ValueError(f"unknown init_scheme {init_scheme!r}")
        self.layers = nn.ModuleList(layers)
        self.last = ComplexDense(_complex_dense_init(dims[-2], dims[-1], generator)) if outermost_linear else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, self.w0, self.sigma)
        if self.last is not None:
            x = self.last(x)
        return torch.real(x) if self.complex else x


def make_gabor_net(
    dim_in: int = 3,
    dim_hidden: int = 128,
    dim_out: int = 1,
    n_layers: int = 4,
    w0: float = 30.0,
    sigma: float = 10.0,
    lr: float = 3e-4,
    kind: str = "real",
    init_scheme: str = "auto",
    seed: int = 0,
    device: DeviceLike = None,
    outermost_linear: bool = False,
) -> GaborNet:
    """GaborNet with the JAX factory's defaults (``sigma`` is the Gabor scale
    c); parameters drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and moved to ``device`` (``cuda`` unless ``"cpu"``). ``outermost_linear``:
    WIRE's complex Linear last (see the module's docstring)."""
    dev = resolve_device(device)
    model = GaborNet(dim_in, dim_hidden, dim_out, n_layers, w0, sigma, kind, init_scheme,
                     torch.Generator().manual_seed(seed), outermost_linear)
    model.hparams = {"lr": lr, "w0": w0, "sigma": sigma}
    return model.to(dev)
