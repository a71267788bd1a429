"""The complex Dense of WIRE's complex layers (``models/gabor.py``:
``complex_dense``, ``weight_grad``, ``WEIGHT_GRADS``) on the CPU, against
autograd on the plain ``x @ w + b`` at complex64 and against the
complex128 product.

Tolerances, each with its reason: the forward, dX = dY wᴴ, db and the
weight gradient of a matrix output are the calls autograd makes, so they
are held bit for bit; a column output's weight gradient is taken as
(dYᴴ x)ᴴ, the same sums in another order, so it agrees with autograd's and
with the complex128 product to float32 rounding: a relative 1e-5 of the
norm. A weight gradient that drops the conjugate reads an error of order
one and misses it.
"""

import pytest
import torch

from mri_interpolation_tpu_torch.models import (make_freq_mlp, make_gabor_net, make_hash_mlp, make_hash_siren, make_mlp,
                                                make_modulated_siren, make_psf_siren, make_rff_net, make_siren,
                                                make_warp_inr)
from mri_interpolation_tpu_torch.models import gabor
from mri_interpolation_tpu_torch.models.core import Dense, dense

RTOL = 1e-5


def _complex(gen, *shape):
    return torch.complex(torch.randn(*shape, generator=gen), torch.randn(*shape, generator=gen))


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).to(torch.complex128)) / torch.linalg.vector_norm(b))


def _pair(rows, dim_in, dim_out, seed=29):
    gen = torch.Generator().manual_seed(seed)
    return _complex(gen, rows, dim_in), _complex(gen, dim_in, dim_out), _complex(gen, dim_out), _complex(
        gen, rows, dim_out)


def _grads(fn, x, w, b, g):
    """Forward and the gradients of Re(sum(y * conj(g))) in x, w, b: torch
    hands the product the gradient g, so the weight's is xᴴ g."""
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*leaves)
    return (y.detach(), *torch.autograd.grad((y * g.conj()).real.sum(), leaves))


# (x's shape, dim_out, the path counted)
CASES = {
    "matrix": ((8195, 19), 23, "matrix"),
    "matrix_wide": ((4099, 7), 41, "matrix"),
    "column": ((8195, 19), 1, "column"),
    "narrow_output": ((8195, 19), 2, "matrix"),
    "one_row": ((1, 19), 23, "matrix"),
    "leading_dims": ((5, 811, 19), 23, "matrix"),
    "leading_dims_column": ((5, 811, 19), 1, "column"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_against_autograd_and_the_complex128_product(case):
    shape, dim_out, path = CASES[case]
    gen = torch.Generator().manual_seed(29)
    x, w, b = _complex(gen, *shape), _complex(gen, shape[-1], dim_out), _complex(gen, dim_out)
    g = _complex(gen, *shape[:-1], dim_out)
    want = _grads(lambda x, w, b: dense(w, b, x), x, w, b, g)
    gabor.reset_weight_grads()
    got = _grads(lambda x, w, b: gabor.complex_dense(w, b, x), x, w, b, g)
    assert gabor.WEIGHT_GRADS == {"matrix": int(path == "matrix"), "column": int(path == "column")}
    for name, i in (("y", 0), ("dx", 1), ("db", 3)):
        assert torch.equal(got[i], want[i]), name
    rows = x.reshape(-1, shape[-1]).to(torch.complex128)
    exact = rows.mH @ g.reshape(-1, dim_out).to(torch.complex128)
    assert _rel(want[2], exact) <= RTOL
    assert _rel(got[2], exact) <= RTOL and _rel(got[2], want[2]) <= RTOL
    if path == "matrix":
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("dim_in,dim_out", [(19, 23), (19, 1), (1, 1)])
def test_a_dropped_conjugate_misses_the_tolerance(dim_in, dim_out):
    """``weight_grad`` of conj(x): xᵀ dY, the weight gradient without its
    conjugate."""
    x, _, _, g = _pair(8195, dim_in, dim_out)
    exact = x.to(torch.complex128).mH @ g.to(torch.complex128)
    assert _rel(gabor.weight_grad(x, g), exact) <= RTOL
    assert _rel(gabor.weight_grad(x.conj(), g), exact) > 100 * RTOL


@pytest.mark.parametrize("dim_in,dim_out", [(19, 23), (19, 1), (1, 1)])
def test_two_backward_passes_give_equal_bits(dim_in, dim_out):
    x, w, b, g = _pair(8195, dim_in, dim_out)
    first, again = (_grads(lambda x, w, b: gabor.complex_dense(w, b, x), x, w, b, g) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.parametrize("outermost_linear", [True, False])
def test_wire_counts_its_complex_weight_gradients(outermost_linear):
    """WIRE's form: the complex layers take one product each, the last (a
    column, a complex Dense or the last Gabor layer's) ``(dYᴴ x)ᴴ``; the real
    first layer is a plain ``Dense`` and counts nothing. The gradients equal
    those of the same net through ``core.dense``, bit for bit but the
    column's weight."""
    model = make_gabor_net(3, dim_hidden=16, n_layers=4, w0=20.0, sigma=10.0, kind="complex",
                           outermost_linear=outermost_linear, seed=5, device="cpu")
    assert type(model.layers[0].lin) is Dense
    assert all(type(m) is gabor.ComplexDense for m in (model.layers[1].lin, model.layers[2].lin))
    assert (type(model.last) is gabor.ComplexDense) if outermost_linear else model.last is None
    x = torch.rand(3 * 4096 + 5, 3, generator=torch.Generator().manual_seed(6)) * 2 - 1
    gabor.reset_weight_grads()
    for _ in range(2):
        model.zero_grad()
        model(x).square().mean().backward()
    widths = [m.w.shape[1] for m in model.modules() if type(m) is gabor.ComplexDense]
    assert gabor.WEIGHT_GRADS == {"matrix": 2 * sum(d > 1 for d in widths), "column": 2 * widths.count(1)}
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gabor.ComplexDense, "forward", lambda self, x: dense(self.w, self.b, x))
        model.zero_grad()
        model(x).square().mean().backward()
    for n, p in model.named_parameters():
        assert _rel(got[n], p.grad) <= RTOL, n
        if p.dim() == 1 or p.shape[1] > 1:  # all but a column's weight
            assert torch.equal(got[n], p.grad), n
    gabor.reset_weight_grads()
    assert gabor.WEIGHT_GRADS == {"matrix": 0, "column": 0}


_WARP = dict(n_levels=2, n_features_per_level=2, base_resolution=(2, 2), finest_resolution=(4, 4), dim_hidden=4,
             warp_hidden=4)
OTHERS = {
    "gabor_real": lambda: make_gabor_net(3, dim_hidden=8, n_layers=3, device="cpu"),
    "mlp": lambda: make_mlp(3, dim_hidden=8, n_layers=3, device="cpu"),
    "rff_net": lambda: make_rff_net(3, dim_hidden=8, n_layers=3, device="cpu"),
    "siren": lambda: make_siren(3, dim_hidden=8, n_layers=3, device="cpu"),
    "modulated_siren": lambda: make_modulated_siren(3, dim_hidden=8, n_layers=3, device="cpu"),
    "hash_siren": lambda: make_hash_siren(3, dim_hidden=8, n_layers=3, device="cpu"),
    "psf_siren": lambda: make_psf_siren(3, dim_hidden=8, n_layers=3, coordinates_spacing=(0.05,) * 3, device="cpu"),
    "freq_mlp": lambda: make_freq_mlp(3, dim_hidden=8, n_layers=3, device="cpu"),
    "hash_mlp": lambda: make_hash_mlp(3, log2_hashmap_size=10, device="cpu"),
    "warp_inr": lambda: make_warp_inr(3, device="cpu", **_WARP),
}


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_models_without_complex_weights_count_nothing(name):
    model = OTHERS[name]()
    gabor.reset_weight_grads()
    model(torch.rand(64, 3, generator=torch.Generator().manual_seed(7))).square().mean().backward()
    assert gabor.WEIGHT_GRADS == {"matrix": 0, "column": 0}
