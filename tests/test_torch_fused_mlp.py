"""Port parity: the fused-MLP module (``ops/fused_mlp.py``) of
``mri_interpolation_tpu_torch`` against ``mri_interpolation_tpu/ops/pallas/
fused_mlp.py``, whose Pallas kernels run here in interpret mode, as
``tests/test_pallas.py`` runs them. On the CPU the port's wrappers take their
plain versions, the functions the CUDA kernels are held to on the card.

Inputs are made with numpy from a seed and handed to both packages; widths
8-48, 1-4 layers, batches of a few hundred, ragged against the Pallas tile.

Tolerances, absolute:

- relu, gelu and identity stacks: 1e-5 on outputs, dW, db and dx. XLA and
  PyTorch take the same float32 products and sums in another order: a few
  ulp of outputs of order 1 and of dW and db, which sum over the batch and
  reach ~10 here.
- stacks with sine layers at w0 = 30: 2e-5. The sine multiplies an
  ulp-level difference of its argument by w0 at every layer, and dW reaches
  ~30 here (1e-5 is ~10 ulp of it).
- activations and their derivatives, elementwise: 2e-6 for sine (whose
  derivative is w0 cos(w0 z), of size 30), 1e-6 for the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.ops.pallas import fused_mlp as jfm
from mri_interpolation_tpu_torch.ops import fused_mlp as fm

TILE = 64  # the Pallas tile in interpret mode; every batch below is ragged against it

STACKS = {
    # name: (widths, acts, batch)
    "siren": ([3, 32, 32, 32, 1], fm.siren_acts(3, 30.0, 30.0), 300),
    "siren_w0s": ([3, 24, 24, 2], fm.siren_acts(2, 25.0, 50.0), 257),
    "relu": ([32, 16, 1], fm.mlp_acts(1, "relu"), 301),
    "gelu": ([12, 20, 8, 3], fm.mlp_acts(2, "gelu"), 130),
    "id": ([5, 7], (("id",),), 65),
    "relu_deep": ([8, 16, 16, 16, 4], fm.mlp_acts(3, "relu"), 200),
}


def _tol(acts):
    return 2e-5 if any(a[0] == "sine" for a in acts) else 1e-5


def _stack(name, seed=0):
    """Weights, biases, x and g as numpy arrays for the named stack."""
    widths, acts, batch = STACKS[name]
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for l, (k, n) in enumerate(zip(widths[:-1], widths[1:])):
        if acts[0][0] == "sine":
            bound = 1.0 / k if l == 0 else np.sqrt(6.0 / k) / 30.0
        else:
            bound = 1.0 / np.sqrt(k)
        ws.append(rng.uniform(-bound, bound, (k, n)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (n,)).astype(np.float32))
    x = rng.uniform(-1, 1, (batch, widths[0])).astype(np.float32)
    g = rng.standard_normal((batch, widths[-1])).astype(np.float32)
    return ws, bs, x, g, acts


def _jax_flat(ws, bs):
    return tuple(jnp.asarray(a) for w, b in zip(ws, bs) for a in (w, b.reshape(1, -1)))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(STACKS))
def test_forward_matches_pallas_interpret(name):
    ws, bs, x, _, acts = _stack(name)
    want = jfm._forward_call(_jax_flat(ws, bs), jnp.asarray(x), len(ws) - 1, acts, TILE, True, ws[-1].shape[1])
    got = fm.mlp_forward(_torch(ws), _torch(bs), torch.from_numpy(x), acts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(acts))


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_backward_matches_pallas_interpret(name, need_dx):
    ws, bs, x, g, acts = _stack(name)
    out = jfm._backward_call(_jax_flat(ws, bs), jnp.asarray(x), jnp.asarray(g), len(ws) - 1, acts, TILE, True,
                             need_dx)
    grads, jdx = out if need_dx else (out, None)
    dws, dbs, dx = fm.mlp_backward(_torch(ws), _torch(bs), torch.from_numpy(x), torch.from_numpy(g), acts,
                                   need_dx)
    tol = _tol(acts)
    for l in range(len(ws)):
        np.testing.assert_allclose(dws[l].numpy(), np.asarray(grads[2 * l]), rtol=0, atol=tol, err_msg=f"dW{l}")
        np.testing.assert_allclose(dbs[l].numpy(), np.asarray(grads[2 * l + 1]).reshape(-1), rtol=0, atol=tol,
                                   err_msg=f"db{l}")
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=tol)
    else:
        assert dx is None


@pytest.mark.parametrize("act", [("sine", 30.0), ("sine", 7.5), ("relu",), ("gelu",), ("id",)],
                         ids=lambda a: "_".join(map(str, a)))
def test_activations_match_jax(act):
    z = np.linspace(-3, 3, 1201, dtype=np.float32)
    z[600] = 0.0  # relu's derivative at 0 is 0 in both
    tol = 2e-6 if act[0] == "sine" else 1e-6
    np.testing.assert_allclose(fm.act_apply(act, torch.from_numpy(z)).numpy(),
                               np.asarray(jfm._act(act, jnp.asarray(z))), rtol=0, atol=tol)
    np.testing.assert_allclose(fm.act_grad(act, torch.from_numpy(z)).numpy(),
                               np.asarray(jfm._act_grad(act, jnp.asarray(z))), rtol=0, atol=tol * 30)


def test_siren_and_mlp_entry_points_match_jax():
    ws, bs, x, g, acts = _stack("siren")
    jparams = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws[:-1], bs[:-1])],
               "last": {"w": jnp.asarray(ws[-1]), "b": jnp.asarray(bs[-1])}}
    tparams = {"layers": [{"w": w, "b": b} for w, b in zip(_torch(ws[:-1]), _torch(bs[:-1]))],
               "last": {"w": torch.from_numpy(ws[-1]), "b": torch.from_numpy(bs[-1])}}
    want = jfm.fused_siren_forward(jparams, jnp.asarray(x), 3, 30.0, 30.0, tile=TILE, interpret=True)
    got = fm.fused_siren_forward(tparams, torch.from_numpy(x), 3, 30.0, 30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert not got.requires_grad

    ws, bs, x, g, _ = _stack("relu_deep")
    jlayers = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]
    tlayers = [{"w": w, "b": b} for w, b in zip(_torch(ws), _torch(bs))]
    for act in ("relu", "gelu"):
        want = jfm.fused_mlp_forward(jlayers, jnp.asarray(x), act, tile=TILE, interpret=True)
        got = fm.fused_mlp_forward(tlayers, torch.from_numpy(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5, err_msg=act)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_mlp_apply_grads_match_jax(activation):
    """``fused_mlp_apply``'s custom VJP against the JAX one: every layer's
    dW and db, and the input cotangent (the JAX ``need_dx``)."""
    ws, bs, x, g, _ = _stack("relu_deep")
    jlayers = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]

    def jloss(layers, xx):
        return jnp.sum(jfm.fused_mlp_apply(layers, xx, activation, tile=TILE, interpret=True) * jnp.asarray(g))

    jgl, jgx = jax.grad(jloss, argnums=(0, 1))(jlayers, jnp.asarray(x))
    tlayers = [{"w": w.requires_grad_(), "b": b.requires_grad_()} for w, b in zip(_torch(ws), _torch(bs))]
    xt = torch.from_numpy(x).requires_grad_()
    (fm.fused_mlp_apply(tlayers, xt, activation) * torch.from_numpy(g)).sum().backward()
    for l, (tl, jl) in enumerate(zip(tlayers, jgl)):
        np.testing.assert_allclose(tl["w"].grad.numpy(), np.asarray(jl["w"]), rtol=0, atol=1e-5, err_msg=f"w{l}")
        np.testing.assert_allclose(tl["b"].grad.numpy(), np.asarray(jl["b"]), rtol=0, atol=1e-5, err_msg=f"b{l}")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0, atol=1e-5)


def test_fused_mlp_autograd_matches_torch_autograd():
    """FusedMLP's hand-written backward against PyTorch's autograd through
    the plain forward, for every layer and the input."""
    for name in sorted(STACKS):
        ws, bs, x, g, acts = _stack(name, seed=3)
        params = [t.requires_grad_() for pair in zip(_torch(ws), _torch(bs)) for t in pair]
        xt = torch.from_numpy(x).requires_grad_()
        (fm.FusedMLP.apply(xt, acts, *params) * torch.from_numpy(g)).sum().backward()
        fused = [p.grad.clone() for p in params] + [xt.grad.clone()]
        for p in params + [xt]:
            p.grad = None
        (fm.mlp_forward_reference(params[0::2], params[1::2], xt, acts) * torch.from_numpy(g)).sum().backward()
        for i, (a, p) in enumerate(zip(fused, params + [xt])):
            np.testing.assert_allclose(a.numpy(), p.grad.numpy(), rtol=0, atol=_tol(acts), err_msg=f"{name} {i}")


def test_input_gradient_only_when_asked():
    """SIREN's coordinates need no gradient: the backward then computes no
    dx; an encoder's features do, and get one."""
    ws, bs, x, g, acts = _stack("relu")
    calls = []
    original = fm.mlp_backward

    def spy(*args, **kwargs):
        calls.append(args[-1] if len(args) == 6 else kwargs.get("need_dx", False))
        return original(*args, **kwargs)

    fm.mlp_backward = spy
    try:
        for needs in (False, True):
            params = [t.requires_grad_() for pair in zip(_torch(ws), _torch(bs)) for t in pair]
            xt = torch.from_numpy(x).requires_grad_(needs)
            fm.FusedMLP.apply(xt, acts, *params).sum().backward()
            assert (xt.grad is not None) == needs
            assert all(p.grad is not None for p in params)
    finally:
        fm.mlp_backward = original
    assert calls == [False, True]


def test_frozen_parameters_get_no_gradient():
    ws, bs, x, g, acts = _stack("gelu")
    params = [t.requires_grad_(i != 0) for i, t in enumerate(t for pair in zip(_torch(ws), _torch(bs)) for t in pair)]
    fm.FusedMLP.apply(torch.from_numpy(x), acts, *params).sum().backward()
    assert params[0].grad is None and all(p.grad is not None for p in params[1:])


def test_stack_limits():
    """The kernels' limits, checked where the card is not needed."""
    assert fm.shared_bytes([3, 128, 1]) == 4 * (2 * 32 * 128 + 32 * 132)
    assert fm.shared_bytes([3, 352, 352, 1]) == 107_008  # two 45 KB buffers and one 16.9 KB chunk
    assert fm.shared_bytes([32, 832, 1]) <= 232_448 < fm.shared_bytes([32, 864, 1])
    assert fm._rows_per_slice(4096, [3] + [128] * 6 + [1]) % 32 == 0
    assert fm._rows_per_slice(100, [3, 8, 1]) == 128  # one slice
    assert fm.siren_acts(2, 25.0, 50.0) == (("sine", 50.0), ("sine", 25.0), ("id",))
    assert fm.mlp_acts(2, "relu") == (("relu",), ("relu",), ("id",))


def test_masked_reference_at_its_own_masks_is_the_plain_version():
    """The relu yardstick of the card checks (``mlp_backward_reference_masked``
    with ``relu_masks``) is the plain backward when the masks come from the
    same forward: on the CPU both are the plain version."""
    ws, bs, x, g, acts = _stack("relu")
    ws, bs, x, g = _torch(ws), _torch(bs), torch.from_numpy(x), torch.from_numpy(g)
    masks = fm.relu_masks(ws, bs, x, acts)
    assert sorted(masks) == [l for l, a in enumerate(acts) if a[0] == "relu"] and masks
    got = fm.mlp_backward_reference_masked(ws, bs, x, g, acts, True, masks)
    want = fm.mlp_backward_reference(ws, bs, x, g, acts, True)
    for a, b in zip(got[0] + got[1] + [got[2]], want[0] + want[1] + [want[2]]):
        assert torch.equal(a, b)
    flipped = {l: ~m for l, m in masks.items()}  # another mask changes the answer
    assert not torch.equal(fm.mlp_backward_reference_masked(ws, bs, x, g, acts, True, flipped)[0][0], want[0][0])


def test_backward_scratch_shape():
    """The backward's scratch: rows padded to its 64-row tiles; act'(z) and dz
    of every layer, h of every layer but the last, each layer's block
    rounded up to 4 floats (16 bytes)."""
    assert fm.scratch_shape(4097, [3, 128, 128, 1]) == (4160, 128 + 128 + 4, 256)
    assert fm.scratch_shape(64, [20, 64, 1]) == (64, 68, 64)
    assert fm.scratch_shape(1, [5, 7]) == (64, 8, 0)
