"""Port parity: the flagship HashMLP (hash encoding + Linear/BatchNorm/GELU
decoder) of ``mri_interpolation_tpu_torch`` against the JAX package, with
the same parameters moved over by ``convert.params_from_jax``.

Tolerance: atol 1e-5 on outputs, BatchNorm statistics and every parameter
gradient (float32 summation order in the decoder's matrix products and batch
statistics differs between XLA and PyTorch on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.models import core as jcore
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.models import core, make_hash_mlp

ATOL = 1e-5
FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15), n_layers=2)


def _pair(decoder="norm", dim_hidden=16, n_layers=2, seed=0):
    """A JAX HashMLP and the port's, holding the same parameters. The table
    is redrawn U(-0.5, 0.5) so the encoder's features are not vanishingly
    small next to the decoder's."""
    kw = {**FLAGSHIP, "n_layers": n_layers}
    jm = jax_make_hash_mlp(dim_in=3, dim_hidden=dim_hidden, decoder=decoder, **kw)
    params, state = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.device_get(params)
    params["encoder"]["table"] = rng.uniform(-0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    state = jax.device_get(state)
    tm = make_hash_mlp(3, dim_hidden=dim_hidden, decoder=decoder, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    x = rng.random((256, 3), dtype=np.float32)
    x[0], x[1] = 0.0, 1.0
    y = rng.standard_normal((256, 1)).astype(np.float32)
    return jm, params, state, tm, x, y


@pytest.mark.parametrize("decoder", ["norm", "norm_proper"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(decoder, train):
    jm, params, state, tm, x, _ = _pair(decoder)
    y_jax, new_state = jm.apply(params, state, jnp.asarray(x), train=train, rng=None)
    tm.train(train)
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(y_jax), rtol=0, atol=ATOL)
    # the new BatchNorm running statistics (unchanged in eval)
    want = params_from_jax({}, jax.device_get(new_state))
    got = tm.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("decoder", ["norm", "norm_proper"])
def test_parameter_grads_match_jax(decoder):
    jm, params, state, tm, x, y = _pair(decoder)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True, rng=None)
        return jnp.mean((pred - jnp.asarray(y)) ** 2)

    grads = params_from_jax(jax.device_get(jax.grad(loss)(params)))
    tm.train()
    torch.mean((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    named = dict(tm.named_parameters())
    assert set(named) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=0, atol=ATOL, err_msg=key)
    assert float(named["encoder.table"].grad.abs().max()) > 0


def test_deeper_decoder_forward_matches_jax():
    jm, params, state, tm, x, _ = _pair("norm", dim_hidden=8, n_layers=3, seed=1)
    y_jax, _ = jm.apply(params, state, jnp.asarray(x), train=True, rng=None)
    tm.train()
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), np.asarray(y_jax), rtol=0, atol=ATOL)


def test_parameter_layout_is_the_jax_tree():
    jm = jax_make_hash_mlp(dim_in=3, dim_hidden=16, **FLAGSHIP)
    params, state = jm.init(jax.random.key(0))
    flat = params_from_jax(jax.device_get(params), jax.device_get(state))
    tm = make_hash_mlp(3, dim_hidden=16, device="cpu", **FLAGSHIP)
    sd = tm.state_dict()
    assert set(sd) == set(flat)
    for key in flat:
        assert tuple(sd[key].shape) == tuple(flat[key].shape), key
    assert sd["encoder.table"].shape == (156_258, 1)


def test_init_is_seeded_and_in_range():
    a = make_hash_mlp(3, dim_hidden=16, device="cpu", seed=4, **FLAGSHIP)
    b = make_hash_mlp(3, dim_hidden=16, device="cpu", seed=4, **FLAGSHIP)
    c = make_hash_mlp(3, dim_hidden=16, device="cpu", seed=5, **FLAGSHIP)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.encoder.table, c.encoder.table)
    assert float(a.encoder.table.detach().abs().max()) <= 1e-4
    bound = 1.0 / 4**0.5  # dense init U(+-1/sqrt(fan_in)), fan_in = L*F = 4
    assert float(a.layers[0].w.detach().abs().max()) <= bound


@pytest.mark.parametrize("kwargs", [dict(level_anneal_steps=10), dict(temporal_tv=0.1)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_hash_mlp(3, device="cpu", **kwargs)


def test_unknown_decoder_raises():
    with pytest.raises(ValueError, match="unknown decoder"):
        make_hash_mlp(3, device="cpu", decoder="nope")


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_apply_matches_jax(train):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 5)).astype(np.float32) * 3 + 1
    p = {"scale": rng.random(5).astype(np.float32), "bias": rng.standard_normal(5).astype(np.float32)}
    s = {"mean": rng.standard_normal(5).astype(np.float32), "var": rng.random(5).astype(np.float32) + 0.5}
    y_jax, s_jax = jcore.batchnorm_apply(p, s, jnp.asarray(x), train=train)
    t = {k: torch.from_numpy(v) for k, v in {**p, **s}.items()}
    y, mean, var = core.batchnorm_apply(torch.from_numpy(x), t["scale"], t["bias"], t["mean"], t["var"], train)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=0, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(s_jax["mean"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(s_jax["var"]), rtol=0, atol=ATOL)


def test_dense_layout_matches_jax():
    rng = np.random.default_rng(3)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((7, 4), (4, 3), (3,)))
    want = jcore.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = core.dense(torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_dropout():
    x = torch.ones(2000, 8)
    assert core.dropout(x, 0.5, train=False) is x
    assert core.dropout(x, 0.0, train=True) is x
    y = core.dropout(x, 0.25, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
