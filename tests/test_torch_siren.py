"""Port parity: the models of this slice, ``make_siren`` and
``make_hash_mlp(decoder="relu_plain")`` (the tcnn FullyFusedMLP shape), of
``mri_interpolation_tpu_torch`` against the JAX package, with the same
parameters moved over by ``convert.params_from_jax``. The JAX models run
their Pallas kernels in interpret mode (``fused="interpret"``) or their
unfused XLA paths (``fused="off"``); the port runs the kernels' plain
versions on the CPU. Inputs are made with numpy from a seed.

Tolerances and their reasons:

- outputs and every parameter gradient, the hash table's included (it gets
  the decoder's input cotangent): atol 2e-5 for SIREN, 1e-5 for the HashMLP.
  XLA and PyTorch take the float32 sums in another order; a sine layer at
  w0 = 30 multiplies that difference by 30.
- loss curves, step by step from one init with ``shuffle=False``: rtol 1e-4
  (the differences above compound over the Adam steps, as in
  ``test_torch_trainer.py``). The JAX trainer runs the models' XLA paths
  here (the same function; the tests above hold the Pallas paths to it).
- ``evaluate_grid`` of one SIREN on a (12, 10, 6) grid at ``lo=-1``: atol
  2e-5, as the outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.infer import evaluate_grid as jax_evaluate_grid
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.models import make_siren as jax_make_siren
from mri_interpolation_tpu.models import siren as jsiren
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import REGISTRY, get_model_factory, make_hash_mlp, make_siren
from mri_interpolation_tpu_torch.models import siren as tsiren
from mri_interpolation_tpu_torch.models.core import uniform_init
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

SIREN_ATOL = 2e-5
HASH_ATOL = 1e-5
RTOL = 1e-4
SIREN = dict(dim_hidden=32, n_layers=3)
TCNN = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
            finest_resolution=None, per_level_scale=1.6, dim_hidden=32, n_layers=2, decoder="relu_plain")


def _siren_pair(seed=0, fused="interpret", **kw):
    kw = {**SIREN, **kw}
    jm = jax_make_siren(dim_in=3, fused=fused, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    tm = tsiren.make_siren(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, state, tm


def _hash_pair(seed=0, fused="interpret", table_scale=0.5):
    """The JAX relu_plain HashMLP and the port's, holding the same
    parameters; the table is redrawn U(-0.5, 0.5) so the features are not
    vanishingly small next to the decoder's biases."""
    jm = jax_make_hash_mlp(dim_in=3, fused=fused, **TCNN)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(
        -table_scale, table_scale, params["encoder"]["table"].shape).astype(np.float32)
    tm = make_hash_mlp(3, device="cpu", **TCNN)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def _points(n, lo, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, 1.0, (n, 3)).astype(np.float32)
    x[0], x[1] = lo, 1.0
    return x, rng.standard_normal((n, 1)).astype(np.float32)


def _assert_grads(tm, jgrads, atol):
    want = params_from_jax(jax.device_get(jgrads))
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for key, g in want.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=0, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# SIREN


def test_siren_parameter_layout_is_the_jax_tree():
    jm = jax_make_siren(dim_in=3, fused="off", **SIREN)
    params, _ = jm.init(jax.random.key(0))
    flat = params_from_jax(jax.device_get(params))
    sd = make_siren(3, device="cpu", **SIREN).state_dict()
    assert set(sd) == set(flat) == {"layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b", "layers.2.w",
                                   "layers.2.b", "last.w", "last.b"}
    for key in flat:
        assert tuple(sd[key].shape) == tuple(flat[key].shape), key


def test_siren_init_is_seeded_and_in_range():
    a, b, c = (make_siren(3, device="cpu", seed=s, **SIREN) for s in (4, 4, 5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.layers[0].w, c.layers[0].w)
    assert float(a.layers[0].w.detach().abs().max()) <= 1.0 / 3  # first layer U(+-1/dim_in)
    bound = np.sqrt(6.0 / 32) / 30.0  # later layers U(+-sqrt(sigma/dim_in)/w0)
    for p in (a.layers[1].w, a.layers[2].b, a.last.w):
        assert float(p.detach().abs().max()) <= bound
    assert a.hparams["lr"] == 1e-4 and a.name == "siren"


@pytest.mark.parametrize("is_first", [True, False])
def test_siren_layer_init_and_apply_match_jax(is_first):
    """Same bound as the JAX ``siren_layer_init`` (the draws differ: JAX's PRNG
    is not torch's), and ``siren_layer_apply`` on the same parameters."""
    jp = jax.device_get(jsiren.siren_layer_init(jax.random.key(0), 16, 8, 30.0, 6.0, is_first))
    tp = tsiren.siren_layer_init(16, 8, 30.0, 6.0, is_first, torch.Generator().manual_seed(0))
    bound = 1.0 / 16 if is_first else np.sqrt(6.0 / 16) / 30.0
    for key in ("w", "b"):
        assert tp[key].shape == jp[key].shape and tp[key].dtype == torch.float32
        assert float(tp[key].abs().max()) <= bound and float(np.abs(jp[key]).max()) <= bound
        assert float(tp[key].abs().max()) > 0.8 * bound
    x = np.random.default_rng(2).uniform(-1, 1, (40, 16)).astype(np.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    for sine in (True, False):
        want = jsiren.siren_layer_apply(jp, jnp.asarray(x), 30.0, sine)
        got = tsiren.siren_layer_apply(tparams, torch.from_numpy(x), 30.0, sine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SIREN_ATOL)


def test_uniform_init_range_and_seed():
    a = uniform_init((64, 8), 0.25, torch.Generator().manual_seed(1))
    b = uniform_init((64, 8), 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert -0.25 <= float(a.min()) and float(a.max()) <= 0.25 and float(a.std()) > 0.1


@pytest.mark.parametrize("w0, w0_initial", [(30.0, 30.0), (25.0, 50.0)])
@pytest.mark.parametrize("fused", ["interpret", "off"])
def test_siren_forward_matches_jax(fused, w0, w0_initial):
    jm, params, state, tm = _siren_pair(fused=fused, w0=w0, w0_initial=w0_initial)
    x, _ = _points(301, -1.0)  # ragged against the Pallas tile of 512
    want, _ = jm.apply(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        unfused = tsiren._siren_forward(tm.params, torch.from_numpy(x), 3, w0, w0_initial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SIREN_ATOL)
    jref = jsiren._siren_forward(params, jnp.asarray(x), 3, w0, w0_initial)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(jref), rtol=0, atol=SIREN_ATOL)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0, atol=SIREN_ATOL)


@pytest.mark.parametrize("n_layers", [1, 4])
def test_siren_parameter_grads_match_jax(n_layers):
    jm, params, state, tm = _siren_pair(n_layers=n_layers, seed=n_layers)
    x, y = _points(257, -1.0, seed=n_layers)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2)

    jgrads = jax.grad(loss)(params)
    torch.mean((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    _assert_grads(tm, jgrads, SIREN_ATOL)


def test_siren_loss_curve_matches_jax():
    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7), zero_centered=True)
    jm, params, state, tm = _siren_pair(fused="off")
    cfg = dict(batch_size=256, epochs=1, lr=1e-4, seed=0, shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords, ds.values, params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords, ds.values, device="cpu")
    assert tres.steps == jres.steps == 8
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    assert tres.losses[-1] < tres.losses[0]


def test_siren_evaluate_grid_matches_jax():
    jm, params, state, tm = _siren_pair(fused="off", seed=3)
    shape = (12, 10, 6)
    want = jax_evaluate_grid(jm, params, state, shape, lo=-1.0, chunk_size=256)
    got = evaluate_grid(tm, shape, lo=-1.0, chunk_size=256, device="cpu")
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SIREN_ATOL)


# ---------------------------------------------------------------------------
# HashMLP, decoder="relu_plain"


@pytest.mark.parametrize("fused", ["interpret", "off"])
@pytest.mark.parametrize("train", [True, False])
def test_relu_plain_forward_matches_jax(fused, train):
    jm, params, state, tm = _hash_pair(fused=fused)
    x, _ = _points(300, 0.0)
    want, new_state = jm.apply(params, state, jnp.asarray(x), train=train)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=HASH_ATOL)
    assert new_state == {} and len(tm.bn) == 0  # no norm layers, no state


def test_relu_plain_parameter_grads_match_jax():
    """Every parameter gradient of the relu_plain HashMLP against jax.grad
    of the JAX model with its Pallas kernels in interpret mode; the table's
    gradient is the decoder's input cotangent (dx) through the hash-encode
    table gradient."""
    jm, params, state, tm = _hash_pair()
    x, y = _points(300, 0.0, seed=2)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2)

    jgrads = jax.grad(loss)(params)
    torch.mean((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    _assert_grads(tm, jgrads, HASH_ATOL)
    assert float(tm.encoder.table.grad.abs().max()) > 0


def test_relu_plain_loss_curve_with_adam_tcnn_matches_jax():
    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7))
    jm, params, state, tm = _hash_pair(fused="off")
    cfg = dict(batch_size=256, epochs=1, lr=1e-2, seed=0, shuffle=False, optimizer="adam_tcnn")
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords, ds.values, params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords, ds.values, device="cpu")
    assert tres.steps == jres.steps == 8
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    assert tres.losses[-1] < tres.losses[0]


def test_registry_names():
    assert get_model_factory("siren") is make_siren and get_model_factory("SirenNet") is make_siren
    assert get_model_factory("TcnnHashMLP") is make_hash_mlp
    for names, factory in ((("modulated_siren", "ModulatedSirenNet"), tsiren.make_modulated_siren),
                           (("hash_siren", "HashSirenNet"), tsiren.make_hash_siren),
                           (("psf_siren", "PsfSirenNet"), tsiren.make_psf_siren)):
        assert all(get_model_factory(name) is factory for name in names)
    assert set(REGISTRY) == {"siren", "SirenNet", "hash_mlp", "HashMLP", "TcnnHashMLP", "modulated_siren",
                             "ModulatedSirenNet", "hash_siren", "HashSirenNet", "psf_siren", "PsfSirenNet",
                             "multi_siren", "MultiSiren", "multi_hash_mlp", "MultiHashMLP", "mlp", "BaseMLP",
                             "rff_net", "RffNet", "gabor", "GaborNet", "freq_mlp", "FreqMLP", "warp_inr"}
    with pytest.raises(KeyError, match="unknown model"):
        get_model_factory("no_such_model")
