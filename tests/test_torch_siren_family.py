"""Port parity: the modulated, hash and PSF SIRENs (``make_modulated_siren``,
``make_hash_siren``, ``psf_offsets_and_weights``, ``make_psf_siren``) of
``mri_interpolation_tpu_torch`` against the JAX package, with the same
parameters moved over by ``convert.params_from_jax``. The port runs the hash
SIREN's encoder through the hash-encode kernels' plain versions on the CPU;
the JAX package fuses none of these models. Inputs are made with numpy from
a seed, coordinates in [-1, 1] as ``--zero_centered`` feeds them.

Tolerances and their reasons (``test_torch_siren.py``'s bounds):

- outputs and every parameter gradient: atol 2e-5. XLA and PyTorch take
  the float32 sums in another order; a sine layer at w0 = 30 multiplies that
  difference by 30. The hash SIREN's table gradient: atol 1e-5 (the hash
  encode's sums of a few weighted cotangents);
- the PSF offsets and weights: exactly equal (the same numpy operations);
- the PSF loss: rtol 1e-5 (a mean of K-point Gaussian sums of outputs held
  to 2e-5);
- loss curves, 10 steps from one init with ``shuffle=False``: rtol 1e-4
  (the differences above compound over the Adam steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.models import siren as jsiren
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import siren as tsiren
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

SIREN_ATOL = 2e-5
TABLE_ATOL = 1e-5
RTOL = 1e-4
SMALL = dict(dim_hidden=24, n_layers=3)
# hash_siren's encoder at a small size: dense coarse levels and hashed fine ones, as its 10-level geometry
HASH = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4, per_level_scale=2.0)
SPACING = (0.5 / 15, 0.5 / 15, 0.5 / 7)  # the launcher's half-voxel spacing of a (16, 16, 8) volume
MODELS = {
    "modulated_siren": (jsiren.make_modulated_siren, tsiren.make_modulated_siren, SMALL),
    "hash_siren": (jsiren.make_hash_siren, tsiren.make_hash_siren, {**SMALL, **HASH}),
    "psf_siren": (jsiren.make_psf_siren, tsiren.make_psf_siren,
                  {**SMALL, "coordinates_spacing": SPACING, "n_sample": 3}),
}


def _pair(name, seed=0, **extra):
    jmake, tmake, kw = MODELS[name]
    kw = {**kw, **extra}
    jm = jmake(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    if "encoder" in params:
        # U(-0.01, 0.01), 100x the init: features that matter beside the modulator's biases, while the
        # clamped dense levels' extrapolation at x = -1 (weights up to 5^3) keeps them within ~10
        params["encoder"]["table"] = np.random.default_rng(seed).uniform(
            -0.01, 0.01, params["encoder"]["table"].shape).astype(np.float32)
    tm = tmake(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[0], x[1] = -1.0, 1.0
    return x, rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_layout_is_the_jax_tree(name):
    _, params, _, tm = _pair(name)
    flat = params_from_jax(params)
    sd = tm.state_dict()
    assert set(sd) == set(flat)
    for key in flat:
        assert tuple(sd[key].shape) == tuple(flat[key].shape), key
    if name != "psf_siren":
        assert {"siren.layers.0.w", "siren.last.b", "modulator.2.w"} <= set(sd)
    assert ("encoder.table" in sd) == (name == "hash_siren")
    assert tm.name == name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_is_seeded_and_in_range(name):
    _, tmake, kw = MODELS[name]
    a, b, c = (tmake(3, device="cpu", seed=s, **kw) for s in (4, 4, 5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert any(not torch.equal(p, q) for p, q in zip(a.parameters(), c.parameters()))
    if name != "psf_siren":
        d0 = a.modulator[0].w.shape[0]
        assert float(a.modulator[0].w.detach().abs().max()) <= 1.0 / np.sqrt(d0)
        assert float(a.modulator[1].w.detach().abs().max()) <= 1.0 / np.sqrt(24 + d0)
        assert d0 == (3 if name == "modulated_siren" else a.encoder.geometry.output_dim)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name):
    jm, params, state, tm = _pair(name)
    x, _ = _points(301)
    want, _ = jm.apply(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SIREN_ATOL)


@pytest.mark.parametrize("name", ["modulated_siren", "hash_siren"])
def test_parameter_grads_match_jax(name):
    """Every parameter gradient of the MSE against ``jax.grad``; the hash
    SIREN's table gets the modulator's input cotangent through the hash
    encode's table gradient."""
    jm, params, state, tm = _pair(name, seed=2)
    x, y = _points(257, seed=2)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2)

    jgrads = params_from_jax(jax.device_get(jax.grad(loss)(params)))
    torch.mean((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).backward()
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for key, g in jgrads.items():
        atol = TABLE_ATOL if key == "encoder.table" else SIREN_ATOL
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), rtol=0, atol=atol, err_msg=key)
    if name == "hash_siren":
        assert float(tm.encoder.table.grad.abs().max()) > 0


@pytest.mark.parametrize("spacing, n_sample", [(SPACING, 5), (SPACING, 3), ((0.01, 0.02), 4), ((0.03,), 1)])
def test_psf_offsets_and_weights_equal_jax(spacing, n_sample):
    offsets, weights = tsiren.psf_offsets_and_weights(spacing, n_sample)
    joffsets, jweights = jsiren.psf_offsets_and_weights(spacing, n_sample)
    assert offsets.dtype == weights.dtype == np.float32
    assert offsets.shape == (n_sample ** len(spacing), len(spacing))
    np.testing.assert_array_equal(offsets, joffsets)
    np.testing.assert_array_equal(weights, jweights)


def test_psf_loss_and_its_grads_match_jax():
    """The PSF objective (the model's ``loss``: K = 27 offsets a voxel, the
    Gaussian sum, the MSE) against the JAX ``loss_fn``, and every parameter
    gradient of it against ``jax.grad``; the forward alone is the plain
    SIREN, which ``test_forward_matches_jax`` holds."""
    jm, params, state, tm = _pair("psf_siren", seed=3)
    x, y = _points(97, seed=3)

    def loss(p):
        return jm.loss_fn(p, state, (jnp.asarray(x), jnp.asarray(y)), None, True)[0]

    want, jgrads = jax.value_and_grad(loss)(params)
    got = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    for key, g in params_from_jax(jax.device_get(jgrads)).items():
        np.testing.assert_allclose(dict(tm.named_parameters())[key].grad.numpy(), g.numpy(), rtol=0,
                                   atol=SIREN_ATOL, err_msg=key)


def test_psf_siren_needs_its_spacing():
    with pytest.raises(ValueError, match="coordinates_spacing"):
        tsiren.make_psf_siren(3, device="cpu")


@pytest.mark.parametrize("name, batch", [("modulated_siren", 204), ("hash_siren", 204), ("psf_siren", 64)])
def test_loss_curves_match_jax(name, batch):
    """Ten Adam steps from one init, ``shuffle=False``, on a zero-centred
    (16, 16, 8) volume; the PSF SIREN through its loss hook on both sides."""
    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7), zero_centered=True)
    jm, params, state, tm = _pair(name, seed=4)
    n = 10 * batch
    cfg = dict(batch_size=batch, epochs=1, lr=1e-4, seed=0, shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords[:n], ds.values[:n], params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords[:n], ds.values[:n], device="cpu")
    assert tres.steps == jres.steps == 10
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
