"""Port parity: the HashMLP options ``level_anneal_steps`` and ``temporal_tv``
and ``encodings.hashgrid.temporal_table_tv`` of ``mri_interpolation_tpu_torch``
against the JAX package, with the same parameters and state moved over by
``convert.params_from_jax``.

Tolerances and their reasons:

- the curriculum weights: exact (the same float32 operations in the same
  order);
- outputs of one forward: atol 1e-6 (a relu 24-16-1 decoder's float32 sums
  in another order);
- ``temporal_table_tv``: its value to rtol 1e-6 of the same sum in
  float64, and to rtol 1e-5 of the JAX value, whose float32 reduction over
  ~2*10^4 squares is itself 1.7e-6 off the float64 sum on the NGP shape (a
  sequential float32 sum of n terms errs by about sqrt(n) * 2^-24, 8.8e-6
  here); atol 1e-7 on its gradient;
- fits: rtol 1e-4 on every step's loss (test_torch_trainer.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGridEncoding
from mri_interpolation_tpu.encodings.hashgrid import temporal_table_tv as jax_temporal_table_tv
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.encodings.hashgrid import temporal_table_tv
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

NGP = dict(n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(4, 4, 2),
           finest_resolution=(16, 16, 8), growth="paper", decoder="relu_plain", dim_hidden=16, n_layers=2)
FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, n_layers=2)
ANNEAL = 12


def _pair(kw, seed=0, step=None):
    """A JAX HashMLP and the port's with the same parameters (table redrawn
    U(-0.5, 0.5)) and state, the anneal counter at ``step`` if given."""
    jm = jax_make_hash_mlp(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    if step is not None:
        state["anneal_step"] = np.int32(step)
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


@pytest.mark.parametrize("step", [0, 1, ANNEAL // 3, ANNEAL // 2, ANNEAL - 1, ANNEAL, 3 * ANNEAL])
@pytest.mark.parametrize("kw", [NGP, FLAGSHIP], ids=["ngp", "flagship"])
def test_anneal_weights_equal_jax(kw, step):
    jm, _, state, tm = _pair({**kw, "level_anneal_steps": ANNEAL}, step=step)
    want = np.asarray(jm.hparams["anneal_weights"](state))
    got = tm.anneal_weights().numpy()
    assert got.dtype == np.float32 and got.shape == (kw["n_levels"] * kw["n_features_per_level"],)
    np.testing.assert_array_equal(got, want)


def test_no_curriculum_no_weights_and_no_counter():
    tm = make_hash_mlp(3, device="cpu", **NGP)
    assert tm.anneal_weights() is None and "anneal_step" not in tm.state_dict() and tm.loss is None


def test_anneal_counter_round_trips_the_jax_state():
    _, _, state, tm = _pair({**NGP, "level_anneal_steps": ANNEAL}, step=7)
    assert tm.anneal_step.dtype == torch.int32 and tm.anneal_step.shape == () and int(tm.anneal_step) == 7
    moved = params_from_jax({}, state)["anneal_step"]
    assert moved.dtype == torch.int32 and torch.equal(moved, tm.state_dict()["anneal_step"])


@pytest.mark.parametrize("train", [True, False])
def test_annealed_forward_matches_jax_and_counts_training_only(train):
    jm, params, state, tm = _pair({**NGP, "level_anneal_steps": ANNEAL}, step=ANNEAL // 2)
    x = np.random.default_rng(3).random((300, 3), dtype=np.float32)
    y_jax, new_state = jm.apply(params, state, jnp.asarray(x), train=train, rng=None)
    tm.train(train)
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(y_jax), rtol=0, atol=1e-6)
    assert int(tm.anneal_step) == int(new_state["anneal_step"]) == ANNEAL // 2 + int(train)


def test_a_level_not_yet_annealed_in_does_not_reach_the_output():
    """At a quarter of the ramp (alpha 0.25: weights 1, 0.75, 0) the finest
    level's rows can change without changing the output."""
    _, _, _, tm = _pair({**NGP, "level_anneal_steps": ANNEAL}, step=ANNEAL // 4)
    x = torch.from_numpy(np.random.default_rng(3).random((300, 3), dtype=np.float32))
    tm.eval()
    with torch.no_grad():
        before = tm(x)
        tm.encoder.table[int(tm.encoder.geometry.level_offsets[2]):] += 1.0
        np.testing.assert_array_equal(tm(x).numpy(), before.numpy())
        tm.encoder.table[:int(tm.encoder.geometry.level_offsets[1])] += 1.0
        assert not torch.equal(tm(x), before)


GEOMETRIES = {
    "ngp": dict(dim=3, n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(4, 4, 2),
                finest_resolution=(16, 16, 8), growth="paper"),
    # levels 2-3 hashed (2^9 rows), level 0 one time cell
    "mixed": dict(dim=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=9, base_resolution=(3, 3, 1),
                  finest_resolution=(12, 12, 5)),
    "2d": dict(dim=2, n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
               finest_resolution=None, per_level_scale=1.5),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_temporal_table_tv_value_and_gradient_match_jax(name):
    jenc = JaxHashGridEncoding(**GEOMETRIES[name])
    enc = HashGridEncoding(**GEOMETRIES[name])
    table = np.random.default_rng(5).uniform(-1, 1, (enc.total_size, enc.n_features_per_level)).astype(np.float32)
    want, want_grad = jax.value_and_grad(lambda t: jax_temporal_table_tv(jenc, t))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    got = temporal_table_tv(enc, t)
    got.backward()
    exact = float(temporal_table_tv(enc, torch.from_numpy(table).double()))
    np.testing.assert_allclose(float(got), exact, rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-7)
    dense_rows = int(sum(enc.level_sizes[l] for l in range(enc.n_levels) if enc.level_dense[l]))
    if not enc.level_dense.all():  # hashed rows take no part
        assert not t.grad[dense_rows:].any() and t.grad[:dense_rows].abs().sum() > 0


@pytest.fixture(scope="module")
def dataset():
    return dataset_from_array(synthetic_volume((16, 16, 8), seed=7))


FITS = {
    "anneal_ngp": (dict(NGP, level_anneal_steps=6), dict(lr=1e-2, optimizer="adam_tcnn")),
    "anneal_flagship": (dict(FLAGSHIP, level_anneal_steps=6), dict(lr=5e-3)),
    # the model's loss is MSE + TV whatever the trainer's loss says (the JAX model's loss_fn)
    "tv_ngp": (dict(NGP, temporal_tv=1e-2), dict(lr=1e-2, loss="relative_l2")),
    "tv_anneal_flagship": (dict(FLAGSHIP, temporal_tv=0.1, level_anneal_steps=6), dict(lr=5e-3)),
}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_with_options_matches_jax(dataset, name):
    kw, cfg = FITS[name]
    jm, params, state, tm = _pair(kw)
    full = dict(batch_size=512, epochs=2, seed=0, shuffle=False, **cfg)
    jres = JaxTrainer(JaxTrainConfig(**full)).fit(jm, dataset.coords, dataset.values, params=params, state=state)
    tres = Trainer(TrainConfig(**full)).fit(tm, dataset.coords, dataset.values, device="cpu")
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-4)
    if "level_anneal_steps" in kw:
        assert int(tm.anneal_step) == int(jres.state["anneal_step"]) == tres.steps == 8
    if "temporal_tv" in kw:
        assert tm.loss is not None
        # the regulariser is in the loss: the same fit without it differs
        plain = make_hash_mlp(3, device="cpu", **{k: v for k, v in kw.items() if k != "temporal_tv"})
        plain.load_state_dict(params_from_jax(params, state))
        pres = Trainer(TrainConfig(**full)).fit(plain, dataset.coords, dataset.values, device="cpu")
        assert not np.allclose(pres.losses, tres.losses, rtol=1e-4)
