"""Port parity: the trainer's options of ``mri_interpolation_tpu_torch``
against the JAX trainer, from the same initial parameters with
``shuffle=False``: the cosine schedule, gradient accumulation
(``optax.MultiSteps``), the freeze mask, remat, and ``fit_frames`` with all
three of the first.

Tolerances, as in test_torch_trainer.py: rtol 1e-4 on every step's loss and
atol 1e-5 on the final parameters (float32 summation orders differ between
XLA and PyTorch and compound over the Adam steps); the learning rate per
update to 1e-7 against ``optax.cosine_decay_schedule`` (the JAX schedule is
float32, the port's float64); remat against the same fit without it to rtol
1e-6, buffers included (the same operations recomputed). Tables are redrawn
U(-0.5, 0.5), as there, so BatchNorm does not cancel nearly equal numbers.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.models import make_multi_hash_mlp as jax_make_multi_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, make_schedule
from mri_interpolation_tpu_torch.train.trainer import _Updates

RTOL, ATOL = 1e-4, 1e-5
FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, n_layers=2)
# the NGP paper+cosine HashMLP's shape (3 levels x F=8, paper growth, relu_plain), cut to (16, 16, 8)
NGP = dict(n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(4, 4, 2),
           finest_resolution=(16, 16, 8), growth="paper", decoder="relu_plain", dim_hidden=16, n_layers=2)
MULTI = dict(dim_in=2, n_frames=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
             base_resolution=4, per_level_scale=1.5, dim_hidden=16, n_layers=2)


@pytest.fixture(scope="module")
def dataset():
    return dataset_from_array(synthetic_volume((16, 16, 8), seed=7))  # 2,048 voxels


def _pair(kw, seed=0):
    """A JAX HashMLP and the port's with the same parameters (table U(-0.5, 0.5))."""
    jm = jax_make_hash_mlp(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def _fit_both(dataset, kw, cfg, jax_mask=None, port_mask=None):
    jm, params, state, tm = _pair(kw)
    full = dict(seed=0, shuffle=False, **cfg)
    jres = JaxTrainer(JaxTrainConfig(**full), freeze_mask_fn=jax_mask).fit(
        jm, dataset.coords, dataset.values, params=params, state=state)
    tres = Trainer(TrainConfig(**full), freeze_mask_fn=port_mask).fit(tm, dataset.coords, dataset.values,
                                                                     device="cpu")
    return params, jres, tm, tres


def _assert_same_fit(jres, tm, tres, skip=()):
    assert tres.steps == jres.steps and len(tres.losses) == len(jres.losses)
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    want = params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state))
    got = tm.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        if key not in skip:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=ATOL, err_msg=key)


def _rates(cfg, n_steps_per_epoch, mini_steps):
    """The rate each inner update of ``_Updates`` ran at, over ``mini_steps``
    mini-steps of a one-parameter model."""
    model = torch.nn.Linear(1, 1)
    updates = _Updates(cfg, model, n_steps_per_epoch)
    rates = []
    for _ in range(mini_steps):
        updates.zero_grad()
        model(torch.ones(1, 1)).sum().backward()
        before = updates.updates
        updates.step()
        if updates.updates > before:
            rates.append(updates.optimizer.param_groups[0]["lr"])
    return rates


@pytest.mark.parametrize("t_max, spe, k", [(2, 5, 1), (1, 7, 1), (3, 4, 3), (1, 4, 2)],
                         ids=["D10", "D7", "D12_k3", "D4_k2"])
def test_cosine_rate_per_update_matches_optax(t_max, spe, k):
    """The rate of update c is optax's cosine at c: 0 from D on (D in
    mini-steps; with k > 1 the updates count inner updates, so the cosine
    reaches only 1/k of its decay within D mini-steps)."""
    lr = 1e-2
    cfg = TrainConfig(lr=lr, lr_schedule="cosine", cosine_t_max=t_max, accumulate_grad_batches=k)
    decay = t_max * spe
    schedule = optax.cosine_decay_schedule(init_value=lr, decay_steps=decay)
    want = [float(schedule(c)) for c in range(3 * decay // k + 1)]
    got = [make_schedule(cfg, spe)(c) for c in range(len(want))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[decay] == 0.0 and got[-1] == 0.0  # past D it stays at 0, not cyclic
    rates = _rates(cfg, spe, 3 * decay + k - 1)  # the last window partial: no update
    assert len(rates) == 3 * decay // k
    np.testing.assert_allclose(rates, want[:len(rates)], rtol=0, atol=1e-7)
    if k > 1:  # D mini-steps hold D / k updates: the cosine is at its (1 + cos(pi / k)) / 2
        assert rates[decay // k - 1] > 0.5 * lr * (1 + np.cos(np.pi / k)) - 1e-7


def test_constant_rate_and_unknown_schedule():
    assert _rates(TrainConfig(lr=3e-3), 4, 5) == [3e-3] * 5
    with pytest.raises(ValueError, match="lr_schedule"):
        make_schedule(TrainConfig(lr_schedule="linear"))


def test_cosine_fit_of_the_ngp_shape_matches_jax(dataset):
    """3 levels x F=8, paper growth, relu_plain, adam_tcnn, cosine over 2
    epochs of 4 steps: the rate reaches 0 at the last update's end."""
    cfg = dict(batch_size=512, epochs=2, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=2)
    _, jres, tm, tres = _fit_both(dataset, NGP, cfg)
    _assert_same_fit(jres, tm, tres)


@pytest.mark.parametrize("schedule", [None, "cosine"], ids=["constant", "cosine"])
def test_accumulation_matches_multisteps(dataset, schedule):
    """k = 3 over 2 epochs of 4 mini-steps: the second window spans the epoch
    boundary and the last two mini-steps (a partial window) are dropped. One
    loss a mini-step; Adam and the cosine count the 2 inner updates (with
    cosine_t_max 1 the cosine's D is 4 mini-steps)."""
    cfg = dict(batch_size=512, epochs=2, lr=1e-2, accumulate_grad_batches=3, lr_schedule=schedule,
               cosine_t_max=1)
    _, jres, tm, tres = _fit_both(dataset, NGP, cfg)
    assert tres.steps == 8
    _assert_same_fit(jres, tm, tres)


def test_accumulation_updates_once_a_window_and_drops_the_partial_one(dataset):
    _, _, _, tm = _pair(NGP)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = TrainConfig(batch_size=512, epochs=1, lr=1e-2, accumulate_grad_batches=5, shuffle=False)
    Trainer(cfg).fit(tm, dataset.coords, dataset.values, device="cpu")  # 4 mini-steps < 5
    for key, value in tm.state_dict().items():
        assert torch.equal(value, start[key]), key


def _decoder_frozen_jax(params):
    return jax.tree_util.tree_map_with_path(lambda path, _: path[0].key == "encoder", params)


def _decoder_frozen_port(named):
    return {name: name.startswith("encoder.") for name in named}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["wd0", "wd1e-3"])
def test_freeze_mask_matches_jax(dataset, weight_decay):
    """The decoder frozen (the two-phase protocol's): its gradient is zeroed
    before weight decay, so it stays put at wd = 0 and moves under decay
    alone at wd > 0, as in the JAX chain. On the relu_plain shape: the
    flagship's decoder ends in a BatchNorm of width 1, whose backward cancels
    near the batch mean, and Adam turns that float noise in a table row
    touched by one point into a step that differs by ~2e-4 between the two
    frameworks (its loss curves still agree to 2e-6); the card's phase 4
    holds the flagship's frozen fit to the CPU's loss curve."""
    cfg = dict(batch_size=512, epochs=2, lr=5e-3, weight_decay=weight_decay)
    params, jres, tm, tres = _fit_both(dataset, NGP, cfg, _decoder_frozen_jax, _decoder_frozen_port)
    _assert_same_fit(jres, tm, tres)
    start = params_from_jax(params)
    for name, p in tm.named_parameters():
        moved = not torch.equal(p.detach(), start[name])
        assert moved == (name.startswith("encoder.") or weight_decay > 0), name


def test_freeze_mask_must_name_every_parameter(dataset):
    _, _, _, tm = _pair(FLAGSHIP)
    with pytest.raises(ValueError, match="freeze mask"):
        Trainer(TrainConfig(), freeze_mask_fn=lambda named: {"encoder.table": True}).fit(
            tm, dataset.coords, dataset.values, device="cpu")


REMAT_MODELS = {"flagship_anneal": dict(FLAGSHIP, level_anneal_steps=5), "ngp_tv": dict(NGP, temporal_tv=1e-2)}


@pytest.mark.parametrize("name", list(REMAT_MODELS))
def test_remat_is_value_identical_and_matches_jax(dataset, name):
    """remat recomputes the forward in the backward; BatchNorm statistics and
    the anneal counter still advance once a step."""
    kw = REMAT_MODELS[name]
    cfg = dict(batch_size=512, epochs=2, lr=5e-3, remat=True)
    _, jres, tm, tres = _fit_both(dataset, kw, cfg)
    _, _, _, plain = _pair(kw)
    pres = Trainer(TrainConfig(**{**cfg, "remat": False}, seed=0, shuffle=False)).fit(
        plain, dataset.coords, dataset.values, device="cpu")
    np.testing.assert_allclose(tres.losses, pres.losses, rtol=1e-6)
    for key, value in plain.state_dict().items():
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), value.numpy(), rtol=1e-6, atol=1e-7, err_msg=key)
    if "level_anneal_steps" in kw:
        assert int(tm.anneal_step) == tres.steps == 8
    # the BatchNorm-fed biases and the running means that track them move by float noise (test_torch_trainer.py)
    noisy = {f"layers.{i}.b" for i in range(len(tm.bn))} | {f"bn.{i}.mean" for i in range(len(tm.bn))}
    _assert_same_fit(jres, tm, tres, skip=noisy)


def _multi_pair(seed=0):
    jm = jax_make_multi_hash_mlp(**MULTI)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoders"]["table"].shape
    params["encoders"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    tm = make_multi_hash_mlp(device="cpu", **MULTI)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, state, tm


@pytest.mark.parametrize("frozen", [False, True], ids=["all_trainable", "decoder_frozen"])
def test_fit_frames_with_cosine_accumulation_and_freeze_matches_jax(frozen):
    """3 frames x 3 epochs, k = 2 (a window spans each epoch boundary, the
    ninth mini-step is dropped), cosine over 2 epochs of frames, weight
    decay 1e-5 (the multi-frame models' default)."""
    jm, params, state, tm = _multi_pair()
    rng = np.random.default_rng(1)
    xs = np.linspace(0, 1, 12, dtype=np.float32)
    coords = np.stack([a.reshape(-1) for a in np.meshgrid(xs, xs[:10], indexing="ij")], axis=-1)
    values = rng.uniform(0, 1, (3, coords.shape[0], 1)).astype(np.float32)
    cfg = dict(batch_size=coords.shape[0], epochs=3, lr=5e-3, weight_decay=1e-5, seed=0, lr_schedule="cosine",
               cosine_t_max=2, accumulate_grad_batches=2)
    jmask = (lambda p: jax.tree_util.tree_map_with_path(lambda path, _: path[0].key == "encoders", p)) if frozen \
        else None
    pmask = (lambda named: {n: n.startswith("encoders.") for n in named}) if frozen else None
    jres = JaxTrainer(JaxTrainConfig(**cfg), freeze_mask_fn=jmask).fit_frames(jm, coords, values, params=params,
                                                                             state=state)
    tres = Trainer(TrainConfig(**cfg), freeze_mask_fn=pmask).fit_frames(tm, coords, values, device="cpu")
    assert tres.steps == 9
    _assert_same_fit(jres, tm, tres)
