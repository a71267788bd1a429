"""Port parity: ``Trainer.fit`` of ``mri_interpolation_tpu_torch`` against the
JAX trainer, step by step, from the same initial parameters with
``shuffle=False`` on a synthetic (16, 16, 8) volume.

Tolerance: rtol 1e-4 on every step's loss (float32 summation order in the
decoder, batch statistics and Adam update differs between XLA and PyTorch,
and the differences compound over the steps). The shared init redraws the
hash table U(-0.5, 0.5). At the factories' own table init, U(-1e-4, 1e-4),
the encoder's features are ~1e-4 beside pre-BatchNorm biases of ~0.3, so
BatchNorm subtracts two nearly equal float32 numbers and its output carries
a relative error of about ulp(0.3) / 1e-4 = 3e-4 in either framework: those
curves are held to rtol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, TrainResult, make_optimizer

RTOL = 1e-4
SMALL = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
             base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, n_layers=2)


@pytest.fixture(scope="module")
def dataset():
    return dataset_from_array(synthetic_volume((16, 16, 8), seed=7))


def _shared_init(seed=0, table_scale=None, **kw):
    jm = jax_make_hash_mlp(dim_in=3, **{**SMALL, **kw})
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    if table_scale is not None:
        shape = params["encoder"]["table"].shape
        params["encoder"]["table"] = np.random.default_rng(seed).uniform(
            -table_scale, table_scale, shape).astype(np.float32)
    tm = make_hash_mlp(3, device="cpu", **{**SMALL, **kw})
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


@pytest.mark.parametrize(
    "cfg",
    [
        dict(batch_size=200, epochs=1),  # 10 steps, drop_last
        dict(batch_size=300, epochs=1, drop_last=False),  # 7 steps, the last wraps around
        dict(batch_size=400, epochs=2, weight_decay=1e-3),  # L2 through Adam's moments
    ],
    ids=["drop_last", "wrap_around", "weight_decay"],
)
@pytest.mark.parametrize("table_scale, rtol", [(0.5, RTOL), (None, 1e-3)], ids=["table_u0.5", "factory_init"])
def test_loss_curve_matches_jax(dataset, cfg, table_scale, rtol):
    jm, params, state, tm = _shared_init(table_scale=table_scale)
    full = dict(lr=5e-3, seed=0, shuffle=False, **cfg)
    jres = JaxTrainer(JaxTrainConfig(**full)).fit(jm, dataset.coords, dataset.values,
                                                  params=params, state=state)
    tres = Trainer(TrainConfig(**full)).fit(tm, dataset.coords, dataset.values, device="cpu")
    assert tres.steps == jres.steps and len(tres.losses) == len(jres.losses)
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=rtol)
    if table_scale is None:
        return  # the ill-conditioned start: the loss curve is the comparison
    # The parameters after the fit. A bias that feeds a BatchNorm has a true
    # gradient of zero (the batch mean cancels it), so Adam turns float noise
    # into full-size steps there, in both frameworks differently; that bias
    # and the running mean that tracks it are left out.
    want = params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state))
    got = tm.state_dict()
    skipped = {f"layers.{i}.b" for i in range(len(tm.bn))} | {f"bn.{i}.mean" for i in range(len(tm.bn))}
    for key, value in want.items():
        if key not in skipped:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=1e-4, err_msg=key)


def test_shuffled_fit_is_seeded_and_converges(dataset):
    cfg = TrainConfig(batch_size=256, epochs=8, lr=1e-2, seed=3)
    runs = []
    for _ in range(2):
        _, _, _, tm = _shared_init()
        runs.append(Trainer(cfg).fit(tm, dataset.coords, dataset.values, device="cpu"))
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    assert runs[0].steps == 8 * (len(dataset) // 256)
    assert runs[0].losses[-1] < 0.5 * runs[0].losses[0]
    _, _, _, tm = _shared_init()
    other = Trainer(TrainConfig(batch_size=256, epochs=8, lr=1e-2, seed=4)).fit(
        tm, dataset.coords, dataset.values, device="cpu")
    assert not np.array_equal(other.losses, runs[0].losses)


def test_fit_updates_batchnorm_state(dataset):
    _, _, _, tm = _shared_init()
    Trainer(TrainConfig(batch_size=512, epochs=1)).fit(tm, dataset.coords, dataset.values, device="cpu")
    assert float(tm.bn[0].mean.abs().sum()) > 0
    assert tm.training


def test_batch_larger_than_dataset_uses_whole_set(dataset):
    _, _, _, tm = _shared_init()
    res = Trainer(TrainConfig(batch_size=10**6, epochs=2)).fit(tm, dataset.coords, dataset.values,
                                                              device="cpu")
    assert res.steps == 2 and np.isfinite(res.losses).all()


def test_relative_l2_loss_matches_jax(dataset):
    jm, params, state, tm = _shared_init(table_scale=0.5)
    full = dict(batch_size=512, epochs=1, lr=5e-3, shuffle=False, loss="relative_l2")
    jres = JaxTrainer(JaxTrainConfig(**full)).fit(jm, dataset.coords, dataset.values,
                                                  params=params, state=state)
    tres = Trainer(TrainConfig(**full)).fit(tm, dataset.coords, dataset.values, device="cpu")
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)


@pytest.mark.parametrize("kwargs", [dict(lr_schedule="cosine"), dict(accumulate_grad_batches=2)])
def test_unported_optimizer_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(TrainConfig(**kwargs), [torch.nn.Parameter(torch.zeros(1))])


def test_unknown_optimizer_and_loss_raise(dataset):
    with pytest.raises(KeyError):
        make_optimizer(TrainConfig(optimizer="sgd"), [torch.nn.Parameter(torch.zeros(1))])
    _, _, _, tm = _shared_init()
    with pytest.raises(KeyError):
        Trainer(TrainConfig(loss="l1")).fit(tm, dataset.coords, dataset.values, device="cpu")


@pytest.mark.parametrize("optimizer, betas, eps", [("adam", (0.9, 0.999), 1e-8), ("adam_tcnn", (0.9, 0.99), 1e-15)])
def test_optimizer_is_torch_adam_with_l2(optimizer, betas, eps):
    opt = make_optimizer(TrainConfig(lr=1e-3, weight_decay=0.1, optimizer=optimizer),
                         [torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert group["betas"] == betas and group["eps"] == eps and group["weight_decay"] == 0.1


def test_train_result_rates():
    r = TrainResult(losses=np.array([3.0, 2.0, 1.0, 0.5]), wall_time_s=2.0, steps_per_sec=2.0, steps=4,
                    epoch_times_s=np.array([1.5, 0.25]))
    assert r.final_loss == 0.5
    assert r.steady_steps_per_sec == pytest.approx(8.0)  # 2 steps per epoch / 0.25 s
    one = TrainResult(losses=np.array([1.0]), wall_time_s=1.0, steps_per_sec=1.0, steps=1,
                      epoch_times_s=np.array([1.0]))
    assert one.steady_steps_per_sec == 1.0
