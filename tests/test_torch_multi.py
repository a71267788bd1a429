"""Port parity: the multi-frame models (``make_multi_siren``,
``make_multi_hash_mlp``), ``Trainer.fit_frames`` and
``evaluate_grid(frame_idx=...)`` of ``mri_interpolation_tpu_torch`` against
the JAX package, with the same parameters moved over by
``convert.params_from_jax``. The JAX models run unfused XLA code (the
reference has no kernel on this path but the encode); the port runs its
kernels' plain versions on the CPU. Inputs are made with numpy from a seed.

Tolerances and their reasons:

- outputs and every parameter gradient: atol 1e-5, 2e-5 with sine layers
  (XLA and PyTorch take the float32 sums in another order; a sine layer at
  w0 = 30 multiplies that difference by 30);
- ``fit_frames`` loss curves, 2 epochs x 3 frames from one init: rtol 1e-4
  (the differences above compound over the Adam steps, as in
  test_torch_trainer.py);
- ``evaluate_grid`` of one frame: atol 1e-4 for the hash model (as
  test_torch_pipeline.py's grid), 2e-5 for the SIREN at lo = -1 (as its
  outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.infer import evaluate_grid as jax_evaluate_grid
from mri_interpolation_tpu.models import make_multi_hash_mlp as jax_make_multi_hash_mlp
from mri_interpolation_tpu.models import make_multi_siren as jax_make_multi_siren
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import REGISTRY, MultiHashMLP, MultiSiren, make_multi_hash_mlp, make_multi_siren
from mri_interpolation_tpu_torch.ops import fused_mlp as fm
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

N_FRAMES = 3
SIREN = dict(dim_in=2, dim_hidden=16, n_layers=2, n_frames=N_FRAMES)
HASH = dict(dim_in=2, n_frames=N_FRAMES, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
            base_resolution=4, per_level_scale=1.5, dim_hidden=16, n_layers=2)
ATOL = {"siren": 2e-5, "hash": 1e-5}
RTOL = 1e-4
SHAPE = (12, 10)  # one frame's grid


def _pair(kind, seed=0):
    """The JAX model and the port's, holding the same parameters; the hash
    tables are redrawn U(-0.5, 0.5) so the features are not vanishingly small
    next to the decoder's biases."""
    if kind == "siren":
        jm = jax_make_multi_siren(**SIREN)
        tm = make_multi_siren(device="cpu", **SIREN)
    else:
        jm = jax_make_multi_hash_mlp(**HASH)
        tm = make_multi_hash_mlp(device="cpu", **HASH)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    if kind == "hash":
        shape = params["encoders"]["table"].shape
        params["encoders"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, state, tm


def _frames(kind, seed=1, shared=True):
    """Coordinates of a (12, 10) frame grid, in [-1, 1] for the SIREN, and
    N_FRAMES frames of values."""
    rng = np.random.default_rng(seed)
    lo = -1.0 if kind == "siren" else 0.0
    xs = np.linspace(lo, 1, SHAPE[0], dtype=np.float32)
    ys = np.linspace(lo, 1, SHAPE[1], dtype=np.float32)
    coords = np.stack([a.reshape(-1) for a in np.meshgrid(xs, ys, indexing="ij")], axis=-1)
    values = rng.uniform(lo, 1, (N_FRAMES, coords.shape[0], 1)).astype(np.float32)
    if not shared:
        coords = np.stack([coords + np.float32(0.01 * t) for t in range(N_FRAMES)])
    return coords, values


def test_parameter_names_and_shapes_are_the_jax_tree():
    for kind in ("siren", "hash"):
        _, params, _, tm = _pair(kind)
        want = {k: tuple(v.shape) for k, v in params_from_jax(params).items()}
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    _, params, _, tm = _pair("hash")
    assert tm.encoders.table.shape[0] == N_FRAMES and tm.encoders.table[1].is_contiguous()
    assert "encoders.layers.0.w" in dict(_pair("siren")[3].named_parameters())


def test_registry_names():
    for name in ("multi_siren", "MultiSiren"):
        assert REGISTRY[name] is make_multi_siren
    for name in ("multi_hash_mlp", "MultiHashMLP"):
        assert REGISTRY[name] is make_multi_hash_mlp
    assert isinstance(make_multi_siren(device="cpu", **SIREN), MultiSiren)
    assert isinstance(make_multi_hash_mlp(device="cpu", **HASH), MultiHashMLP)


@pytest.mark.parametrize("kind,frame", [("siren", 0), ("siren", 2), ("hash", 0), ("hash", 1)])
def test_outputs_and_gradients_match_jax(kind, frame):
    jm, params, state, tm = _pair(kind)
    coords, values = _frames(kind)
    x, y = coords[:97], values[frame, :97]

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True, frame_idx=frame)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, pred), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x), frame_idx=frame)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(pred), rtol=0, atol=ATOL[kind])
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    named = dict(tm.named_parameters())
    for key, want in params_from_jax(jax.device_get(grads)).items():
        got = named[key].grad.numpy()
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL[kind], err_msg=key)
        if key.startswith("encoders."):  # a stacked leaf: the other frames get zeros
            assert not np.delete(got, frame, axis=0).any(), key


FITS = [("siren", 0.0, True), ("siren", 1e-5, False), ("hash", 0.0, False), ("hash", 1e-5, True)]


@pytest.mark.parametrize("kind,weight_decay,shared", FITS,
                         ids=[f"{k}-wd{w:g}-{'shared' if s else 'per_frame'}" for k, w, s in FITS])
def test_fit_frames_loss_curve_matches_jax(kind, weight_decay, shared):
    """Two epochs over three frames from one init. With weight decay the
    frames not in the step still move (their gradient is wd * p): the
    stacked parameters keep the JAX optimizer's semantics."""
    jm, params, state, tm = _pair(kind)
    coords, values = _frames(kind, shared=shared)
    lr = 1e-4 if kind == "siren" else 5e-3
    cfg = dict(epochs=2, lr=lr, weight_decay=weight_decay, seed=0)
    jres = JaxTrainer(JaxTrainConfig(batch_size=coords.shape[-2], **cfg)).fit_frames(
        jm, coords, values, params=params, state=state)
    tres = Trainer(TrainConfig(batch_size=coords.shape[-2], **cfg)).fit_frames(tm, coords, values, device="cpu")
    assert tres.steps == 2 * N_FRAMES and len(tres.losses) == 2 * N_FRAMES and len(tres.epoch_times_s) == 2
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=RTOL)
    assert tres.steady_steps_per_sec > 0


@pytest.mark.parametrize("kind,frame", [("siren", 1), ("hash", 2)])
def test_evaluate_grid_of_a_frame_matches_jax(kind, frame):
    jm, params, state, tm = _pair(kind, seed=3)
    lo = -1.0 if kind == "siren" else 0.0
    want = jax_evaluate_grid(jm, params, state, SHAPE, lo=lo, chunk_size=64, frame_idx=frame)
    got = evaluate_grid(tm, SHAPE, lo=lo, chunk_size=64, device="cpu", frame_idx=frame)
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5 if kind == "siren" else 1e-4)
    other = evaluate_grid(tm, SHAPE, lo=lo, chunk_size=64, device="cpu", frame_idx=0)
    assert np.abs(other - got).max() > 1e-3  # another frame's encoder gives another volume


def test_fit_frames_on_cpu_launches_no_kernel():
    _, _, _, tm = _pair("hash")
    coords, values = _frames("hash")
    he.reset_launches()
    fm.reset_launches()
    Trainer(TrainConfig(epochs=1, lr=5e-3)).fit_frames(tm, coords, values, device="cpu")
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_launcher_runs_a_multi_model_as_the_jax_launcher_does(tmp_path):
    """``--model_class multi_hash_mlp`` goes through build_model and
    Trainer.fit, the model answering frame 0 (no branch of its own)."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((8, 8, 4), seed=2), path)
    summary = launcher.main(["--model_class", "multi_hash_mlp", "--image_path", path, "--device", "cpu",
                             "--epochs", "1", "--batch_size", "64", "--n_levels", "2", "--log2_hashmap_size", "8",
                             "--base_resolution", "4", "--per_level_scale", "1.5", "--dim_hidden", "8",
                             "--interp_shapes", "(8,8,6)", "--output_root", str(tmp_path / "runs")])
    assert summary["model"] == "multi_hash_mlp" and summary["steps"] == 4 and np.isfinite(summary["psnr"])
