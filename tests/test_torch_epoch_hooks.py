"""Port parity: the trainer's epoch hooks (the scalars stream, periodic eval,
epoch checkpoints), ``train/checkpoint.py``, ``infer.predict_batched`` and
the launcher's resume and eval of ``mri_interpolation_tpu_torch`` against
the JAX package.

Tolerances and their reasons:

- scalars records: the same keys, steps, epochs and tags; values equal when
  both loggers are given the same numbers, rtol 1e-4 for a fit's losses and
  its eval PSNR (test_torch_trainer.py's loss tolerance);
- save and restore: bitwise;
- a launcher resume against ``Trainer.fit`` from the loaded state: bitwise
  (one device, one seed, the same operations); against the JAX trainer and
  launcher from the same state: rtol 1e-4 on the losses, and PSNR within
  0.05 dB and SSIM within 5e-3 (test_torch_pipeline.py's). Those fits take
  the whole volume as one batch, so the two frameworks' different shuffles
  give the same steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu import launcher as jlauncher
from mri_interpolation_tpu.infer import predict_batched as jax_predict_batched
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu.train import save_checkpoint as jax_save_checkpoint
from mri_interpolation_tpu.train.scalars import ScalarLogger as JaxScalarLogger
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import evaluate_grid, predict_batched
from mri_interpolation_tpu_torch.io import load_volume, nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import (ScalarLogger, TrainConfig, Trainer, latest_step, read_scalars,
                                               restore_checkpoint, save_checkpoint)

SHAPE = (16, 16, 8)  # 2,048 voxels
FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, n_layers=2)
NGP = dict(n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(4, 4, 2),
           finest_resolution=(16, 16, 8), growth="paper", decoder="relu_plain", dim_hidden=16, n_layers=2)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vol") / "synthetic_16x16x8.nii.gz")
    nifti.save(synthetic_volume(SHAPE, seed=7), path)
    return path


@pytest.fixture(scope="module")
def dataset(volume):
    return load_volume(volume)


def _pair(kw, seed=0):
    jm = jax_make_hash_mlp(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def test_scalar_records_match_the_jax_logger(tmp_path):
    rng = np.random.default_rng(0)
    records = [(e, e * 5, rng.random(5).astype(np.float32)) for e in range(3)]
    for mod, name in ((ScalarLogger, "port.jsonl"), (JaxScalarLogger, "jax.jsonl")):
        with mod(str(tmp_path / "sub" / name)) as logger:
            for e, first, losses in records:
                logger.log_epoch_losses(e, first, losses)
                logger.log((e + 1) * 5, "psnr", 30.5 + e, epoch=e)
    port, want = (tmp_path / "sub" / "port.jsonl").read_text(), (tmp_path / "sub" / "jax.jsonl").read_text()
    assert port == want
    assert len(read_scalars(str(tmp_path / "sub" / "port.jsonl"), "train_loss")) == 15
    assert read_scalars(str(tmp_path / "sub" / "port.jsonl"), "psnr")[-1] == {"step": 15, "tag": "psnr",
                                                                              "value": 32.5, "epoch": 2}


def test_predict_batched_matches_jax(dataset):
    jm, params, state, tm = _pair(NGP)
    coords = dataset.coords[::3]
    want = jax_predict_batched(jm, params, state, coords, chunk_size=300)
    got = predict_batched(tm, coords, chunk_size=300, device="cpu")  # several chunks and a padded tail
    assert got.shape == want.shape == (len(coords), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tm.training


def test_fit_streams_scalars_and_eval_like_jax(dataset, tmp_path):
    """Two epochs of 4 steps, eval every epoch: the same records, in order.
    On the relu_plain shape: the flagship's eval-mode output follows
    BatchNorm running means that track biases Adam moves by float noise,
    differently in each framework (test_torch_pipeline.py)."""
    jm, params, state, tm = _pair(NGP)
    ev = dataset.coords[::7], dataset.values[::7]

    def psnr(y):
        return {"psnr": 10.0 * np.log10(1.0 / float(np.mean((y - ev[1]) ** 2)))}

    cfg = dict(batch_size=512, epochs=2, lr=1e-2, seed=0, shuffle=False, eval_every_epochs=1, optimizer="adam_tcnn")
    JaxTrainer(JaxTrainConfig(**cfg, log_jsonl=str(tmp_path / "jax.jsonl"))).fit(
        jm, dataset.coords, dataset.values, params=params, state=state,
        eval_fn=lambda p, s: psnr(jax_predict_batched(jm, p, s, ev[0])))
    res = Trainer(TrainConfig(**cfg, log_jsonl=str(tmp_path / "port.jsonl"))).fit(
        tm, dataset.coords, dataset.values, device="cpu", eval_fn=lambda m: psnr(predict_batched(m, ev[0], device="cpu")))
    want, got = read_scalars(str(tmp_path / "jax.jsonl")), read_scalars(str(tmp_path / "port.jsonl"))
    assert [{k: v for k, v in r.items() if k != "value"} for r in got] == \
        [{k: v for k, v in r.items() if k != "value"} for r in want]
    assert [(r["tag"], r["step"]) for r in got] == ([("train_loss", s) for s in range(4)] + [("psnr", 4)]
                                                    + [("train_loss", s) for s in range(4, 8)] + [("psnr", 8)])
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want], rtol=1e-4)
    assert res.hook_time_s > 0 and len(res.epoch_times_s) == 2


def test_checkpoints_every_k_epochs_hold_that_epochs_state(dataset, tmp_path):
    """5 epochs of 4 steps, a checkpoint every 2: steps 8 and 16, each the
    model and optimizer after that epoch (bitwise a 4-epoch fit's)."""
    cfg = dict(batch_size=512, lr=5e-3, seed=0)
    kw = dict(FLAGSHIP, level_anneal_steps=10)
    model = make_hash_mlp(3, device="cpu", seed=1, **kw)
    ckpts = str(tmp_path / "ck")
    Trainer(TrainConfig(epochs=5, checkpoint_dir=ckpts, checkpoint_every_epochs=2, **cfg)).fit(
        model, dataset.coords, dataset.values, device="cpu")
    assert sorted(os.listdir(ckpts)) == ["step_16.pt", "step_8.pt"] and latest_step(ckpts) == 16
    four = make_hash_mlp(3, device="cpu", seed=1, **kw)
    Trainer(TrainConfig(epochs=4, **cfg)).fit(four, dataset.coords, dataset.values, device="cpu")
    saved = restore_checkpoint(ckpts)
    assert saved["step"] == 16 and saved["optimizer"]["updates"] == 16 and int(saved["model"]["anneal_step"]) == 16
    for key, value in four.state_dict().items():
        assert torch.equal(saved["model"][key], value), key
    assert restore_checkpoint(ckpts, step=8)["optimizer"]["updates"] == 8


def test_save_restore_round_trip_is_bitwise(dataset, tmp_path):
    model = make_hash_mlp(3, device="cpu", seed=2, **dict(FLAGSHIP, level_anneal_steps=5))
    trainer = Trainer(TrainConfig(batch_size=512, epochs=1, accumulate_grad_batches=3, checkpoint_dir=str(tmp_path),
                                  checkpoint_every_epochs=1))
    trainer.fit(model, dataset.coords, dataset.values, device="cpu")  # 4 mini-steps: one update, one in progress
    saved = restore_checkpoint(str(tmp_path), step=4)
    assert saved["optimizer"]["updates"] == 1 and saved["optimizer"]["mini_step"] == 1
    path = save_checkpoint(str(tmp_path / "again"), 4, saved["model"], saved["optimizer"])
    again = torch.load(path, weights_only=True)
    fresh = make_hash_mlp(3, device="cpu", seed=9, **dict(FLAGSHIP, level_anneal_steps=5))
    fresh.load_state_dict(again["model"])
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value) and fresh.state_dict()[key].dtype == value.dtype, key
    adam, adam2 = saved["optimizer"]["adam"], again["optimizer"]["adam"]
    assert adam["param_groups"] == adam2["param_groups"]
    for i, st in adam["state"].items():
        for name, t in st.items():
            assert torch.equal(adam2["state"][i][name], t), (i, name)
    for a, b in zip(saved["optimizer"]["acc"], again["optimizer"]["acc"]):
        assert torch.equal(a, b)
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"))


def _resume_config(volume, out, ckpt, **kw):
    """The flagship fit on the whole (16, 16, 8) volume as one batch, resumed
    from ``ckpt``."""
    return RunConfig(image_path=volume, output_root=str(out), checkpoint_path=ckpt, batch_size=SHAPE[0] * SHAPE[1] * SHAPE[2],
                     epochs=6, lr=5e-3, interp_shapes=(), save_checkpoint=False, **{**FLAGSHIP, **kw})


def test_launcher_resume_equals_fit_from_the_loaded_state_and_jax(volume, dataset, tmp_path):
    jm, params, state, tm = _pair(FLAGSHIP)
    ckpt = str(tmp_path / "init")
    save_checkpoint(ckpt, 0, tm.state_dict())
    summary = launcher.run(_resume_config(volume, tmp_path / "runs", ckpt), device="cpu")
    resumed = np.array([r["value"] for r in read_scalars(os.path.join(summary["run_dir"], "scalars.jsonl"))])
    loaded = make_hash_mlp(3, device="cpu", **FLAGSHIP)
    loaded.load_state_dict(restore_checkpoint(ckpt)["model"])
    cfg = dict(batch_size=len(dataset), epochs=6, lr=5e-3)
    direct = Trainer(TrainConfig(**cfg)).fit(loaded, dataset.coords, dataset.values, device="cpu")
    np.testing.assert_array_equal(resumed.astype(np.float32), direct.losses)
    assert summary["final_loss"] == float(direct.losses[-1])
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, dataset.coords, dataset.values, params=params, state=state)
    np.testing.assert_allclose(direct.losses, np.asarray(jres.losses), rtol=1e-4)
    # not a fresh init: the first loss is the loaded model's
    fresh = launcher.run(_resume_config(volume, tmp_path / "fresh", None), device="cpu")
    assert fresh["final_loss"] != summary["final_loss"]


def test_launcher_streams_eval_and_epoch_checkpoints(volume, tmp_path):
    cfg = RunConfig(image_path=volume, output_root=str(tmp_path), epochs=2, batch_size=512, interp_shapes=(),
                    eval_every_epochs=1, checkpoint_every_epochs=1, **NGP)
    summary = launcher.run(cfg, device="cpu")
    run_dir = summary["run_dir"]
    recs = read_scalars(os.path.join(run_dir, "scalars.jsonl"))
    assert [r["step"] for r in recs if r["tag"] == "train_loss"] == list(range(8))
    psnr = [r for r in recs if r["tag"] == "psnr"]
    assert [(r["step"], r["epoch"]) for r in psnr] == [(4, 0), (8, 1)] and all(np.isfinite(r["value"]) for r in psnr)
    ckpts = os.path.join(run_dir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["step_4.pt", "step_8.pt"]
    assert "optimizer" in restore_checkpoint(ckpts, 4)
    assert "optimizer" not in restore_checkpoint(ckpts, 8)  # the final checkpoint replaced the epoch's, as in JAX
    assert summary["train_hook_s"] > 0


@pytest.mark.parametrize("name, value", [("save_latents", True), ("tb_events", True)])
def test_launcher_unported_output_options_raise(volume, tmp_path, name, value):
    """Both output options are ported. ``tb_events`` exports the run's
    ``scalars.jsonl`` as a TensorBoard event file under ``tb/`` that reads
    back equal to the stream; ``save_latents`` writes the flagship's encoder
    features, ``latents.nii.gz`` of shape (16, 16, 8, 4), equal to
    ``evaluate_grid``'s latents of the saved model."""
    cfg = RunConfig(image_path=volume, output_root=str(tmp_path), epochs=1, batch_size=512, interp_shapes=(),
                    **FLAGSHIP)
    setattr(cfg, name, value)
    if name == "tb_events":
        from mri_interpolation_tpu_torch.train.tb_events import read_event_file

        run_dir = launcher.run(cfg, device="cpu")["run_dir"]
        (event_file,) = os.listdir(os.path.join(run_dir, "tb"))
        events = list(read_event_file(os.path.join(run_dir, "tb", event_file)))[1:]
        recs = read_scalars(os.path.join(run_dir, "scalars.jsonl"))
        assert len(recs) == 4 and [(e["step"], e["scalars"][0][0]) for e in events] == [
            (r["step"], r["tag"]) for r in recs]
        np.testing.assert_array_equal([e["scalars"][0][1] for e in events], np.float32([r["value"] for r in recs]))
        return
    run_dir = launcher.run(cfg, device="cpu")["run_dir"]
    latents = nifti.load(os.path.join(run_dir, "latents.nii.gz")).get_fdata(np.float32)
    model = make_hash_mlp(3, device="cpu", **FLAGSHIP)
    model.load_state_dict(restore_checkpoint(os.path.join(run_dir, "checkpoints"))["model"])
    _, want = evaluate_grid(model, SHAPE, device="cpu", return_latents=True)
    assert latents.shape == SHAPE + (4,)
    np.testing.assert_array_equal(latents, want)


def test_ngp_shape_in_both_launchers_from_one_init(volume, tmp_path):
    """The NGP paper+cosine HashMLP's shape (3 levels x F=8, paper growth,
    relu_plain, adam_tcnn, lr 1e-2, cosine) cut to (16, 16, 8), resumed by
    both launchers from the same parameters and fitted 30 one-batch epochs
    with the cosine over all of them."""
    jm, params, state, tm = _pair(NGP)
    jax_ckpt, port_ckpt = str(tmp_path / "jax_init"), str(tmp_path / "port_init")
    jax_save_checkpoint(jax_ckpt, 0, params, state)
    save_checkpoint(port_ckpt, 0, tm.state_dict())
    run = dict(image_path=volume, batch_size=SHAPE[0] * SHAPE[1] * SHAPE[2], epochs=30, lr=1e-2,
               optimizer="adam_tcnn", lr_schedule="cosine", cosine_t_max=30, interp_shapes=((16, 16, 16),),
               save_checkpoint=False, **NGP)
    want = jlauncher.run(jconfigs.RunConfig(**run, checkpoint_path=jax_ckpt, output_root=str(tmp_path / "jax")))
    got = launcher.run(RunConfig(**run, checkpoint_path=port_ckpt, output_root=str(tmp_path / "port")), device="cpu")
    assert got["steps"] == want["steps"] == 30
    assert abs(got["psnr"] - want["psnr"]) < 0.05 and abs(got["ssim"] - want["ssim"]) < 5e-3
    with open(os.path.join(got["run_dir"], "config.txt")) as f:
        text = f.read()
    assert "lr_schedule : cosine" in text and "growth : paper" in text
    jl = [r["value"] for r in read_scalars(os.path.join(want["run_dir"], "scalars.jsonl"), "train_loss")]
    pl = [r["value"] for r in read_scalars(os.path.join(got["run_dir"], "scalars.jsonl"), "train_loss")]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert json.load(open(os.path.join(got["run_dir"], "metrics.json")))["steps"] == 30
