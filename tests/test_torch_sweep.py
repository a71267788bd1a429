"""Port parity: the hyperparameter search (``train/sweep.py``) against the
JAX package.

Exact: ``sample_space`` equals JAX's draw for every form of the grammar
(log, lin, int, categorical, a categorical whose first item is a range
keyword), and a trial log written by one package resumes in the other,
re-running no logged trial. The CLI's two objectives run on a tiny volume
on the CPU (``--device cpu``).
"""

import json

import numpy as np
import pytest

from mri_interpolation_tpu.train import sweep as jsweep
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.ops import fused_mlp as fm
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import sweep

SPACES = {
    "log": {"lr": ["log", 1e-4, 1e-1]},
    "lin": {"sigma": ["lin", 1.0, 20.0]},
    "int": {"width": ["int", 8, 64]},
    "categorical": {"decoder": ["norm", "relu_plain"], "n": [1, 2, 4]},
    "keyword_categorical": {"mode": ["log", "lin", "int"], "pair": ["int", "a", "b"]},
    "mixed": {"lr": ["log", 1e-3, 3e-2], "n_levels": ["int", 3, 6], "n_features_per_level": [1, 2, 4],
              "residual_scale": ["lin", 0.0, 0.15]},
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_sample_space_equals_jax(name):
    for seed in (0, 7):
        for i in range(16):
            got, want = sweep.sample_space(SPACES[name], i, seed), jsweep.sample_space(SPACES[name], i, seed)
            assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_log_resumes_in_the_other_package(tmp_path, first):
    space = SPACES["mixed"]
    log = str(tmp_path / "sweep.jsonl")
    packages = {"jax": jsweep, "port": sweep}
    second = "port" if first == "jax" else "jax"
    ran = {"jax": [], "port": []}

    def trial_of(name):
        def trial(params):
            ran[name].append(params)
            if params["n_levels"] == 4:
                raise RuntimeError("diverged")
            return -abs(np.log10(params["lr"]) + 2.0)
        return trial

    packages[first].sweep(trial_of(first), space, n_trials=3, seed=5, log_path=log)
    result = packages[second].sweep(trial_of(second), space, n_trials=6, seed=5, log_path=log)
    assert len(ran[first]) == 3 and ran[second] == [sweep.sample_space(space, i, 5) for i in (3, 4, 5)]
    assert [t["trial"] for t in result.trials] == list(range(6))
    lines = [json.loads(line) for line in open(log)]
    assert [r["trial"] for r in lines] == list(range(6))
    assert all(r["params"] == sweep.sample_space(space, r["trial"], 5) for r in lines)
    done = [t for t in result.trials if t["score"] is not None]
    assert result.best == max(done, key=lambda t: t["score"])


def _volume(tmp_path):
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((12, 10, 5), seed=0), path)
    return path


def test_cli_recon_objective(tmp_path, capsys):
    path = _volume(tmp_path)
    log = str(tmp_path / "recon.jsonl")
    argv = ["--image_path", path, "--trials", "2", "--epochs", "1", "--batch_size", "200", "--log_path", log,
            "--space", '{"lr": ["log", 1e-3, 3e-2], "n_levels": ["int", 2, 3], "dim_hidden": [8, 16]}',
            "--device", "cpu"]
    result = sweep.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert out["n_trials"] == 2 and len(result.trials) == 2
    assert all(t["score"] is not None and np.isfinite(t["score"]) for t in result.trials)
    assert out["best"] == json.loads(json.dumps(result.best))
    # the rerun reads the log and runs nothing
    he.reset_launches()
    again = sweep.main(argv)
    assert again.trials == result.trials


def test_cli_odd_frames_objective(tmp_path, capsys):
    path = _volume(tmp_path)
    log = str(tmp_path / "odd.jsonl")
    result = sweep.main(["--image_path", path, "--model_class", "warp_inr", "--objective", "odd_frames",
                         "--ens_seeds", "2", "--trials", "2", "--epochs", "1", "--batch_size", "100",
                         "--log_path", log, "--space", '{"lr": ["log", 3e-3, 3e-2], "warp_accel": ["lin", 0.0, 1.0]}',
                         "--device", "cpu"])
    assert len(result.trials) == 2 and all(np.isfinite(t["score"]) for t in result.trials)
    single = sweep.main(["--image_path", path, "--objective", "odd_frames", "--trials", "1", "--epochs", "1",
                         "--batch_size", "100", "--log_path", str(tmp_path / "single.jsonl"), "--space",
                         '{"n_levels": ["int", 2, 3]}', "--device", "cpu"])
    assert np.isfinite(single.trials[0]["score"])
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}
