"""The port stands alone: ``mri_interpolation_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor the JAX package, importing the port loads no JAX,
its kernels are built without PyTorch's extension machinery, and its entry
points run on the card unless the CPU is asked for."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mri_interpolation_tpu_torch as port
from mri_interpolation_tpu_torch import device as port_device
from mri_interpolation_tpu_torch import bench_kernels, launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_multi_hash_mlp, make_multi_siren, make_siren
from mri_interpolation_tpu_torch.ops import build
from mri_interpolation_tpu_torch.ops import fused_mlp as fm
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.ops import probe as pr
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "mri_interpolation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "mri_interpolation_tpu")
PORT_FILES = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
TINY = dict(base_resolution=(2, 2, 2), finest_resolution=(4, 4, 4), dim_hidden=4)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(REPO)} imports {module}"


def test_import_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(port.__path__, "mri_interpolation_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for name in {names!r}: importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mri_interpolation_tpu'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert len(names) >= 20


def test_no_pytorch_extension_builder():
    for path in PORT_FILES:
        text = path.read_text()
        assert "cpp_extension" not in text and "torch.compile" not in text, path
    for src in (PORT_DIR / "ops" / "csrc").glob("*.cu"):
        assert "#include <torch" not in src.read_text() and "#include <ATen" not in src.read_text()


def test_build_directory_is_ignored():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert "mri_interpolation_tpu_torch/ops/_build/" in lines and "chiprun_out/" in lines


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        port_device.resolve_device("meta")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hash_mlp(3, **TINY)
    model = make_hash_mlp(3, device="cpu", **TINY)
    coords = np.random.default_rng(0).random((64, 3), dtype=np.float32)
    values = coords[:, :1].copy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(batch_size=16)).fit(model, coords, values)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_grid(model, (4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_reconstruction(np.zeros((8, 8)), np.zeros((8, 8)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run(RunConfig(image_path=str(tmp_path / "absent.nii.gz"), output_root=str(tmp_path)))
    assert list(tmp_path.iterdir()) == []  # nothing was written before the refusal
    # the CPU, when asked for, works
    Trainer(TrainConfig(batch_size=16)).fit(model, coords, values, device="cpu")
    assert evaluate_grid(model, (4, 4, 4), device="cpu").shape == (4, 4, 4)


def test_slice_two_entry_points_raise_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_siren(3, dim_hidden=8, n_layers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hash_mlp(3, decoder="relu_plain", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.check_build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--config_preset", "siren", "--image_path", str(tmp_path / "absent.nii.gz"),
                       "--output_root", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
    # the CPU, when asked for, works, and launches nothing
    fm.reset_launches()
    pr.reset_launches()
    model = make_siren(3, dim_hidden=8, n_layers=2, device="cpu")
    assert evaluate_grid(model, (4, 4, 4), lo=-1.0, device="cpu").shape == (4, 4, 4)
    pr.check_build("cpu")
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 0} and pr.LAUNCHES == {"probe": 0}


def test_kernel_paths_raise_instead_of_falling_back(monkeypatch):
    """The kernel side of each new wrapper builds its library or raises: with
    nothing built and no nvcc, it never falls back to the plain version."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    ws = [torch.zeros((3, 8)), torch.zeros((8, 1))]
    bs = [torch.zeros(8), torch.zeros(1)]
    x, g = torch.zeros((5, 3)), torch.zeros((5, 1))
    acts = fm.siren_acts(1, 30.0, 30.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fm._forward_kernel(ws, bs, x, acts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fm._backward_kernel(ws, bs, x, g, acts, True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pr._library()
    enc = bench_kernels.bench_geometry()
    levels = he.coarse_onehot_levels(enc)
    x, table, g = torch.zeros((5, 3)), enc.init(), torch.zeros((5, 2 * len(levels)))
    for name, b, out in (("hash_encode_coarse_forward", table, torch.empty((5, 4))),
                         ("hash_encode_coarse_table_grad", g, torch.zeros(table.shape))):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            he._launch(name, x, b, out, enc, he.coarse_constants(enc, levels))
    assert set(he.LAUNCHES.values()) == {0}


def test_table_grad_kernel_path_raises_instead_of_falling_back(monkeypatch):
    """The table gradient's kernel side, plan and all, builds its library or
    raises: with nothing built and no nvcc it never takes the plain version."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    enc = HashGridEncoding(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                           finest_resolution=None, per_level_scale=1.4)
    words = he.plan_words(enc, he.table_grad_plan(enc, 123_904))
    he.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        he._launch("hash_encode_table_grad", torch.zeros((5, 2)), torch.zeros((5, 20)),
                   torch.zeros((enc.total_size, 2)), enc, words=words)
    assert set(he.LAUNCHES.values()) == {0}


MULTI = dict(dim_in=2, n_frames=2)


def test_slice_three_entry_points_raise_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multi_siren(dim_hidden=8, n_layers=2, **MULTI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multi_hash_mlp(n_levels=2, log2_hashmap_size=8, dim_hidden=8, **MULTI)
    model = make_multi_hash_mlp(n_levels=2, log2_hashmap_size=8, dim_hidden=8, device="cpu", **MULTI)
    coords = np.random.default_rng(0).random((16, 2), dtype=np.float32)
    values = np.zeros((2, 16, 1), dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig()).fit_frames(model, coords, values)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_grid(model, (4, 4), frame_idx=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.run()
    out = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.main(["--out", str(out)])
    assert not out.exists()
    # the CPU, when asked for, works, and launches nothing
    he.reset_launches()
    fm.reset_launches()
    Trainer(TrainConfig(epochs=1)).fit_frames(model, coords, values, device="cpu")
    assert evaluate_grid(model, (4, 4), frame_idx=1, device="cpu").shape == (4, 4)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_evaluate_grid_refuses_a_model_on_another_device():
    model = make_hash_mlp(3, device="cpu", **TINY)
    with pytest.raises(ValueError, match="model is on"):
        evaluate_grid(model.to("meta"), (4, 4, 4), device="cpu")


def _run_chip_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine holds
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    done = _run_chip_smoke(REPO)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    done = _run_chip_smoke(tmp_path)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout
