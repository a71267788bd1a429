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
from mri_interpolation_tpu_torch.infer import evaluate_grid, predict_batched
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


def _package_files(root: Path):
    """The package's modules: the .py files whose every directory up to
    ``root`` holds an ``__init__.py``. The build directory (``ops/_build``,
    gitignored, no ``__init__.py``) is left out, so a working tree and a
    clean checkout of one commit collect the same cases."""
    return sorted(p for p in root.rglob("*.py")
                  if all((d / "__init__.py").exists() for d in p.parents if d == root or root in d.parents))


PORT_FILES = _package_files(PORT_DIR) + [REPO / "chip_smoke.py"]
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


def test_package_files_leave_out_the_build_directory(tmp_path):
    """A stray module in a gitignored directory without ``__init__.py``
    (the build directory) adds no case to ``test_no_jax_import``."""
    root = tmp_path / "pkg"
    for d in (root, root / "ops"):
        d.mkdir(parents=True, exist_ok=True)
        (d / "__init__.py").write_text("")
    (root / "ops" / "k.py").write_text("")
    (root / "ops" / "_build").mkdir()
    (root / "ops" / "_build" / "stray.py").write_text("import jax\n")
    assert [p.relative_to(root).as_posix() for p in _package_files(root)] == [
        "__init__.py", "ops/__init__.py", "ops/k.py"]


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


def test_forward_kernel_paths_raise_instead_of_falling_back(monkeypatch):
    """The two forwards' kernel sides (kernel 1; kernel 5 on a relu stack
    and a sine stack, both routes) build their library or raise: with
    nothing built and no nvcc they never take the plain version."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    enc = HashGridEncoding(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                           finest_resolution=None, per_level_scale=1.4)
    he.reset_launches()
    fm.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        he._launch("hash_encode_forward", torch.zeros((5, 2)), enc.init(), torch.empty((5, 20)), enc)
    ws, bs, x = [torch.zeros((20, 64)), torch.zeros((64, 1))], [torch.zeros(64), torch.zeros(1)], torch.zeros((5, 20))
    for acts in (fm.mlp_acts(1, "relu"), fm.siren_acts(1, 30.0, 30.0)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fm._forward_kernel(ws, bs, x, acts)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


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


def test_slice_seven_entry_points_raise_without_a_card(no_card, tmp_path):
    """The trainer's options, the HashMLP's, predict_batched and the
    launcher's resume run on the card or raise; with the CPU asked for they
    run there and launch nothing."""
    kw = dict(TINY, decoder="relu_plain", n_features_per_level=8, n_levels=3, growth="paper",
              level_anneal_steps=3, temporal_tv=1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hash_mlp(3, **kw)
    model = make_hash_mlp(3, device="cpu", **kw)
    coords = np.random.default_rng(0).random((64, 3), dtype=np.float32)
    values = coords[:, :1].copy()
    cfg = TrainConfig(batch_size=16, epochs=2, lr_schedule="cosine", accumulate_grad_batches=2, remat=True,
                      log_jsonl=str(tmp_path / "s.jsonl"), checkpoint_dir=str(tmp_path / "ck"),
                      checkpoint_every_epochs=1)
    freeze = lambda named: {k: k.startswith("encoder.") for k in named}  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, freeze_mask_fn=freeze).fit(model, coords, values)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_batched(model, coords)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--image_path", str(tmp_path / "absent.nii.gz"), "--output_root", str(tmp_path / "runs"),
                       "--checkpoint_path", str(tmp_path / "ck"), "--remat", "true", "--eval_every_epochs", "1",
                       "--lr_schedule", "cosine", "--accumulate_grad_batches", "2"])
    assert list(tmp_path.iterdir()) == []
    multi = make_multi_hash_mlp(n_levels=2, log2_hashmap_size=8, dim_hidden=8, device="cpu", **MULTI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, freeze_mask_fn=lambda named: {k: True for k in named}).fit_frames(
            multi, coords[:16, :2], np.zeros((2, 16, 1), dtype=np.float32))
    with pytest.raises(ValueError, match="CUDA device"):
        pr.launch_empty(torch.device("cpu"))
    # the CPU, when asked for, works, and launches nothing
    he.reset_launches()
    fm.reset_launches()
    res = Trainer(cfg, freeze_mask_fn=freeze).fit(model, coords, values, device="cpu")
    assert res.steps == 8 and int(model.anneal_step) == 8 and sorted(os.listdir(tmp_path / "ck")) == [
        "step_4.pt", "step_8.pt"]
    assert predict_batched(model, coords, device="cpu").shape == (64, 1)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_slice_eight_entry_points_raise_without_a_card(no_card, tmp_path):
    """The held-out-frame launcher, the SIREN family, the grid path's options
    and the protocols run on the card or raise; with the CPU asked for they
    run there and launch nothing."""
    from mri_interpolation_tpu_torch.infer import device_eval_seconds
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.models import make_hash_siren, make_modulated_siren, make_psf_siren
    from mri_interpolation_tpu_torch.train import protocols

    siren_kw = dict(dim_hidden=8, n_layers=2)
    hash_kw = dict(n_levels=2, log2_hashmap_size=8, base_resolution=4, per_level_scale=1.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hash_siren(3, **siren_kw, **hash_kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_modulated_siren(3, **siren_kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_psf_siren(3, coordinates_spacing=(0.1, 0.1, 0.1), **siren_kw)
    model = make_hash_mlp(3, device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_grid(model, (4, 4, 4), transport="u16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_grid(model, (4, 4, 4), return_latents=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_eval_seconds(model, (4, 4, 4))
    image = synthetic_volume((4, 4, 4), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocols.even_frame_fit_eval(model, image, TrainConfig(batch_size=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run(RunConfig(image_path=str(tmp_path / "absent.nii.gz"), output_root=str(tmp_path),
                               even_frames_only=True, undersample_pct=50.0, save_latents=True))
    assert list(tmp_path.iterdir()) == []
    # the CPU, when asked for, works, and launches nothing
    he.reset_launches()
    fm.reset_launches()
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((8, 8, 4), seed=0), path)
    cfg = RunConfig(image_path=path, output_root=str(tmp_path / "runs"), even_frames_only=True, undersample_pct=50.0,
                    save_latents=True, epochs=1, batch_size=16, interp_shapes=(), save_checkpoint=False,
                    decoder="relu_plain", **TINY)
    assert np.isfinite(launcher.run(cfg, device="cpu")["odd_psnr"])
    siren = make_hash_siren(3, device="cpu", **siren_kw, **hash_kw)
    assert evaluate_grid(siren, (4, 4, 4), lo=-1.0, device="cpu", transport="u16").shape == (4, 4, 4)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_slice_nine_entry_points_raise_without_a_card(no_card, tmp_path):
    """The rest of the zoo, the warp INR, the classical baselines and the
    warp ensemble run on the card or raise; with the CPU asked for they run
    there and launch nothing."""
    from mri_interpolation_tpu_torch.infer import classical
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.models import (make_freq_mlp, make_gabor_net, make_mlp, make_rff_net,
                                                    make_warp_inr)
    from mri_interpolation_tpu_torch.train import protocols

    warp_kw = dict(n_levels=2, n_features_per_level=2, base_resolution=(2, 2), finest_resolution=(4, 4),
                   dim_hidden=4, warp_hidden=4)
    for make, kw in ((make_mlp, {}), (make_rff_net, {}), (make_gabor_net, {}), (make_freq_mlp, {}),
                     (make_warp_inr, warp_kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(3, **kw)
    image = synthetic_volume((4, 4, 4), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classical.linear_interpolate_volume(image, (4, 4, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocols.ensembled_warp_fit_eval(lambda seed: make_warp_inr(3, device="cpu", seed=seed, **warp_kw), image,
                                          TrainConfig(batch_size=16), seeds=(1,))
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(image, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classical.main([path, "--out", str(tmp_path / "out.nii.gz")])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vol.nii.gz"]
    # the CPU, when asked for, works, and launches nothing
    he.reset_launches()
    fm.reset_launches()
    got = protocols.ensembled_warp_fit_eval(lambda seed: make_warp_inr(3, device="cpu", seed=seed, **warp_kw), image,
                                            TrainConfig(batch_size=16), seeds=(1,), linear_blend=0.5, device="cpu")
    assert len(got["per_seed_odd_psnr"]) == 1 and np.isfinite(got["odd"]["psnr"])
    assert classical.main([path, "--out", str(tmp_path / "out.nii.gz"), "--device", "cpu"]).shape == (4, 4, 4)
    assert set(he.LAUNCHES.values()) == {0} and set(fm.LAUNCHES.values()) == {0}


def test_slice_ten_entry_points_raise_without_a_card(no_card, tmp_path):
    """The registrations, the registration protocol, the classical CLI's
    registration methods and the stacked fusion run on the card or raise;
    with the CPU asked for they run there."""
    from mri_interpolation_tpu_torch.infer import classical, registration
    from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
    from mri_interpolation_tpu_torch.train import protocols, stacking

    image = synthetic_volume((6, 6, 5), seed=0)
    small = dict(ctrl_sizes=(2,), pyramid=(1,), steps=2)
    for call in (lambda: registration.register_pair(image[..., 0], image[..., 1]),
                 lambda: registration.register_group_temporal(image),
                 lambda: registration.motion_transfer_at(image, [0, 1, 2, 3, 4], [0.5], lambda x: x[:, :2] * 0),
                 lambda: protocols.registration_interp_eval(image),
                 lambda: stacking.default_interp_families(TrainConfig(), image.shape),
                 lambda: stacking.stacked_interp_eval(image, TrainConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(image, path)
    for argv in ([path, "--out", str(tmp_path / "o.nii.gz"), "--method", "registration"],
                 [path, "--out", str(tmp_path / "o.nii.gz"), "--method", "registration_group"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            classical.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stacking._main([path, "--out", str(tmp_path / "sr.nii.gz"), "--families", "linear"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vol.nii.gz"]
    recon, q = protocols.registration_interp_eval(image, device="cpu", **small)
    assert recon.shape == image.shape and np.isfinite(q["odd"]["psnr"])
    ctrl = registration.register_pair(image[..., 0], image[..., 1], device="cpu", **small)
    assert ctrl.device.type == "cpu"


def test_slice_eleven_entry_points_raise_without_a_card(no_card, tmp_path):
    """The streamed fit, the launcher's streaming branch, the sweep's CLI
    and ``apply_psf`` run on the card or raise; the planners and writers
    (``plan``, ``--plan``, the YAML reader, the event file, the figures, the
    PNG and GIF writers, MNIST) touch no device and run without one."""
    from mri_interpolation_tpu_torch import figures, plan
    from mri_interpolation_tpu_torch.io import mnist, nifti, png, synthetic_volume
    from mri_interpolation_tpu_torch.train import sweep, tb_events
    from mri_interpolation_tpu_torch.utils import apply_psf, psf_kernel

    model = make_hash_mlp(3, device="cpu", **TINY)
    volume = synthetic_volume((4, 4, 4), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(batch_size=16)).fit_streaming(model, volume, shard_voxels=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apply_psf(np.zeros((16, 1), np.float32), psf_kernel(2, 3), (4, 4))
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(volume, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run(RunConfig(image_path=path, output_root=str(tmp_path / "runs"), stream_shard_voxels=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--image_path", path, "--trials", "1", "--log_path", str(tmp_path / "s.jsonl")])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vol.nii.gz"]
    # without a device
    assert launcher.main(["--image_path", path, "--plan"])["bytes"]["dataset"] == 64 * 4 * 4
    assert plan.plan_run(dim_in=3)["bytes"]["table"] > 0
    assert mnist.mnist_digit_dataset()[0].shape == (784, 2)
    png.write_gif(str(tmp_path / "a.gif"), [np.zeros((2, 2), np.uint8)])
    # the CPU, when asked for, works, and launches nothing
    he.reset_launches()
    fm.reset_launches()
    res = Trainer(TrainConfig(batch_size=16, epochs=1)).fit_streaming(model, volume, shard_voxels=32, device="cpu")
    assert res.steps == 4
    summary = launcher.run(RunConfig(image_path=path, output_root=str(tmp_path / "runs"), stream_shard_voxels=32,
                                     batch_size=16, interp_shapes=(), tb_events=True, **TINY), device="cpu")
    assert summary["steps"] == 4
    assert set(figures.make_figures(summary["run_dir"])) == {"grid", "gif", "convergence"}
    jsonl = os.path.join(summary["run_dir"], "scalars.jsonl")
    assert len(list(tb_events.read_event_file(tb_events.export_scalars_jsonl(jsonl, str(tmp_path / "tb"))))) == 5
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
