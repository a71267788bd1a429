"""Port parity: the figures (``figures.py``), the PNG and GIF writers
(``io/png.py``) and the launcher's ``pred.png``, against PIL (the tests'
decoder), matplotlib's viridis and the JAX package's imageio GIF.

Exact throughout: a written PNG or GIF decodes to the arrays written; the
frames of the port's ``frames.gif`` equal those of JAX's for the same run
directory; ``VIRIDIS`` equals matplotlib's table; ``pred.png`` decodes to
``colorize(recon.T)`` of the saved reconstruction.
"""

import json
import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

from mri_interpolation_tpu import figures as jfigures
from mri_interpolation_tpu_torch import configs, figures, launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.io import nifti, png, synthetic_volume
from mri_interpolation_tpu_torch.train.scalars import ScalarLogger


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    while True:
        frames.append(np.array(im.convert("L")))
        try:
            im.seek(im.tell() + 1)
        except EOFError:
            return frames


def test_viridis_equals_matplotlib():
    np.testing.assert_array_equal(png.VIRIDIS, matplotlib.colormaps["viridis"](np.arange(256), bytes=True)[:, :3])


def test_colorize_indexes_as_matplotlib():
    a = np.random.default_rng(0).random((13, 17)) * 5 - 2
    a[0, 0], a[0, 1] = a.min() - 1, a.max() + 1  # the ends
    cmap = matplotlib.colormaps["viridis"]
    norm = matplotlib.colors.Normalize(vmin=a.min(), vmax=a.max())
    np.testing.assert_array_equal(png.colorize(a), cmap(norm(a), bytes=True)[..., :3])


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 3), (20, 30, 3)])
def test_png_decodes_to_the_array(tmp_path, shape):
    a = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = png.write_png(str(tmp_path / "a.png"), a, {"Title": "t=3 lr=0.01", "Panel 0": "ch 0 (row 0, column 0)"})
    im = Image.open(path)
    np.testing.assert_array_equal(np.array(im), a)
    assert im.text == {"Title": "t=3 lr=0.01", "Panel 0": "ch 0 (row 0, column 0)"}


@pytest.mark.parametrize("kind", ["random", "flat", "ramp", "long"])
def test_gif_decodes_to_the_frames(tmp_path, kind):
    """Frames that fill the LZW table and reset it (random, long), that
    never grow it (flat) and that grow it slowly (ramp)."""
    rng = np.random.default_rng(2)
    if kind == "random":
        frames = [rng.integers(0, 256, (45, 61), dtype=np.uint8) for _ in range(3)]
    elif kind == "flat":
        frames = [np.full((30, 40), v, np.uint8) for v in (0, 255)]
    elif kind == "ramp":
        frames = [(np.arange(50 * 70) % 256).astype(np.uint8).reshape(50, 70)]
    else:
        frames = [rng.integers(0, 5, (120, 200), dtype=np.uint8), rng.integers(0, 256, (120, 200), dtype=np.uint8)]
    path = png.write_gif(str(tmp_path / "a.gif"), frames, duration_ms=200)
    got = _gif_frames(path)
    assert len(got) == len(frames)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    assert Image.open(path).info["duration"] == 200


def _run_dir(tmp_path, ndim=3):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    shape = (16, 12, 7) if ndim == 3 else (16, 12, 4, 7)
    nifti.save(synthetic_volume(shape, seed=3), str(run_dir / "pred.nii.gz"))
    nifti.save(np.random.default_rng(4).random(shape + (5,)).astype(np.float32), str(run_dir / "latents.nii.gz"))
    configs.export_to_txt(RunConfig(model_class="hash_mlp", lr=0.01, epochs=3), str(run_dir) + os.sep)
    with ScalarLogger(str(run_dir / "scalars.jsonl")) as log:
        log.log_epoch_losses(0, 0, np.geomspace(1.0, 1e-3, 30).astype(np.float32))
        log.log(30, "psnr", 21.5, epoch=0)
        log.log(60, "psnr", 27.0, epoch=1)
    return str(run_dir)


@pytest.mark.parametrize("ndim", [3, 4])
def test_frames_gif_equals_jax(tmp_path, ndim):
    run_dir = _run_dir(tmp_path, ndim)
    want = _gif_frames(jfigures.make_figures(run_dir)["gif"])
    out = figures.make_figures(run_dir, keep_frame_pngs=True)
    got = _gif_frames(out["gif"])
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for path, frame in zip(out["frames"], got):
        np.testing.assert_array_equal(np.array(Image.open(path)), frame)


def test_grid_latents_and_convergence(tmp_path):
    run_dir = _run_dir(tmp_path)
    out = figures.make_figures(run_dir)
    assert set(out) == {"grid", "gif", "latents", "convergence"}
    data = nifti.load(os.path.join(run_dir, "pred.nii.gz")).get_fdata(np.float32)
    grid = Image.open(out["grid"])
    assert grid.text["Title"] == "hash_mlp lr=0.01 epochs=3" and grid.text["Panel 4"] == "t=4 (row 1, column 1)"
    g = np.array(grid)
    assert g.shape == (3 * 12 + 4 * 4, 3 * 16 + 4 * 4)  # 3 rows x ceil(7 / 3) columns of (y, x) tiles
    # tile t=4 at row 1, column 1: frame 4 transposed, row 0 at the bottom, min-max over itself
    np.testing.assert_array_equal(g[4 + 16:4 + 16 + 12, 4 + 20:4 + 20 + 16], png.to_gray(data[..., 4].T[::-1]))
    lat = Image.open(out["latents"])
    assert np.array(lat).shape == (12 + 8, 5 * 16 + 6 * 4, 3) and lat.text["Panel 2"] == "ch 2 (row 0, column 2)"
    conv = Image.open(out["convergence"])
    c = np.array(conv)
    assert c.shape == (420, 720, 3) and conv.text["x axis"] == "step 0 .. 60"
    assert (c == [31, 119, 180]).all(-1).sum() > 100 and (c == [255, 127, 14]).all(-1).sum() > 20
    assert conv.text["second y axis"] == "PSNR dB (orange) 21.5 .. 27"


def test_figures_cli(tmp_path, capsys):
    run_dir = _run_dir(tmp_path)
    out = figures.main([run_dir, "--fps", "4"])
    printed = capsys.readouterr().out
    assert all(f"{k}: {v}" in printed for k, v in out.items())
    assert Image.open(out["gif"]).info["duration"] == 250


def test_pred_png_is_the_stated_image(tmp_path):
    path = str(tmp_path / "frame.nii.gz")
    nifti.save(synthetic_volume((20, 14), seed=5), path)
    cfg = RunConfig(image_path=path, output_root=str(tmp_path / "runs"), epochs=1, batch_size=70, dim_hidden=8,
                    base_resolution=(2, 2), finest_resolution=(20, 14), interp_shapes=(), save_checkpoint=False)
    run_dir = launcher.run(cfg, device="cpu")["run_dir"]
    recon = nifti.load(os.path.join(run_dir, "pred.nii.gz")).get_fdata(np.float32)
    img = np.array(Image.open(os.path.join(run_dir, "pred.png")))
    assert img.shape == (14, 20, 3)
    np.testing.assert_array_equal(img, png.colorize(recon.T))
    assert json.load(open(os.path.join(run_dir, "metrics.json")))["steps"] == 4
