"""Post-hoc figures of a finished run directory (port of
``mri_interpolation_tpu/figures.py``): the frame grid, the frame PNGs and
GIF, the encoder-latents panel and the convergence curve.

The JAX package draws them with matplotlib and writes the GIF with
imageio; the port writes the pixels itself through ``io/png.py``:

- ``frames_grid.png``: the prediction's frames (4-D: the mid-z slice) as
  gray tiles, each min-max over itself (as each ``imshow`` scales its own
  axes) with ``origin="lower"`` (row 0 at the bottom), in the JAX
  package's grid of 3 rows and ``ceil(T / 3)`` columns, 4-pixel white
  gutters. The title (model, lr, epochs from ``config.txt``) and each
  tile's label (``t=i``) go into ``tEXt`` chunks;
- ``frames.gif`` (and with ``keep_frame_pngs`` ``frame_{i:03d}.png``): the
  frames ``(x.T - lo) / (hi - lo + 1e-12) * 255`` as uint8 over the whole
  prediction's range, the arrays the JAX package hands imageio;
- ``latents_grid.png`` (when ``latents.nii.gz`` exists): each channel of
  the mid-frame latents as a viridis tile, ``min(C, 8)`` columns, labels
  ``ch i`` in ``tEXt``;
- ``convergence.png`` (when ``scalars.jsonl`` has ``train_loss``): a
  720 x 420 white image with ``log10(train_loss)`` against the step as a
  blue polyline and, where there are ``psnr`` records, the PSNR on its own
  vertical scale as an orange polyline with a 5-pixel mark at each record;
  the axes' ranges are in ``tEXt`` (no axes are drawn).

Usage:
    python -m mri_interpolation_tpu_torch.figures runs/version_0 [--fps 5] [--keep_frame_pngs]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from .configs import parse_config_txt
from .io import nifti, png

__all__ = ["make_figures", "main"]

_GUTTER = 4
_BLUE = np.array([31, 119, 180], np.uint8)  # matplotlib's tab:blue
_ORANGE = np.array([255, 127, 14], np.uint8)  # tab:orange


def _grid(tiles, ncols: int, nrows: int, rgb: bool) -> np.ndarray:
    """Tiles of one shape in a white-guttered grid, row-major."""
    h, w = tiles[0].shape[:2]
    shape = (nrows * h + (nrows + 1) * _GUTTER, ncols * w + (ncols + 1) * _GUTTER) + ((3,) if rgb else ())
    out = np.full(shape, 255, np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, ncols)
        y, x = _GUTTER + r * (h + _GUTTER), _GUTTER + c * (w + _GUTTER)
        out[y:y + h, x:x + w] = tile
    return out


def _panel_text(title: str, labels, ncols: int) -> dict:
    text = {"Title": title} if title else {}
    for i, label in enumerate(labels):
        r, c = divmod(i, ncols)
        text[f"Panel {i}"] = f"{label} (row {r}, column {c})"
    return text


def _polyline(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color: np.ndarray) -> None:
    """Draw the polyline through pixel points (xs, ys) into ``img``: each
    segment sampled at one point a pixel of its longer extent."""
    h, w = img.shape[:2]
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        px = np.rint(np.linspace(x0, x1, n + 1)).astype(int)
        py = np.rint(np.linspace(y0, y1, n + 1)).astype(int)
        keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        img[py[keep], px[keep]] = color
    if len(xs) == 1:
        img[int(np.rint(ys[0])), int(np.rint(xs[0]))] = color


def _scale(v: np.ndarray, lo: float, hi: float, a: float, b: float) -> np.ndarray:
    return a + (v - lo) / (hi - lo) * (b - a) if hi > lo else np.full(v.shape, (a + b) / 2)


def _convergence(losses, psnrs, path: str) -> str:
    h, w, margin = 420, 720, 30
    img = np.full((h, w, 3), 255, np.uint8)
    steps = np.array([r["step"] for r in losses], np.float64)
    logl = np.log10(np.maximum(np.array([r["value"] for r in losses], np.float64), 1e-30))
    x_lo, x_hi = float(steps.min()), float(steps.max())
    if psnrs:
        x_lo = min(x_lo, min(r["step"] for r in psnrs))
        x_hi = max(x_hi, max(r["step"] for r in psnrs))
    y_lo, y_hi = float(logl.min()), float(logl.max())
    px = lambda s: _scale(np.asarray(s, np.float64), x_lo, x_hi, margin, w - 1 - margin)  # noqa: E731
    _polyline(img, px(steps), _scale(logl, y_lo, y_hi, h - 1 - margin, margin), _BLUE)
    text = {"Title": "convergence", "x axis": f"step {x_lo:g} .. {x_hi:g}",
            "y axis": f"train_loss (log10, blue) {10 ** y_lo:.6g} .. {10 ** y_hi:.6g}"}
    if psnrs:
        ps = np.array([r["value"] for r in psnrs], np.float64)
        p_lo, p_hi = float(ps.min()), float(ps.max())
        xs, ys = px([r["step"] for r in psnrs]), _scale(ps, p_lo, p_hi, h - 1 - margin, margin)
        _polyline(img, xs, ys, _ORANGE)
        for x, y in zip(np.rint(xs).astype(int), np.rint(ys).astype(int)):
            img[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = _ORANGE
        text["second y axis"] = f"PSNR dB (orange) {p_lo:.6g} .. {p_hi:.6g}"
    return png.write_png(path, img, text)


def make_figures(run_dir: str, pred_name: str = "pred.nii.gz", fps: int = 5,
                 keep_frame_pngs: bool = False) -> dict:
    """Write the figures of a finished run directory; returns their paths
    (``grid``, ``gif``, ``frames``, ``latents``, ``convergence``)."""
    data = np.asarray(nifti.load(os.path.join(run_dir, pred_name)).get_fdata(np.float32))
    if data.ndim == 4:
        data = data[:, :, data.shape[2] // 2, :]  # mid-z
    if data.ndim != 3:
        raise ValueError(f"expected a (x, y, t) or 4D prediction, got shape {data.shape}")

    config_txt = os.path.join(run_dir, "config.txt")
    title = ""
    if os.path.exists(config_txt):
        cfg = parse_config_txt(config_txt)
        title = f"{cfg.get('model_class', '?')} lr={cfg.get('lr', '?')} epochs={cfg.get('epochs', '?')}"

    out = {}
    n_frames = data.shape[-1]
    ncols = -(-n_frames // 3)
    tiles = [png.to_gray(data[..., i].T[::-1]) for i in range(n_frames)]
    grid = _grid(tiles, ncols, 3, rgb=False)
    out["grid"] = png.write_png(os.path.join(run_dir, "frames_grid.png"), grid,
                                _panel_text(title, [f"t={i}" for i in range(n_frames)], ncols))

    lo, hi = float(data.min()), float(data.max())
    frames = [png.to_gray(data[..., i].T, lo, hi) for i in range(n_frames)]
    if keep_frame_pngs:
        out["frames"] = [png.write_png(os.path.join(run_dir, f"frame_{i:03d}.png"), f) for i, f in enumerate(frames)]
    out["gif"] = png.write_gif(os.path.join(run_dir, "frames.gif"), frames, duration_ms=int(1000 / fps))

    latents_path = os.path.join(run_dir, "latents.nii.gz")
    if os.path.exists(latents_path):
        lat = np.asarray(nifti.load(latents_path).get_fdata(np.float32))
        while lat.ndim > 3:  # (x, y, [z,] t, D) -> the mid slices down to (x, y, D)
            lat = lat[..., lat.shape[-2] // 2, :]
        n_ch = lat.shape[-1]
        lcols = min(n_ch, 8)
        tiles = [png.colorize(lat[..., i].T[::-1]) for i in range(n_ch)]
        out["latents"] = png.write_png(
            os.path.join(run_dir, "latents_grid.png"), _grid(tiles, lcols, -(-n_ch // lcols), rgb=True),
            _panel_text("encoder latents (mid frame)", [f"ch {i}" for i in range(n_ch)], lcols))

    scalars_path = os.path.join(run_dir, "scalars.jsonl")
    if os.path.exists(scalars_path):
        from .train.scalars import read_scalars

        losses = read_scalars(scalars_path, tag="train_loss")
        if losses:
            out["convergence"] = _convergence(losses, read_scalars(scalars_path, tag="psnr"),
                                              os.path.join(run_dir, "convergence.png"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """``python -m mri_interpolation_tpu_torch.figures <run_dir>``: prints
    each artifact's path and returns them. Touches no device."""
    p = argparse.ArgumentParser(description="frame-grid PNG + GIF from a finished run dir")
    p.add_argument("run_dir")
    p.add_argument("--pred_name", default="pred.nii.gz")
    p.add_argument("--fps", type=int, default=5)
    p.add_argument("--keep_frame_pngs", action="store_true")
    args = p.parse_args(argv)
    artifacts = make_figures(args.run_dir, pred_name=args.pred_name, fps=args.fps,
                             keep_frame_pngs=args.keep_frame_pngs)
    for k, v in artifacts.items():
        print(f"{k}: {v}")
    return artifacts


if __name__ == "__main__":
    main()
