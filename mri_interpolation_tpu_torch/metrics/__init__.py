"""Quality metrics: MSE / PSNR / SSIM (port of
``mri_interpolation_tpu/metrics/__init__.py``).

SSIM follows skimage's defaults (uniform 7^d window, K1 0.01, K2 0.03,
sample-covariance normalisation) in float32, with second moments taken on
globally mean-shifted images so a near-exact reconstruction cannot read above
1.0 from cancellation in E[x^2] - E[x]^2.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["mse", "psnr", "ssim", "evaluate_reconstruction"]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    return 10.0 * torch.log10((data_range**2) / torch.clamp(mse(pred, target), min=1e-20))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable mean filter over 'valid' windows of every axis."""
    for axis in range(x.ndim):
        x = x.unfold(axis, size, 1).sum(dim=-1) / size
    return x


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity over an n-D image."""
    if any(s < win_size for s in pred.shape):
        raise ValueError(f"image shape {tuple(pred.shape)} smaller than win_size {win_size}")
    x = pred.float()
    y = target.float()
    np_ = win_size**x.ndim
    cov_norm = np_ / (np_ - 1)

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    mx, my = x.mean(), y.mean()
    xc, yc = x - mx, y - my
    uxc, uyc = ux - mx, uy - my
    vx = cov_norm * (_uniform_filter(xc * xc, win_size) - uxc * uxc)
    vy = cov_norm * (_uniform_filter(yc * yc, win_size) - uyc * uyc)
    vxy = cov_norm * (_uniform_filter(xc * yc, win_size) - uxc * uyc)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean()


def evaluate_reconstruction(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0,
                            device: DeviceLike = None) -> Dict[str, float]:
    """MSE / PSNR / SSIM as Python floats, computed on ``device``. The SSIM
    window adapts to the smallest axis (largest odd size <= 7 that fits)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(pred, dtype=np.float32)).to(dev)
    t = torch.as_tensor(np.asarray(target, dtype=np.float32)).to(dev)
    out = {"mse": float(mse(p, t)), "psnr": float(psnr(p, t, data_range))}
    win = min(7, min(int(s) for s in p.shape))
    win -= (win + 1) % 2
    if win >= 3:
        out["ssim"] = float(ssim(p, t, data_range, win_size=win))
    return out
