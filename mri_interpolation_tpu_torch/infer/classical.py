"""Classical (training-free) temporal interpolation baselines.

Port of ``mri_interpolation_tpu/infer/classical.py``:

- ``linear_interpolate_volume``: multilinear resampling, output voxel j on
  axis k at the continuous source index ``linspace(0, S_k - 1, O_k)[j]``
  (endpoints map to endpoints), out-of-range neighbours at the nearest edge
  (``map_coordinates(order=1, mode="nearest")``). Written as a separable
  lerp, one axis at a time: floor, weight, the two neighbours clipped to
  [0, S - 1]; not ``grid_sample``, whose border and ``align_corners`` rules
  differ at the edges. Runs on ``device`` (``cuda`` unless ``"cpu"``);
- ``cubic_interpolate_frames``: per-voxel non-uniform cubic Hermite across
  the last axis, in numpy as in JAX;
- ``temporal_upsample_classical``: ``linear``, ``cubic``, and the
  motion-compensated ``registration`` (pairwise midpoints) and
  ``registration_group`` (one trajectory, Catmull-Rom over the fields) of
  ``infer/registration.py``, on ``device``;
- ``main``: the CLI (``python -m mri_interpolation_tpu_torch.infer.classical
  vol.nii.gz [--slice_z 3] [--method linear|cubic|registration|
  registration_group] [--device cpu]``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["linear_interpolate_volume", "cubic_interpolate_frames", "temporal_upsample_classical", "main"]

METHODS = ("linear", "cubic", "registration", "registration_group")


def _positions(size: int, out: int) -> np.ndarray:
    """``linspace(0, size - 1, out)``: the exact sample positions rounded to
    float32 once (integers stay integers; XLA's float32 ``jnp.linspace`` may
    land an ulp away)."""
    return np.linspace(0.0, size - 1.0, out).astype(np.float32)


def linear_interpolate_volume(volume: np.ndarray, out_shape: Sequence[int], device: DeviceLike = None) -> np.ndarray:
    """Resample ``volume`` to ``out_shape`` by multilinear interpolation on
    ``device``; returns a float32 numpy array."""
    dev = resolve_device(device)
    out_shape = tuple(int(s) for s in out_shape)
    vol = torch.as_tensor(np.asarray(volume, dtype=np.float32)).to(dev)
    if len(out_shape) != vol.ndim:
        raise ValueError(f"out_shape {out_shape} rank != volume rank {vol.ndim}")
    for k, out in enumerate(out_shape):
        size = vol.shape[k]
        pos = torch.from_numpy(_positions(size, out)).to(dev)
        lower = torch.floor(pos)
        w = (pos - lower).reshape([out if j == k else 1 for j in range(vol.ndim)])
        i0 = torch.clamp(lower.to(torch.int64), 0, size - 1)
        i1 = torch.clamp(lower.to(torch.int64) + 1, 0, size - 1)
        vol = torch.index_select(vol, k, i0) * (1.0 - w) + torch.index_select(vol, k, i1) * w
    return vol.cpu().numpy()


def cubic_interpolate_frames(frames: np.ndarray, t_keep: Sequence[float], t_eval: Sequence[float]) -> np.ndarray:
    """Per-voxel non-uniform cubic Hermite (finite-difference tangents;
    Catmull-Rom on uniform spacing) across the last axis of ``frames``
    (spatial..., T) from times ``t_keep`` to ``t_eval``; returns (spatial...,
    len(t_eval)) float32."""
    frames = np.asarray(frames, np.float32)
    t_keep = np.asarray(t_keep, np.float64)
    T = frames.shape[-1]
    out = []
    for t in np.asarray(t_eval, np.float64):
        j = int(np.searchsorted(t_keep, t) - 1)
        j = min(max(j, 0), T - 2)
        t1, t2 = t_keep[j], t_keep[j + 1]
        h = t2 - t1
        s = float((t - t1) / h)
        f1, f2 = frames[..., j], frames[..., j + 1]
        m1 = (f2 - frames[..., j - 1]) * (h / (t2 - t_keep[j - 1])) if j > 0 else f2 - f1
        m2 = (frames[..., j + 2] - f1) * (h / (t_keep[j + 2] - t1)) if j + 2 < T else f2 - f1
        h00 = 2 * s**3 - 3 * s**2 + 1
        h10 = s**3 - 2 * s**2 + s
        h01 = -2 * s**3 + 3 * s**2
        h11 = s**3 - s**2
        out.append(h00 * f1 + h10 * m1 + h01 * f2 + h11 * m2)
    return np.stack(out, axis=-1).astype(np.float32)


def temporal_upsample_classical(src: np.ndarray, t_full: int, method: str = "linear",
                                device: DeviceLike = None) -> np.ndarray:
    """Rebuild a ``t_full``-frame temporal grid from the frames of ``src``,
    the observed frames on every other output frame: ``linear``
    (multilinear resampling), ``cubic`` (per-voxel cubic Hermite),
    ``registration`` (pairwise symmetric registration midpoints) or
    ``registration_group`` (group registration, the trajectory interpolated
    by Catmull-Rom), on ``device``. Methods other than ``linear`` need
    ``t_full`` in (2T - 1, 2T) for a T-frame ``src``."""
    T = src.shape[-1]
    if method != "linear" and t_full not in (2 * T - 1, 2 * T):
        raise ValueError(f"t_full={t_full} incompatible with {T} source frames for method={method!r} (expected 2T-1 "
                         "or 2T; observed frames land on every other output frame)")
    if method == "linear":
        return linear_interpolate_volume(src, src.shape[:-1] + (t_full,), device)
    if method == "cubic":
        t_keep = [min(2 * j, t_full - 1) / (t_full - 1) for j in range(T)]
        t_eval = [i / (t_full - 1) for i in range(t_full)]
        return cubic_interpolate_frames(src, t_keep, t_eval)
    if method == "registration":
        from .registration import motion_compensated_upsample

        return motion_compensated_upsample(src, t_full, device=device)
    if method == "registration_group":
        from .registration import group_motion_upsample

        return group_motion_upsample(src, t_full, device=device)
    raise ValueError(f"unknown method {method!r}; expected one of {', '.join(METHODS)}")


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """The reference's interp.py protocol: load a volume, normalise by its
    maximum, take the (x, y, t) slice at ``--slice_z`` of a 4-D volume, keep
    the even frames and rebuild the whole temporal grid (or, with
    ``--no-even_frames``, resample all frames onto their own grid,
    ``linear`` only), save it as NIfTI. Returns the saved array."""
    import argparse

    from ..io import nifti

    p = argparse.ArgumentParser(description="classical temporal interpolation baselines")
    p.add_argument("image_path")
    p.add_argument("--out", default="itk_interpolated.nii.gz")
    p.add_argument("--slice_z", type=int, default=3)
    p.add_argument("--even_frames", action=argparse.BooleanOptionalAction, default=True,
                   help="interpolate from the even frames only (--no-even_frames uses all frames)")
    p.add_argument("--method", default="linear", choices=list(METHODS),
                   help="temporal interpolator (see temporal_upsample_classical)")
    p.add_argument("--device", default=None, help="device to run on: cuda (the default) or cpu")
    args = p.parse_args(argv)

    data = nifti.load(args.image_path).get_fdata(np.float32)
    data = data / data.max()
    if data.ndim == 4 and args.slice_z is not None:
        data = data[:, :, args.slice_z, :]
    full_shape = data.shape
    if args.even_frames:
        out = temporal_upsample_classical(data[..., ::2], full_shape[-1], method=args.method, device=args.device)
    else:
        if args.method != "linear":
            p.error("--no-even_frames supports --method linear only (the other methods synthesize new frames)")
        out = linear_interpolate_volume(data, full_shape, device=args.device)
    nifti.save(out.astype(np.float32), args.out)
    print(f"wrote {args.out} shape={out.shape} method={args.method}")
    return out


if __name__ == "__main__":
    main()
