"""Motion-compensated temporal interpolation by symmetric registration.

Port of ``mri_interpolation_tpu/infer/registration.py``. For each pair of
observed frames (A, B) a symmetric half-displacement field v (normalised
units: a fraction of the volume's extent per axis) minimises

    || A(x + v(x)) - B(x - v(x)) ||^2  +  smooth * ||grad v||^2

so the midpoint frame is ``0.5 * (A(x + v) + B(x - v))``. The field is a
coarse control grid upsampled linearly, optimised coarse to fine over an
image pyramid by Adam (``torch.optim.Adam``, optax's ``adam`` defaults). The
group registration fits one control field per frame of a stack with a
temporal second-difference prior; ``motion_transfer_at`` resamples observed
frames along a warp INR's learned field instead.

Everything runs on ``device`` (``cuda`` unless ``"cpu"``): the control
fields are tensors there, the upsampled volumes come back as numpy. Three
XLA semantics are reproduced, because the optimisation starts from a zero
field with every sample on a grid node, where an ulp decides which cell
``floor`` picks and so the sign of the first gradient:

- the sampling grid is float32 ``jnp.linspace(0, 1, s)``:
  ``arange(s) * float32(1 / (s - 1))`` with the last entry 1.0
  (``torch.linspace`` differs from it for most sizes);
- ``jax.image.resize(..., "linear")``: a separable triangle kernel at the
  sample points ``(i + 0.5) / scale - 0.5``, widened by ``1 / scale`` and
  normalised when downsampling (antialiased; torch has no antialiased
  trilinear mode), applied as one (out, in) matrix per axis whose size
  changes;
- ``map_coordinates(order=1, mode="nearest")``: index ``pos * (S - 1)``,
  ``floor``, each corner index clamped to [0, S - 1] on its own, the 2^d
  weighted corners summed; its gradient in the positions is this formula's,
  not ``grid_sample``'s (which clamps the coordinate).

The JAX module's ``_pinnable`` / ``MRI_TPU_REG_DEVICE`` (a TPU-runtime
workaround that moves the solvers off the accelerator) is not ported: the
caller's ``device`` decides.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "warp_frame",
    "register_pair",
    "synthesize_frame",
    "synthesize_frame_accel",
    "register_even_frames",
    "motion_compensated_upsample",
    "register_group_temporal",
    "group_motion_upsample",
    "group_synthesize_at",
    "motion_transfer_at",
]

Field = Callable[[torch.Tensor], torch.Tensor]


def linspace01(s: int) -> np.ndarray:
    """float32 ``jnp.linspace(0, 1, s)``: ``arange(s) * float32(1 / (s -
    1))``, the last entry exactly 1.0."""
    if s == 1:
        return np.zeros(1, np.float32)
    out = np.arange(s, dtype=np.float32) * np.float32(1.0 / (s - 1))
    out[-1] = 1.0
    return out


@functools.lru_cache(maxsize=64)
def _base_grid_cached(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    axes = [torch.from_numpy(linspace01(s)) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).to(device)


def _base_grid(shape: Sequence[int], device: torch.device) -> torch.Tensor:
    """(shape..., D) positions in [0, 1], 'ij' order (shared; not to be
    written)."""
    return _base_grid_cached(tuple(int(s) for s in shape), device)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) float32 matrix of ``jax.image.resize(...,
    "linear")`` along one axis: a triangle kernel at the sample points
    ``(i + 0.5) / scale - 0.5`` (scale = n_out / n_in), widened by ``1 /
    scale`` when downsampling, each column normalised, zero where the sample
    point falls outside [-0.5, n_in - 0.5]."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in) - f32(0.5))
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(n_in, n_out)).to(device)


def resize_linear(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, out_shape, "linear")``: one (out, in) matrix
    product along each axis whose size changes, none along the others."""
    out_shape = tuple(int(s) for s in out_shape)
    if len(out_shape) != x.ndim:
        raise ValueError(f"out_shape {out_shape} rank != input rank {x.ndim}")
    for axis, n_out in enumerate(out_shape):
        n_in = x.shape[axis]
        if n_in != n_out:
            w = _resize_matrix_on(n_in, n_out, x.device)
            x = torch.movedim(torch.tensordot(w, x, dims=([1], [axis])), 0, axis)
    return x


def _field_to_grid(ctrl: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Upsample control fields (..., G..., D) to (..., shape..., D)."""
    lead = ctrl.shape[:ctrl.ndim - 1 - len(shape)]
    return resize_linear(ctrl, tuple(lead) + tuple(shape) + (ctrl.shape[-1],))


def _sample(frames: torch.Tensor, pos: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """``map_coordinates(frame, pos * (S - 1), order=1, mode="nearest")``.

    ``frames``: (B..., S...) with ``batch`` = len(B...) leading axes (the
    group stage's T frames, each sampled at its own positions); ``pos``:
    (B..., P..., D) in [0, 1] per axis (0: the first voxel, 1: the last).
    Returns (B..., P...). The corners' weights multiply in axis order and
    the corners add in ``itertools.product`` order, as in JAX."""
    spatial = frames.shape[batch:]
    d = len(spatial)
    lead = frames.shape[:batch]
    flat = frames.reshape(*lead, -1) if batch else frames.reshape(-1)
    strides = [int(np.prod(spatial[k + 1:])) for k in range(d)]
    axes = []
    for k in range(d):
        c = pos[..., k] * float(spatial[k] - 1)
        lower = torch.floor(c)
        upper_w = c - lower
        lower_w = 1 - upper_w
        i0 = lower.to(torch.int64)
        size = spatial[k]
        axes.append(((torch.clamp(i0, 0, size - 1) * strides[k], lower_w),
                     (torch.clamp(i0 + 1, 0, size - 1) * strides[k], upper_w)))
    out = None
    for corner in range(1 << d):
        index, weight = None, None
        for k in range(d):
            i, w = axes[k][(corner >> (d - 1 - k)) & 1]
            index = i if index is None else index + i
            weight = w if weight is None else weight * w
        if batch:
            values = torch.gather(flat, batch, index.reshape(*lead, -1)).reshape(index.shape)
        else:
            values = flat[index]
        term = weight * values
        out = term if out is None else out + term
    return out


def _frame(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)


def warp_frame(frame, disp_norm, device: DeviceLike = None) -> torch.Tensor:
    """Sample ``frame`` at x + disp(x), the displacement in normalised units."""
    dev = resolve_device(device)
    f = _frame(frame, dev)
    return _sample(f, _base_grid(f.shape, dev) + _frame(disp_norm, dev))


def _smoothness(ctrl: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Mean squared first difference of the control field along each of its
    axes ``first``..ndim-2 (the last holds the components)."""
    reg = ctrl.new_zeros(())
    for k in range(first, ctrl.ndim - 1):
        if ctrl.shape[k] > 1:
            d = torch.diff(ctrl, dim=k)
            reg = reg + torch.mean(d * d)
    return reg


def _resize_frame(frames: torch.Tensor, factor: int, batch: int = 0) -> torch.Tensor:
    if factor <= 1:
        return frames
    out = tuple(frames.shape[:batch]) + tuple(max(2, s // factor) for s in frames.shape[batch:])
    return resize_linear(frames, out)


def _adam(ctrl0: torch.Tensor, loss_fn: Callable[[torch.Tensor], torch.Tensor], lr: float,
          steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` updates of Adam (b1 0.9, b2 0.999, eps 1e-8: ``optax.adam``)
    from ``ctrl0``; returns (ctrl, losses)."""
    ctrl = ctrl0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([ctrl], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(ctrl)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return ctrl.detach(), (torch.stack(losses) if losses else ctrl.new_zeros((0,)))


def _pair_loss(a: torch.Tensor, b: torch.Tensor, smooth: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The symmetric matching loss of one pyramid level plus smoothness."""
    grid = _base_grid(a.shape, a.device)

    def loss_fn(ctrl):
        v = _field_to_grid(ctrl, a.shape)
        fa = _sample(a, grid + v)
        fb = _sample(b, grid - v)
        return torch.mean((fa - fb) ** 2) + smooth * _smoothness(ctrl)

    return loss_fn


def _register_stage(a, b, ctrl0, lr: float, smooth: float, steps: int):
    """One coarse-to-fine stage: Adam on the symmetric matching loss."""
    return _adam(ctrl0, _pair_loss(a, b, smooth), lr, steps)


def _stage_shape(shape: Sequence[int], size: int, thin_axis_cap: int) -> Tuple[int, ...]:
    """The control grid of a stage: ``size`` per axis, at most
    max(2, thin_axis_cap) on an axis a quarter of the extent or thinner."""
    extent = max(shape)
    return tuple(min(size, max(2, thin_axis_cap)) if s * 4 <= extent else size for s in shape)


def register_pair(frame_a, frame_b, ctrl_sizes: Sequence[int] = (8, 16, 32), pyramid: Sequence[int] = (4, 2, 1),
                  steps: int = 200, lr: float = 3e-3, smooth: float = 1e-2, thin_axis_cap: int = 4,
                  device: DeviceLike = None) -> torch.Tensor:
    """The symmetric half-displacement field between two frames: the final
    control field (G..., D) on ``device``. Stage i runs on the
    ``pyramid[i]``-times-downsampled frames with a ``ctrl_sizes[i]``-wide
    control grid (capped on thin axes by ``thin_axis_cap``), warm-started
    from the previous stage's field resized."""
    dev = resolve_device(device)
    a, b = _frame(frame_a, dev), _frame(frame_b, dev)
    ndim = a.ndim
    ctrl = None
    for size, factor in zip(ctrl_sizes, pyramid):
        gshape = _stage_shape(a.shape, size, thin_axis_cap)
        if ctrl is None:
            ctrl = torch.zeros(gshape + (ndim,), dtype=torch.float32, device=dev)
        elif tuple(ctrl.shape[:-1]) != gshape:
            ctrl = resize_linear(ctrl, gshape + (ndim,))
        ctrl, _ = _register_stage(_resize_frame(a, factor), _resize_frame(b, factor), ctrl, lr, smooth, steps)
    return ctrl


def synthesize_frame(frame_a, frame_b, ctrl, tau: float = 0.5, device: DeviceLike = None) -> torch.Tensor:
    """The motion-compensated frame at fractional time ``tau`` (A at 0, B at
    1) from the symmetric half-field v:
    ``(1 - tau) A(x + 2 tau v) + tau B(x - 2 (1 - tau) v)``."""
    dev = resolve_device(device)
    a, b = _frame(frame_a, dev), _frame(frame_b, dev)
    v = _field_to_grid(_frame(ctrl, dev), a.shape)
    grid = _base_grid(a.shape, dev)
    fa = _sample(a, grid + (2.0 * tau) * v)
    fb = _sample(b, grid - (2.0 * (1.0 - tau)) * v)
    return (1.0 - tau) * fa + tau * fb


def synthesize_frame_accel(frame_a, frame_b, ctrl, ctrl_prev, ctrl_next, gamma: float, tau: float = 0.5,
                           device: DeviceLike = None) -> torch.Tensor:
    """Synthesis on a quadratic motion path: both sampling positions shift
    by ``gamma / 4 * (v_next - v_prev)`` (the neighbouring intervals' fields;
    a missing neighbour counts as this interval's). ``gamma = 0`` is
    :func:`synthesize_frame`."""
    dev = resolve_device(device)
    a, b = _frame(frame_a, dev), _frame(frame_b, dev)
    v = _field_to_grid(_frame(ctrl, dev), a.shape)
    vp = _field_to_grid(_frame(ctrl_prev, dev), a.shape) if ctrl_prev is not None else v
    vn = _field_to_grid(_frame(ctrl_next, dev), a.shape) if ctrl_next is not None else v
    off = (gamma * 0.25) * (vn - vp)
    grid = _base_grid(a.shape, dev)
    fa = _sample(a, grid + (2.0 * tau) * v + off)
    fb = _sample(b, grid - (2.0 * (1.0 - tau)) * v + off)
    return (1.0 - tau) * fa + tau * fb


def _group_loss(frames: torch.Tensor, smooth_s: float, smooth_t: float,
                rel_dt: Optional[torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The group stage's loss on a (T, S...) stack: every frame warped into
    the canonical space by its own field (one batched sample), adjacent
    pairs matched there, plus spatial smoothness, the temporal second
    difference (non-uniform with ``rel_dt``) and a 1e-4 gauge term."""
    T = frames.shape[0]
    shape = frames.shape[1:]
    grid = _base_grid(shape, frames.device)

    def loss_fn(ctrl):
        w = _sample(frames, grid + _field_to_grid(ctrl, shape), batch=1)
        data = torch.mean((w[1:] - w[:-1]) ** 2)
        reg = _smoothness(ctrl, first=1)
        if rel_dt is None:
            tdiff = ctrl[2:] - 2.0 * ctrl[1:-1] + ctrl[:-2]
        else:
            r = rel_dt.reshape((T - 1,) + (1,) * (ctrl.ndim - 1))
            vel = (ctrl[1:] - ctrl[:-1]) / r
            tdiff = (vel[1:] - vel[:-1]) / (0.5 * (r[1:] + r[:-1]))
        gauge = torch.mean(ctrl * ctrl)
        return data + smooth_s * reg + smooth_t * torch.mean(tdiff * tdiff) + 1e-4 * gauge

    return loss_fn


def _register_group_stage(frames, ctrl0, lr: float, smooth_s: float, smooth_t: float, steps: int,
                          rel_dt: Optional[torch.Tensor] = None):
    """One coarse-to-fine stage of the group registration: Adam on
    :func:`_group_loss`; ``ctrl0`` is (T, G..., D)."""
    return _adam(ctrl0, _group_loss(frames, smooth_s, smooth_t, rel_dt), lr, steps)


def register_group_temporal(even, ctrl_sizes: Sequence[int] = (8, 16, 32), pyramid: Sequence[int] = (4, 2, 1),
                            steps: int = 300, lr: float = 3e-3, smooth_s: float = 1e-2, smooth_t: float = 1e-1,
                            thin_axis_cap: int = 4, t_knots: Optional[Sequence[float]] = None,
                            device: DeviceLike = None) -> torch.Tensor:
    """Jointly register a (spatial..., T) stack into one canonical space:
    per-time control fields (T, G..., D) on ``device``, sampling one motion
    trajectory at the observed times (``t_knots``, uniform when None)."""
    dev = resolve_device(device)
    stack = _frame(np.moveaxis(np.asarray(even, np.float32), -1, 0), dev)
    T = stack.shape[0]
    shape = tuple(stack.shape[1:])
    ndim = len(shape)
    rel_dt = None
    if t_knots is not None:
        dt = np.diff(np.asarray(t_knots, np.float32))
        rel_dt = torch.from_numpy(dt / dt.mean()).to(dev)
    ctrl = None
    for size, factor in zip(ctrl_sizes, pyramid):
        gshape = _stage_shape(shape, size, thin_axis_cap)
        if ctrl is None:
            ctrl = torch.zeros((T,) + gshape + (ndim,), dtype=torch.float32, device=dev)
        elif tuple(ctrl.shape[1:-1]) != gshape:
            ctrl = resize_linear(ctrl, (T,) + gshape + (ndim,))
        ctrl, _ = _register_group_stage(_resize_frame(stack, factor, batch=1), ctrl, lr, smooth_s, smooth_t, steps,
                                        rel_dt)
    return ctrl


def _catmull_mid(p0, p1, p2, p3):
    """Catmull-Rom value at the midpoint of the [p1, p2] segment."""
    return (-p0 + 9.0 * p1 + 9.0 * p2 - p3) / 16.0


def _check_t_full(T: int, t_full: int) -> None:
    if t_full not in (2 * T - 1, 2 * T):
        raise ValueError(f"t_full={t_full} incompatible with {T} even frames")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def group_motion_upsample(even, t_full: int, ctrl=None, temporal: str = "cubic", device: DeviceLike = None,
                          **kwargs) -> np.ndarray:
    """The full temporal grid from the group registration: each odd frame
    (the midpoint of even frames k, k + 1) warps both neighbours to the
    motion trajectory interpolated at its time, Catmull-Rom over the four
    neighbouring fields (``temporal="linear"``: their mean), and averages
    them; the even frames pass through."""
    T = even.shape[-1]
    _check_t_full(T, t_full)
    dev = resolve_device(device)
    if ctrl is None:
        ctrl = register_group_temporal(even, device=dev, **kwargs)
    shape = tuple(even.shape[:-1])
    grid = _base_grid(shape, dev)
    fields = _field_to_grid(_frame(ctrl, dev), shape)
    out = np.zeros(shape + (t_full,), np.float32)
    out[..., ::2] = even[..., : (t_full + 1) // 2]
    for k in range(T - 1):
        d1, d2 = fields[k], fields[k + 1]
        if temporal == "cubic":
            d0 = fields[k - 1] if k > 0 else d1
            d3 = fields[k + 2] if k + 2 < T else d2
            dmid = _catmull_mid(d0, d1, d2, d3)
        else:
            dmid = 0.5 * (d1 + d2)
        fa = _sample(_frame(even[..., k], dev), grid - dmid + d1)
        fb = _sample(_frame(even[..., k + 1], dev), grid - dmid + d2)
        out[..., 2 * k + 1] = _to_numpy(0.5 * (fa + fb))
    if t_full == 2 * T:
        out[..., -1] = even[..., -1]
    return out


def group_synthesize_at(frames, t_knots: Sequence[float], t_eval: Sequence[float], ctrl=None,
                        appearance: str = "linear", device: DeviceLike = None, **kwargs) -> np.ndarray:
    """Frames at arbitrary times from the group registration: the per-knot
    fields interpolated by a finite-difference cubic Hermite over the
    (non-uniform) knot times, the two bracketing frames warped to the
    interpolated position and cross-faded, or (``appearance="cubic"``) the
    four neighbours warped and blended by the same Hermite in intensity.
    ``frames``: (spatial..., T_kept); returns (spatial..., len(t_eval))."""
    dev = resolve_device(device)
    t_knots = np.asarray(t_knots, np.float64)
    if ctrl is None:
        ctrl = register_group_temporal(frames, t_knots=t_knots, device=dev, **kwargs)
    shape = tuple(frames.shape[:-1])
    grid = _base_grid(shape, dev)
    T = frames.shape[-1]
    fields = _field_to_grid(_frame(ctrl, dev), shape)
    stack = _frame(np.moveaxis(np.asarray(frames, np.float32), -1, 0), dev)
    out = []
    for t in np.asarray(t_eval, np.float64):
        j = int(np.searchsorted(t_knots, t) - 1)
        j = min(max(j, 0), T - 2)
        t1, t2 = t_knots[j], t_knots[j + 1]
        h = t2 - t1
        s = float((t - t1) / h)
        d1, d2 = fields[j], fields[j + 1]
        # finite-difference tangents scaled to the segment; one-sided at the ends
        m1 = (d2 - fields[j - 1]) * float(h / (t2 - t_knots[j - 1])) if j > 0 else d2 - d1
        m2 = (fields[j + 2] - d1) * float(h / (t_knots[j + 2] - t1)) if j + 2 < T else d2 - d1
        h00 = 2 * s**3 - 3 * s**2 + 1
        h10 = s**3 - 2 * s**2 + s
        h01 = -2 * s**3 + 3 * s**2
        h11 = s**3 - s**2
        dmid = h00 * d1 + h10 * m1 + h01 * d2 + h11 * m2
        fa = _sample(stack[j], grid - dmid + d1)
        fb = _sample(stack[j + 1], grid - dmid + d2)
        if appearance == "cubic":
            if j > 0:
                f0 = _sample(stack[j - 1], grid - dmid + fields[j - 1])
                im1 = (fb - f0) * float(h / (t2 - t_knots[j - 1]))
            else:
                im1 = fb - fa
            if j + 2 < T:
                f3 = _sample(stack[j + 2], grid - dmid + fields[j + 2])
                im2 = (f3 - fa) * float(h / (t_knots[j + 2] - t1))
            else:
                im2 = fb - fa
            out.append(_to_numpy(h00 * fa + h10 * im1 + h01 * fb + h11 * im2))
        else:
            out.append(_to_numpy((1.0 - s) * fa + s * fb))
    return np.stack(out, axis=-1)


def register_even_frames(even, device: DeviceLike = None, **kwargs) -> list:
    """Register each consecutive pair of a (spatial..., T) stack."""
    dev = resolve_device(device)
    return [register_pair(even[..., t], even[..., t + 1], device=dev, **kwargs) for t in range(even.shape[-1] - 1)]


def motion_compensated_upsample(even, t_full: int, fields: Optional[list] = None, accel_gamma: float = 0.0,
                                device: DeviceLike = None, **kwargs) -> np.ndarray:
    """The full temporal grid from the even frames: observed frames pass
    through, each odd frame is the registered midpoint of its neighbours
    (on the quadratic path with ``accel_gamma`` != 0); a trailing frame
    without a right neighbour holds the last even frame."""
    T_even = even.shape[-1]
    _check_t_full(T_even, t_full)
    dev = resolve_device(device)
    if fields is None:
        fields = register_even_frames(even, device=dev, **kwargs)
    out = np.zeros(even.shape[:-1] + (t_full,), np.float32)
    out[..., ::2] = even[..., : (t_full + 1) // 2]
    for t in range(T_even - 1):
        if accel_gamma != 0.0:
            mid = synthesize_frame_accel(even[..., t], even[..., t + 1], fields[t], fields[t - 1] if t > 0 else None,
                                         fields[t + 1] if t + 1 < len(fields) else None, gamma=accel_gamma, tau=0.5,
                                         device=dev)
        else:
            mid = synthesize_frame(even[..., t], even[..., t + 1], fields[t], tau=0.5, device=dev)
        out[..., 2 * t + 1] = _to_numpy(mid)
    if t_full == 2 * T_even:
        out[..., -1] = even[..., -1]
    return out


def motion_transfer_at(frames, t_keep: Sequence[float], t_eval: Sequence[float], warp_field: Field,
                       fp_iters: int = 8, appearance: str = "linear", residual_field: Optional[Field] = None,
                       residual_scale: float = 0.0, device: DeviceLike = None) -> np.ndarray:
    """Frames at ``t_eval`` resampled from the bracketing observed frames
    along a learned motion: INR motion, data appearance.

    ``warp_field(x) -> d``: the displacement (N, s) at coordinates ``x =
    (spatial..., t)`` (N, s + 1), tensors on ``device`` (e.g. a fitted
    ``WarpINR.warp_field``). Pixel x at time t shows the canonical point
    ``c = x + d(x, t)``; in kept frame k that point sits at the y with ``y +
    d(y, t_k) = c``, found by ``fp_iters`` fixed-point iterations; frame k is
    sampled there, and the aligned samples blend in time, linearly or
    (``appearance="cubic"``) by the non-uniform cubic Hermite over four.
    ``residual_field`` / ``residual_scale`` add ``rs (r(x, t) - blend_k r(y_k,
    t_k))``, zero at kept times. ``frames``: (spatial..., len(t_keep));
    returns (spatial..., len(t_eval))."""
    if appearance not in ("linear", "cubic"):
        raise ValueError(f"unknown appearance {appearance!r}")
    dev = resolve_device(device)
    t_keep = np.asarray(t_keep, np.float64)
    spatial = tuple(frames.shape[:-1])
    s_dim = len(spatial)
    grid = _base_grid(spatial, dev).reshape(-1, s_dim)
    stack = _frame(np.moveaxis(np.asarray(frames, np.float32), -1, 0), dev)
    K = len(t_keep)

    def at(y: torch.Tensor, t: float) -> torch.Tensor:
        return torch.cat([y, torch.full((y.shape[0], 1), t, dtype=torch.float32, device=dev)], dim=-1)

    out = []
    with torch.no_grad():
        for t in np.asarray(t_eval, np.float64):
            j = int(np.searchsorted(t_keep, t) - 1)
            j = min(max(j, 0), K - 2)
            tau = float(np.clip((t - t_keep[j]) / (t_keep[j + 1] - t_keep[j]), 0.0, 1.0))
            c = grid + warp_field(at(grid, float(t)))
            ys: dict = {}

            def invert(k: int) -> torch.Tensor:
                """Fixed-point solve of y + d(y, t_k) = c."""
                if k not in ys:
                    y = c
                    for _ in range(fp_iters):
                        y = c - warp_field(at(y, float(t_keep[k])))
                    ys[k] = y
                return ys[k]

            def blend(fetch):
                """The appearance blend across aligned per-kept-frame values,
                applied alike to data and to residual samples."""
                f1, f2 = fetch(j), fetch(j + 1)
                if appearance == "linear":
                    return (1.0 - tau) * f1 + tau * f2
                t1, t2 = t_keep[j], t_keep[j + 1]
                h = t2 - t1
                m1 = (f2 - fetch(j - 1)) * float(h / (t2 - t_keep[j - 1])) if j > 0 else f2 - f1
                m2 = (fetch(j + 2) - f1) * float(h / (t_keep[j + 2] - t1)) if j + 2 < K else f2 - f1
                s = tau
                return ((2 * s**3 - 3 * s**2 + 1) * f1 + (s**3 - 2 * s**2 + s) * m1
                        + (-2 * s**3 + 3 * s**2) * f2 + (s**3 - s**2) * m2)

            def fetch_data(k: int) -> torch.Tensor:
                return _sample(stack[k], invert(k).reshape(spatial + (s_dim,)))

            pred = blend(fetch_data)
            if residual_field is not None and residual_scale > 0.0:
                def fetch_resid(k: int) -> torch.Tensor:
                    return residual_field(at(invert(k), float(t_keep[k])))[:, 0].reshape(spatial)

                r_eval = residual_field(at(grid, float(t)))[:, 0].reshape(spatial)
                pred = pred + residual_scale * (r_eval - blend(fetch_resid))
            out.append(_to_numpy(pred))
    return np.stack(out, axis=-1)
