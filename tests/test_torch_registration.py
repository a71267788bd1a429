"""Port parity: motion-compensated registration (``infer/registration.py``),
the registration protocol (``train/protocols.py:registration_interp_eval``)
and the classical CLI's registration methods, against the JAX package on the
CPU, with inputs made from numpy seeds.

Tolerances and their reasons:

- the sampling grid: bitwise equal to float32 ``jnp.linspace(0, 1, s)``;
- the linear resize: within 1e-6 of the largest value (the same float32
  weight matrices; XLA's einsum and torch's tensordot sum in other orders);
- the order-1 sampler: values within 1e-6 of the largest, gradients in the
  positions within 1e-5 of the largest (the same corner formula);
- the step-0 gradient of both stages' losses: within 1e-6 of its largest
  entry, and no sign flipped where |g| exceeds that bound;
- each stage's control field after 20 Adam steps from one start: within
  1e-4 of the largest entry (2e-5 on the 3-D pair's second stage);
- the control fields of a whole run (two stages of 20 steps): within 1e-4
  of the largest entry where the problem is well conditioned (the 2-D pair,
  the uniform group), within lr (3e-3) absolute where it is not. Adam
  divides each gradient by its running RMS, so rounding noise where the
  loss is flat moves a control point by up to lr a step: JAX alone moves
  the non-uniform group's final fields by 3e-4 (of 0.10) when its first
  stage's fields are perturbed by 4e-7, as far as the port's first stage
  differs from JAX's; the 3-D pair (8 control points on a 4-voxel axis) by
  1e-5 for 5e-7;
- the syntheses from JAX's control fields: within 1e-6 (values in [0, 1]);
  the end-to-end upsamplings within 1e-4;
- the motion transfer through a warp INR moved over by
  ``convert.params_from_jax``: within 1e-5 (eight fixed-point evaluations
  of a sine field);
- the protocol's metrics: PSNR within 0.05 dB, SSIM within 5e-3 (PERF.md
  section 2); the CLI's files within 1e-4, as the upsamplings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from mri_interpolation_tpu.infer import classical as jclassical
from mri_interpolation_tpu.infer import registration as J
from mri_interpolation_tpu.models import warp as jwarp
from mri_interpolation_tpu.train import protocols as jprotocols
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.infer import classical
from mri_interpolation_tpu_torch.infer import registration as R
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_warp_inr
from mri_interpolation_tpu_torch.train import protocols

SMALL = dict(ctrl_sizes=(4, 8), pyramid=(2, 1), steps=20)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"


def _smooth(shape, seed, sigma=2.0):
    """A smooth random frame in [0, 1]."""
    a = gaussian_filter(np.random.default_rng(seed).random(shape), sigma)
    return ((a - a.min()) / (a.max() - a.min())).astype(np.float32)


def _blob(shape, center, sigma=0.12):
    axes = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    d2 = np.sum((grid - np.asarray(center, np.float32)) ** 2, axis=-1)
    return np.exp(-d2 / (2.0 * sigma**2)).astype(np.float32)


def _moving(t_full=7, shape=(20, 24)):
    return np.stack([_blob(shape, (0.3 + 0.05 * t, 0.45 + 0.02 * t)) for t in range(t_full)], axis=-1)


def test_base_grid_is_jnp_linspace():
    """Bitwise for the sizes up to 16, the ankle's and its pyramid's, and a
    few others; ``torch.linspace`` rounds most of them differently (the
    case the port avoids)."""
    torch_differs = 0
    for s in [*range(1, 17), 88, 97, 176, 333, 351, 352, 399, 704]:
        want = np.asarray(jnp.linspace(0.0, 1.0, s, dtype=jnp.float32))
        np.testing.assert_array_equal(R.linspace01(s), want, err_msg=str(s))
        torch_differs += not np.array_equal(torch.linspace(0, 1, s).numpy(), want)
    assert torch_differs >= 15
    grid = R._base_grid((5, 7, 3), torch.device("cpu")).numpy()
    np.testing.assert_array_equal(grid, np.asarray(J._base_grid((5, 7, 3))))


RESIZES = {
    "2d_down": ((20, 24), (5, 6)),
    "2d_up": ((4, 8), (20, 24)),
    "2d_odd": ((352, 352), (88, 176)),
    "3d_down_thin": ((64, 64, 6), (16, 16, 2)),
    "3d_up": ((4, 4, 2), (12, 12, 4)),
    "stack_unchanged_axes": ((4, 8, 8, 2), (4, 20, 24, 2)),
    "unchanged": ((6, 5, 2), (6, 5, 2)),
}


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_matches_jax(name):
    shape, out = RESIZES[name]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
    got = R.resize_linear(torch.from_numpy(x), out).numpy()
    assert got.shape == out
    _close(got, want, 1e-6, name)


def test_resize_antialiases_when_downsampling():
    """JAX's downsampling widens the triangle kernel; torch's bilinear
    without antialias does not, and differs by far more than an ulp."""
    x = np.random.default_rng(0).random((40, 36)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (10, 9), "linear"))
    plain = F.interpolate(torch.from_numpy(x)[None, None], size=(10, 9), mode="bilinear",
                          align_corners=False)[0, 0].numpy()
    assert np.abs(plain - want).max() > 0.05
    _close(R.resize_linear(torch.from_numpy(x), (10, 9)).numpy(), want, 1e-6)


def _positions(shape, n, seed):
    """Positions on grid nodes, inside and outside [0, 1]."""
    rng = np.random.default_rng(seed)
    d = len(shape)
    nodes = np.stack([rng.integers(0, s, n) / max(s - 1, 1) for s in shape], -1)
    inside = rng.random((n, d))
    outside = rng.uniform(-0.3, 1.3, (n, d))
    return np.concatenate([nodes, inside, outside]).astype(np.float32)


@pytest.mark.parametrize("shape", [(9, 11), (6, 7, 4)], ids=["2d", "3d"])
def test_sample_matches_map_coordinates(shape):
    frame = np.random.default_rng(1).random(shape).astype(np.float32)
    pos = _positions(shape, 64, 2)
    w = np.random.default_rng(3).standard_normal(len(pos)).astype(np.float32)
    want = np.asarray(J._sample(jnp.asarray(frame), jnp.asarray(pos)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(w * J._sample(jnp.asarray(frame), p)))(jnp.asarray(pos)))
    p = torch.from_numpy(pos).requires_grad_(True)
    got = R._sample(torch.from_numpy(frame), p)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-6, "values")
    _close(p.grad.numpy(), want_g, 1e-5, "gradients")


def test_sample_batched_is_per_frame():
    frames = np.random.default_rng(4).random((3, 8, 9)).astype(np.float32)
    pos = np.random.default_rng(5).uniform(-0.1, 1.1, (3, 8, 9, 2)).astype(np.float32)
    got = R._sample(torch.from_numpy(frames), torch.from_numpy(pos), batch=1).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], R._sample(torch.from_numpy(frames[k]), torch.from_numpy(pos[k])).numpy())


def test_grid_sample_gradient_differs_at_nodes():
    """``grid_sample(border, align_corners=True)`` samples the same values,
    but its gradient on grid nodes is not map_coordinates': the formula is
    ported instead."""
    frame = np.random.default_rng(6).random((9, 11)).astype(np.float32)
    pos = _positions((9, 11), 64, 7)[:64]  # on nodes
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(J._sample(jnp.asarray(frame), p)))(jnp.asarray(pos)))
    p = torch.from_numpy(pos).requires_grad_(True)
    g = (p[:, [1, 0]] * 2 - 1)[None, None]
    out = F.grid_sample(torch.from_numpy(frame)[None, None], g, mode="bilinear", padding_mode="border",
                        align_corners=True)
    _close(out[0, 0, 0].detach().numpy(), np.asarray(J._sample(jnp.asarray(frame), jnp.asarray(pos))), 1e-6)
    out.sum().backward()
    assert np.abs(p.grad.numpy() - want_g).max() > 1e-2


def _jax_pair_loss(a, b, smooth):
    grid = J._base_grid(a.shape)

    def loss(ctrl):
        v = J._field_to_grid(ctrl, a.shape)
        fa = J._sample(jnp.asarray(a), grid + v)
        fb = J._sample(jnp.asarray(b), grid - v)
        return jnp.mean((fa - fb) ** 2) + smooth * J._smoothness(ctrl)

    return loss


def _jax_group_loss(frames, smooth_s, smooth_t, rel_dt):
    """The loss of JAX's ``_register_group_stage``, term by term."""
    T, shape = frames.shape[0], frames.shape[1:]
    grid = J._base_grid(shape)

    def loss(ctrl):
        w = jnp.stack([J._sample(jnp.asarray(frames[k]), grid + J._field_to_grid(ctrl[k], shape)) for k in range(T)])
        data = jnp.mean((w[1:] - w[:-1]) ** 2)
        reg = 0.0
        for k in range(1, ctrl.ndim - 1):
            d = jnp.diff(ctrl, axis=k)
            reg = reg + jnp.mean(d * d)
        r = jnp.asarray(rel_dt).reshape((T - 1,) + (1,) * (ctrl.ndim - 1))
        vel = (ctrl[1:] - ctrl[:-1]) / r
        tdiff = (vel[1:] - vel[:-1]) / (0.5 * (r[1:] + r[:-1]))
        return data + smooth_s * reg + smooth_t * jnp.mean(tdiff * tdiff) + 1e-4 * jnp.mean(ctrl * ctrl)

    return loss


def _assert_gradient_matches(got, want, what):
    bound = 1e-6 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound, what
    big = np.abs(want) > bound
    assert np.array_equal(np.sign(got[big]), np.sign(want[big])), f"{what}: a sign flipped"


def test_step_zero_gradient_of_the_pair_stage():
    """An 88 x 88 pair and an 8 x 8 control grid at zero: every sample on a
    grid node, where the grid's last ulp picks the cell."""
    a = _smooth((88, 88), 0, sigma=3.0)
    b = np.roll(a, 3, axis=0)
    ctrl0 = np.zeros((8, 8, 2), np.float32)
    loss = _jax_pair_loss(a, b, 1e-2)
    _, jlosses = J._register_stage(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ctrl0), jnp.float32(3e-3),
                                   jnp.float32(1e-2), 1)
    assert float(loss(jnp.asarray(ctrl0))) == float(jlosses[0])  # the reconstruction is JAX's loss
    want = np.asarray(jax.grad(loss)(jnp.asarray(ctrl0)))
    c = torch.zeros(8, 8, 2, requires_grad=True)
    got_loss = R._pair_loss(torch.from_numpy(a), torch.from_numpy(b), 1e-2)(c)
    got_loss.backward()
    assert abs(got_loss.item() - float(jlosses[0])) <= 1e-6 * float(jlosses[0])
    _assert_gradient_matches(c.grad.numpy(), want, "pair stage")


def test_step_zero_gradient_of_the_group_stage():
    frames = np.moveaxis(_moving(4, (24, 20)), -1, 0)
    rel_dt = np.asarray([0.8, 1.2, 1.0], np.float32)
    ctrl0 = np.zeros((4, 4, 4, 2), np.float32)
    loss = _jax_group_loss(frames, 1e-2, 1e-1, rel_dt)
    _, jlosses = J._register_group_stage(jnp.asarray(frames), jnp.asarray(ctrl0), jnp.float32(3e-3),
                                         jnp.float32(1e-2), jnp.float32(1e-1), 1, jnp.asarray(rel_dt))
    assert abs(float(loss(jnp.asarray(ctrl0))) - float(jlosses[0])) <= 1e-7 * float(jlosses[0])
    want = np.asarray(jax.grad(loss)(jnp.asarray(ctrl0)))
    c = torch.zeros(ctrl0.shape, requires_grad=True)
    R._group_loss(torch.from_numpy(frames), 1e-2, 1e-1, torch.from_numpy(rel_dt))(c).backward()
    _assert_gradient_matches(c.grad.numpy(), want, "group stage")


LR = 3e-3  # the registrations' default Adam rate


@pytest.mark.parametrize("shape,rel,atol", [((20, 24), 1e-4, 0.0), ((12, 12, 4), 0.0, LR)], ids=["2d", "3d"])
def test_register_pair_matches_jax(shape, rel, atol):
    a = _smooth(shape, 1)
    b = np.roll(a, 1, axis=0)
    want = np.asarray(J.register_pair(a, b, **SMALL))
    got = R.register_pair(a, b, device="cpu", **SMALL)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=max(atol, rel * float(np.abs(want).max())))


@pytest.mark.parametrize("shape", [(20, 24), (12, 12, 4)], ids=["2d", "3d"])
def test_pair_stages_from_one_start(shape):
    """register_pair's loop with JAX's field handed to both packages at each
    stage: the stage shapes, the pyramid and each stage's Adam run."""
    a = _smooth(shape, 1)
    b = np.roll(a, 1, axis=0)
    ctrl = None
    for size, factor in zip(SMALL["ctrl_sizes"], SMALL["pyramid"]):
        gshape = R._stage_shape(a.shape, size, 4)
        if ctrl is None:
            ctrl = np.zeros(gshape + (a.ndim,), np.float32)
        else:
            ctrl = np.array(jax.image.resize(jnp.asarray(ctrl), gshape + (a.ndim,), "linear"))
        ja, jb = (J._resize_frame(jnp.asarray(f), factor) for f in (a, b))
        want, _ = J._register_stage(ja, jb, jnp.asarray(ctrl), jnp.float32(LR), jnp.float32(1e-2), SMALL["steps"])
        ta, tb = (R._resize_frame(torch.from_numpy(f), factor) for f in (a, b))
        got, _ = R._register_stage(ta, tb, torch.from_numpy(ctrl), LR, 1e-2, SMALL["steps"])
        _close(got.numpy(), want, 1e-4, f"stage {size}")
        ctrl = np.array(want)
    assert ctrl.shape == np.asarray(J.register_pair(a, b, **SMALL)).shape


@pytest.mark.parametrize("knots,rel,atol", [(None, 1e-4, 0.0), ((0.0, 0.2, 0.5, 0.6, 1.0), 0.0, LR)],
                         ids=["uniform", "nonuniform"])
def test_register_group_temporal_matches_jax(knots, rel, atol):
    even = _moving(5)
    want = np.asarray(J.register_group_temporal(even, t_knots=knots, **SMALL))
    got = R.register_group_temporal(even, t_knots=knots, device="cpu", **SMALL)
    assert tuple(got.shape) == want.shape == (5, 8, 8, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=max(atol, rel * float(np.abs(want).max())))


@pytest.mark.parametrize("knots", [None, (0.0, 0.2, 0.5, 0.6, 1.0)], ids=["uniform", "nonuniform"])
def test_group_stages_from_one_start(knots):
    even = _moving(5)
    stack = np.moveaxis(even, -1, 0)
    rel_dt = None
    if knots is not None:
        dt = np.diff(np.asarray(knots, np.float32))
        rel_dt = dt / dt.mean()
    ctrl = None
    for size, factor in zip(SMALL["ctrl_sizes"], SMALL["pyramid"]):
        gshape = (5,) + R._stage_shape(stack.shape[1:], size, 4) + (2,)
        ctrl = np.zeros(gshape, np.float32) if ctrl is None else np.array(
            jax.image.resize(jnp.asarray(ctrl), gshape, "linear"))
        frames = jnp.stack([J._resize_frame(jnp.asarray(stack[k]), factor) for k in range(5)])
        want, _ = J._register_group_stage(frames, jnp.asarray(ctrl), jnp.float32(LR), jnp.float32(1e-2),
                                          jnp.float32(1e-1), SMALL["steps"],
                                          None if rel_dt is None else jnp.asarray(rel_dt))
        got, _ = R._register_group_stage(R._resize_frame(torch.from_numpy(stack), factor, batch=1),
                                         torch.from_numpy(ctrl), LR, 1e-2, 1e-1, SMALL["steps"],
                                         None if rel_dt is None else torch.from_numpy(rel_dt))
        _close(got.numpy(), want, 1e-4, f"stage {size}")
        ctrl = np.array(want)


def test_syntheses_from_jax_fields_match():
    even = _moving(7)
    fields = [np.asarray(f) for f in J.register_even_frames(even, **SMALL)]
    a, b = even[..., 2], even[..., 3]
    for tau in (0.0, 0.3, 0.5, 1.0):
        np.testing.assert_allclose(R.synthesize_frame(a, b, fields[2], tau=tau, device="cpu").numpy(),
                                   np.asarray(J.synthesize_frame(a, b, fields[2], tau=tau)), rtol=0, atol=1e-6)
    for prev, nxt in ((fields[1], fields[3]), (None, fields[3]), (fields[1], None)):
        np.testing.assert_allclose(
            R.synthesize_frame_accel(a, b, fields[2], prev, nxt, gamma=0.7, device="cpu").numpy(),
            np.asarray(J.synthesize_frame_accel(a, b, fields[2], prev, nxt, gamma=0.7)), rtol=0, atol=1e-6)
    for t_full, gamma in ((13, 0.0), (14, 0.5)):
        src = even[..., : (t_full + 1) // 2]
        got = R.motion_compensated_upsample(src, t_full, fields=fields[:src.shape[-1] - 1], accel_gamma=gamma,
                                            device="cpu")
        want = J.motion_compensated_upsample(src, t_full, fields=fields[:src.shape[-1] - 1], accel_gamma=gamma)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_motion_compensated_upsample_end_to_end():
    even = _moving(9)[..., ::2]
    got = R.motion_compensated_upsample(even, 9, device="cpu", **SMALL)
    np.testing.assert_array_equal(got[..., ::2], even)
    np.testing.assert_allclose(got, J.motion_compensated_upsample(even, 9, **SMALL), rtol=0, atol=1e-4)


@pytest.mark.parametrize("temporal", ["cubic", "linear"])
def test_group_motion_upsample_matches_jax(temporal):
    even = _moving(5)
    ctrl = np.asarray(J.register_group_temporal(even, **SMALL))
    for t_full in (9, 10):
        got = R.group_motion_upsample(even, t_full, ctrl=ctrl, temporal=temporal, device="cpu")
        np.testing.assert_array_equal(got[..., ::2], even[..., : (t_full + 1) // 2])
        np.testing.assert_allclose(got, J.group_motion_upsample(even, t_full, ctrl=ctrl, temporal=temporal),
                                   rtol=0, atol=1e-6)
    end_to_end = R.group_motion_upsample(even, 9, temporal=temporal, device="cpu", **SMALL)
    np.testing.assert_allclose(end_to_end, J.group_motion_upsample(even, 9, temporal=temporal, **SMALL), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("appearance", ["linear", "cubic"])
def test_group_synthesize_at_nonuniform_matches_jax(appearance):
    frames = _moving(6)
    knots = np.asarray([0.0, 0.15, 0.4, 0.5, 0.8, 1.0])
    t_eval = [0.05, 0.3, 0.45, 0.7, 0.95]
    ctrl = np.asarray(J.register_group_temporal(frames, t_knots=knots, **SMALL))
    got = R.group_synthesize_at(frames, knots, t_eval, ctrl=ctrl, appearance=appearance, device="cpu")
    np.testing.assert_allclose(got, J.group_synthesize_at(frames, knots, t_eval, ctrl=ctrl, appearance=appearance),
                               rtol=0, atol=1e-6)
    got = R.group_synthesize_at(frames, knots, t_eval, appearance=appearance, device="cpu", **SMALL)
    np.testing.assert_allclose(got, J.group_synthesize_at(frames, knots, t_eval, appearance=appearance, **SMALL),
                               rtol=0, atol=1e-4)


def _warp_pair(residual_scale=0.05):
    """A JAX warp INR with a random nonzero warp and residual head, and the
    port's with the same parameters."""
    kw = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=10, base_resolution=(4, 4),
              finest_resolution=(20, 24), dim_hidden=8, warp_hidden=16, warp_layers=3, warp_scale=0.05,
              residual_scale=residual_scale)
    jm = jwarp.make_warp_inr(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(3)))
    rng = np.random.default_rng(3)
    for head in ("warp", "residual"):
        for layer in params[head][-1:]:
            layer["w"] = rng.uniform(-1, 1, layer["w"].shape).astype(np.float32)
            layer["b"] = rng.uniform(-0.2, 0.2, layer["b"].shape).astype(np.float32)
    tm = make_warp_inr(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, tm


@pytest.mark.parametrize("appearance,residual", [("linear", False), ("cubic", False), ("linear", True),
                                                 ("cubic", True)])
def test_motion_transfer_matches_jax(appearance, residual):
    jm, params, tm = _warp_pair()
    frames = _moving(5)[..., [0, 1, 2, 4]]
    t_keep, t_eval = [0.0, 0.25, 0.5, 1.0], [0.1, 0.3, 0.5, 0.75, 0.9]
    jf = lambda x: jm.hparams["warp_field"](params, x)  # noqa: E731
    jr = (lambda x: jm.hparams["residual_field"](params, x)) if residual else None  # noqa: E731
    want = J.motion_transfer_at(frames, t_keep, t_eval, jf, appearance=appearance, residual_field=jr,
                                residual_scale=0.05)
    got = R.motion_transfer_at(frames, t_keep, t_eval, tm.warp_field, appearance=appearance,
                               residual_field=tm.residual_field if residual else None, residual_scale=0.05,
                               device="cpu")
    assert got.shape == frames.shape[:-1] + (5,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_motion_transfer_reproduces_kept_frames():
    """At a kept time the fixed point is y = x: the observed frame comes
    back (to the fixed-point residual of a spatially varying field), and
    the residual correction is zero there."""
    _, _, tm = _warp_pair()
    frames = _moving(5)[..., [0, 2, 4]]
    t_keep = [0.0, 0.5, 1.0]
    got = R.motion_transfer_at(frames, t_keep, t_keep, tm.warp_field, residual_field=tm.residual_field,
                               residual_scale=0.05, device="cpu")
    for k in range(3):
        assert float(np.abs(got[..., k] - frames[..., k]).max()) < 0.03, k
    with pytest.raises(ValueError, match="appearance"):
        R.motion_transfer_at(frames, t_keep, t_keep, tm.warp_field, appearance="nearest", device="cpu")


def test_endpoints_and_refusals():
    a, b = _blob((24, 24), (0.35, 0.5)), _blob((24, 24), (0.65, 0.5))
    ctrl = R.register_pair(a, b, device="cpu", **SMALL)
    np.testing.assert_allclose(R.synthesize_frame(a, b, ctrl, tau=0.0, device="cpu").numpy(), a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(R.synthesize_frame(a, b, ctrl, tau=1.0, device="cpu").numpy(), b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(R.warp_frame(a, np.zeros((24, 24, 2), np.float32), device="cpu").numpy(), a,
                               rtol=0, atol=1e-6)
    even = _moving(9)[..., ::2]
    for fn in (R.motion_compensated_upsample, R.group_motion_upsample):
        with pytest.raises(ValueError, match="incompatible"):
            fn(even, 42, device="cpu")


def test_registration_interp_eval_matches_jax():
    img = _moving(9, (24, 24))
    jrecon, jq = jprotocols.registration_interp_eval(img, **SMALL)
    recon, q = protocols.registration_interp_eval(img, device="cpu", **SMALL)
    np.testing.assert_array_equal(recon[..., ::2], img[..., ::2])
    np.testing.assert_allclose(recon, jrecon, rtol=0, atol=1e-4)
    assert set(q) == {"full", "odd"}
    for part in ("full", "odd"):
        assert abs(q[part]["psnr"] - jq[part]["psnr"]) < 0.05 and abs(q[part]["ssim"] - jq[part]["ssim"]) < 5e-3


@pytest.mark.parametrize("method", ["registration", "registration_group"])
def test_classical_registration_methods_match_jax(tmp_path, method, capsys, monkeypatch):
    """The CLI on a 4-D volume (the (x, y, t) slice at z), file against
    file; the solvers at SMALL's stages in both packages (their defaults
    take minutes on a CPU)."""
    for mod in (J, R):
        for name in ("motion_compensated_upsample", "group_motion_upsample"):
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **SMALL))
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((16, 12, 3, 7), seed=4) * 3.0, path)
    out, jout = str(tmp_path / "port.nii.gz"), str(tmp_path / "jax.nii.gz")
    got = classical.main([path, "--out", out, "--device", "cpu", "--method", method, "--slice_z", "1"])
    jclassical.main([path, "--out", jout, "--method", method, "--slice_z", "1"])
    assert "wrote" in capsys.readouterr().out
    port_file, jax_file = nifti.load(out).get_fdata(np.float32), nifti.load(jout).get_fdata(np.float32)
    assert port_file.shape == jax_file.shape == (16, 12, 7)
    np.testing.assert_array_equal(port_file, got)
    np.testing.assert_allclose(port_file, jax_file, rtol=0, atol=1e-4)
    src = classical.temporal_upsample_classical(got[..., ::2], 7, method=method, device="cpu")
    np.testing.assert_array_equal(src[..., ::2], got[..., ::2])


def test_adam_amplifies_rounding_in_jax_itself():
    """Why the whole-run tolerance is lr where the problem is ill
    conditioned: JAX's own non-uniform group registration, its second stage
    started from its first stage's fields perturbed by 4e-7 (about the
    port's first-stage difference), ends 3e-4 away (of fields up to 0.10),
    some 700 times the perturbation, yet within lr."""
    even = _moving(5)
    stack = np.moveaxis(even, -1, 0)
    dt = np.diff(np.asarray((0.0, 0.2, 0.5, 0.6, 1.0), np.float32))
    rel_dt = jnp.asarray(dt / dt.mean())
    frames = jnp.stack([J._resize_frame(jnp.asarray(stack[k]), 2) for k in range(5)])
    first, _ = J._register_group_stage(frames, jnp.zeros((5, 4, 4, 2)), jnp.float32(LR), jnp.float32(1e-2),
                                       jnp.float32(1e-1), 20, rel_dt)
    noise = 4e-7 * np.random.default_rng(1).standard_normal(first.shape).astype(np.float32)
    ends = []
    for start in (first, first + noise):
        ctrl = jax.image.resize(start, (5, 8, 8, 2), "linear")
        ends.append(np.asarray(J._register_group_stage(jnp.asarray(stack), ctrl, jnp.float32(LR), jnp.float32(1e-2),
                                                       jnp.float32(1e-1), 20, rel_dt)[0]))
    moved = float(np.abs(ends[1] - ends[0]).max())
    assert 1e-4 < moved < LR, moved
