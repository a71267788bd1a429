"""Port parity: the motion-compensated warp INR (``make_warp_inr``) and the
coordinate gradient of the hash encoding it needs
(``ops.hash_encode.hash_encode_coord_grad`` through ``HashEncode``), against
the JAX package, with the same parameters moved over by
``convert.params_from_jax``. Inputs come from numpy seeds; the port runs the
hash-encode kernels' plain versions on the CPU.

Tolerances and their reasons:

- the coordinate gradient: within 1e-5 of the largest reference value (sums
  of 2^d weighted corner terms times the resolution, taken in another
  order); exactly zero on the levels JAX's packed path leaves without one;
- forwards and the warp and residual fields: within 1e-5 of the largest
  value; parameter and coordinate gradients per leaf within 1e-4 of the
  leaf's largest (the chain through a sine at warp_w0 and the encoder's
  resolution);
- loss curves, 10 steps from one init with ``shuffle=False``: rtol 1e-4;
- launchers from one init: PSNR within 0.05 dB and SSIM within 5e-3, the
  whole volume's and the held-out odd frames'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu import launcher as jlauncher
from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu.models import warp as jwarp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu.train import save_checkpoint as jax_save_checkpoint
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.io import dataset_from_array, even_frame_training_set, nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import make_warp_inr
from mri_interpolation_tpu_torch.models.warp import clip_balanced
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, save_checkpoint

SHAPE = (16, 16, 8)
# the warp encoder at a small size: 2-D, dense levels x F = 4, paper growth
SMALL = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=16, base_resolution=(4, 4),
             finest_resolution=(16, 16), dim_hidden=16, warp_hidden=16)
# geometries for the coordinate gradient: cell-view levels, and one that JAX's packed path takes (a dense
# level of 599 x 599 cells, over 2^18; a hashed level)
GEOMETRIES = {
    "warp_2d": dict(dim=2, n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(8, 8),
                    finest_resolution=(40, 40), growth="paper"),
    "big_dense": dict(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=19, base_resolution=8,
                      finest_resolution=600, growth="paper"),
    "hashed": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
                   finest_resolution=32, growth="paper"),
}


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_coordinate_gradient_matches_jax(name):
    """``jax.grad`` of ``HashGridEncoding.apply`` in x against
    ``HashEncode``'s backward, the boundary and a point outside [0, 1]
    included; the table gradient beside it is kernel 2's plain version."""
    kw = GEOMETRIES[name]
    jenc, enc = JaxHashGrid(**kw), HashGridEncoding(**kw)
    np.testing.assert_array_equal(enc.level_cellview, jenc.level_cellview)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (enc.total_size, enc.n_features_per_level)).astype(np.float32)
    x = rng.uniform(0, 1, (200, enc.input_dim)).astype(np.float32)
    x[0], x[1], x[2] = 0.0, 1.0, 1.05
    g = rng.normal(size=(200, enc.output_dim)).astype(np.float32)
    want = jax.jit(jax.grad(lambda xv: jnp.sum(jenc.apply({"table": jnp.asarray(table)}, xv) * g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    (he.HashEncode.apply(tt, xt, enc) * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), want, 1e-5, name)
    np.testing.assert_array_equal(tt.grad.numpy(), he.hash_encode_table_grad_reference(
        enc, torch.from_numpy(x), torch.from_numpy(g)).numpy())
    # the levels JAX's packed path takes contribute exactly zero
    packed = [l for l in range(enc.n_levels) if not enc.level_cellview[l]]
    if packed:
        only = np.zeros_like(g).reshape(200, enc.n_levels, -1)
        only[:, packed] = g.reshape(200, enc.n_levels, -1)[:, packed]
        dx = he.hash_encode_coord_grad(enc, torch.from_numpy(table), torch.from_numpy(x),
                                       torch.from_numpy(only.reshape(200, -1)))
        assert float(dx.abs().max()) == 0.0
    assert name != "big_dense" or enc.level_cellview.tolist() == [True, True, False]


def test_coordinate_gradient_is_not_asked_for_data():
    """Coordinates that need no gradient get none: the HashMLP's path is
    unchanged."""
    enc = HashGridEncoding(**GEOMETRIES["warp_2d"])
    table = torch.rand((enc.total_size, 4), requires_grad=True)
    x = torch.rand((10, 2))
    he.HashEncode.apply(table, x, enc).sum().backward()
    assert x.grad is None and table.grad is not None


def test_clip_splits_ties_as_jax():
    v = np.array([-0.2, 0.0, 0.5, 1.0, 1.3], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_()
    clip_balanced(vt, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vt.grad.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])


def _pair(seed=0, dim_in=3, **extra):
    kw = {**SMALL, **extra}
    if dim_in == 4:
        kw.update(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 6))
    jm = jwarp.make_warp_inr(dim_in=dim_in, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params["encoder"]["table"] = rng.uniform(-0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    # a deformation that is not the identity: the zero-initialised last layers drawn small
    for field in ("warp", "residual"):
        for layer in params.get(field, [])[-1:]:
            layer["w"] = rng.uniform(-0.5, 0.5, layer["w"].shape).astype(np.float32)
    tm = make_warp_inr(dim_in, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


@pytest.mark.parametrize("dim_in", [3, 4], ids=["2d+t", "3d+t"])
def test_forward_fields_and_gradients_match_jax(dim_in):
    """The forward (residual and a mid-ramp level anneal on, time scaled),
    the warp and residual fields (the JAX ``hparams`` entries) and every
    parameter's and the coordinates' gradient."""
    extra = dict(residual_scale=0.05, residual_w0=2.0, level_anneal_steps=4, warp_t_scale=0.5)
    jm, params, state, tm = _pair(1, dim_in, **extra)
    state = {"anneal_step": jnp.asarray(2, jnp.int32)}
    tm.anneal_step.fill_(2)
    x = np.random.default_rng(2).uniform(0, 1, (128, dim_in)).astype(np.float32)
    x[:4, 0] = [0.0, 1.0, 0.0, 1.0]
    g = np.random.default_rng(3).normal(size=(128, 1)).astype(np.float32)
    tm.eval()
    xt = torch.from_numpy(x)
    want, _ = jax.jit(jm.apply, static_argnames=("train",))(params, state, jnp.asarray(x), train=False)
    _close(tm(xt).detach().numpy(), want, 1e-5, "forward")
    _close(tm.warp_field(xt).detach().numpy(), jm.hparams["warp_field"](params, jnp.asarray(x)), 1e-5, "warp field")
    _close(tm.residual_field(xt).detach().numpy(), jm.hparams["residual_field"](params, jnp.asarray(x)), 1e-5,
           "residual field")

    def loss(p, xv):
        return jnp.sum(jm.apply(p, state, xv, train=False)[0] * g)

    jp, jx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xg = xt.clone().requires_grad_()
    (tm(xg) * torch.from_numpy(g)).sum().backward()
    _close(xg.grad.numpy(), jx, 1e-4, "coordinates")
    want_p = params_from_jax(jax.device_get(jp))
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), want_p[n].numpy(), 1e-4, n)


def test_boundary_ties_at_the_identity_warp():
    """At init d is 0, so grid points on x = 0 or 1 sit on the clip's ties:
    the coordinates' and the warp field's gradients take half of the
    encoder's there, as in JAX (``torch.clamp`` would give all of it)."""
    kw = dict(SMALL)
    jm = jwarp.make_warp_inr(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(4)))
    params["encoder"]["table"] = np.random.default_rng(4).uniform(
        -0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    tm = make_warp_inr(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    pts = np.array([[0, 0, 0.2], [1, 1, 0.7], [0, 1, 0.4], [1, 0.3, 0.9], [0.6, 0, 0.1]], np.float32)
    jp, jx = jax.jit(jax.grad(lambda p, xv: jnp.sum(jm.apply(p, state, xv)[0]), argnums=(0, 1)))(
        params, jnp.asarray(pts))
    xt = torch.from_numpy(pts).requires_grad_()
    tm(xt).sum().backward()
    _close(xt.grad.numpy(), jx, 1e-5, "coordinates at the bounds")
    last = f"warp.{len(params['warp']) - 1}.w"
    want = params_from_jax(jax.device_get(jp))[last].numpy()
    assert np.abs(want).max() > 0
    _close(tm.get_parameter(last).grad.numpy(), want, 1e-5, last)
    # the coordinate gradient on a bound axis is half the encoder's own
    enc_dx = torch.from_numpy(pts[:, :2]).requires_grad_()
    z = tm.encoder(enc_dx)
    for layer in tm.layers[:-1]:
        z = torch.relu(layer(z))
    tm.layers[-1](z).sum().backward()
    on_bound = (pts[:, :2] == 0) | (pts[:, :2] == 1)
    np.testing.assert_allclose(xt.grad.numpy()[:, :2][on_bound], 0.5 * enc_dx.grad.numpy()[on_bound], rtol=1e-6)


@pytest.mark.parametrize("prior", ["warp_smooth", "warp_accel", "residual_accel", "anneal"])
def test_loss_curves_match_jax(prior, monkeypatch):
    """Ten steps of ``Trainer.fit`` through the model's ``loss`` (MSE plus
    the prior; ``warp_smooth`` by the exact jvp, the route that
    ``MRI_TPU_WARP_JVP=1`` forces in JAX), from one init; the anneal's
    counter ends at 10 in both."""
    monkeypatch.setenv("MRI_TPU_WARP_JVP", "1")
    extra = {"warp_smooth": dict(warp_smooth=0.1), "warp_accel": dict(warp_accel=1.0),
             "residual_accel": dict(residual_scale=0.05, residual_accel=1.0),
             "anneal": dict(level_anneal_steps=5, residual_scale=0.05)}[prior]
    jm, params, state, tm = _pair(5, **extra)
    assert (tm.loss is not None) == (jm.loss_fn is not None) == (prior != "anneal")
    ds = dataset_from_array(synthetic_volume((8, 8, 5), seed=6))
    cfg = dict(batch_size=32, epochs=1, lr=1e-2, optimizer="adam_tcnn", shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords[:320], ds.values[:320], params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords[:320], ds.values[:320], device="cpu")
    assert tres.steps == jres.steps == 10
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-4)
    if prior == "anneal":
        assert int(tm.anneal_step) == int(jres.state["anneal_step"]) == 10


def test_warp_smooth_is_the_jacobian_of_the_field():
    """The jvp prior equals the mean squared spatial Jacobian columns of d,
    by central differences of the field in float64."""
    _, _, _, tm = _pair(7, warp_smooth=1.0)
    tm.double()
    x = torch.from_numpy(np.random.default_rng(8).uniform(0.1, 0.9, (64, 3)))
    y = torch.zeros((64, 1), dtype=torch.float64)
    with torch.no_grad():
        mse = torch.mean((tm(x) - y) ** 2)
        reg, eps = 0.0, 1e-6
        for k in range(2):
            e = torch.zeros_like(x)
            e[:, k] = eps
            reg += float(torch.mean(((tm.warp_field(x + e) - tm.warp_field(x - e)) / (2 * eps)) ** 2))
    assert float(tm.loss(x, y) - mse) == pytest.approx(reg, rel=1e-6)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vol") / "synthetic_16x16x8.nii.gz")
    nifti.save(synthetic_volume(SHAPE, seed=7), path)
    return path


def test_warp_even_frames_through_both_launchers(volume, tmp_path):
    """``--model_class warp_inr --even_frames_only`` through both launchers
    from one init, 20 one-batch epochs on (16, 16, 8): the spatial
    resolutions derived from the volume's (16, 16) frames, PSNR and SSIM of
    the whole volume and of the held-out odd frames."""
    run = dict(model_class="warp_inr", n_levels=3, n_features_per_level=4, log2_hashmap_size=16, growth="paper",
               dim_hidden=16, warp_hidden=16, residual_scale=0.05, optimizer="adam_tcnn", lr=1e-2,
               lr_schedule="cosine", cosine_t_max=20, weight_decay=1e-5, epochs=20, batch_size=16 * 16 * 4,
               even_frames_only=True, save_checkpoint=False, interp_shapes=((16, 16, 16),))
    kw = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=16, base_resolution=(3, 3),
              finest_resolution=(16, 16), dim_hidden=16, warp_hidden=16, residual_scale=0.05)
    jm = jwarp.make_warp_inr(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    tm = make_warp_inr(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    jax_ckpt, port_ckpt = str(tmp_path / "jax_init"), str(tmp_path / "port_init")
    jax_save_checkpoint(jax_ckpt, 0, params, state)
    save_checkpoint(port_ckpt, 0, tm.state_dict())
    want = jlauncher.run(jconfigs.RunConfig(image_path=volume, **run, checkpoint_path=jax_ckpt,
                                            output_root=str(tmp_path / "jax")))
    got = launcher.run(RunConfig(image_path=volume, **run, checkpoint_path=port_ckpt,
                                 output_root=str(tmp_path / "port")), device="cpu")
    assert got["steps"] == want["steps"] == 20 and got["model"] == "warp_inr"
    for key in ("psnr", "odd_psnr"):
        assert abs(got[key] - want[key]) < 0.05, key
    for key in ("ssim", "odd_ssim"):
        assert abs(got[key] - want[key]) < 5e-3, key
    with open(os.path.join(got["run_dir"], "config.txt")) as f:
        text = f.read()
    assert "base_resolution : (3, 3)" in text and "finest_resolution : (16, 16)" in text


def test_warp_resolution_branch_keeps_matching_tuples(volume, tmp_path):
    """Tuples of the spatial rank are kept as given; the time axis never
    enters the canonical encoder."""
    cfg = RunConfig(image_path=volume, output_root=str(tmp_path), model_class="warp_inr", base_resolution=(4, 4),
                    finest_resolution=(12, 12), n_levels=2, n_features_per_level=2, dim_hidden=8, warp_hidden=8,
                    epochs=1, batch_size=1024, interp_shapes=(), save_checkpoint=False)
    got = launcher.run(cfg, device="cpu")
    with open(os.path.join(got["run_dir"], "config.txt")) as f:
        text = f.read()
    assert "base_resolution : (4, 4)" in text and "finest_resolution : (12, 12)" in text
    assert got["steps"] == 2


def test_warp_even_frame_fit_has_held_out_frames():
    coords, values = even_frame_training_set(synthetic_volume(SHAPE, seed=1))
    model = make_warp_inr(3, device="cpu", **SMALL)
    res = Trainer(TrainConfig(batch_size=256, epochs=1)).fit(model, coords, values, device="cpu")
    assert res.steps == len(values) // 256 and np.isfinite(res.losses).all()
