"""Port parity: the separable grid path (``HashGridEncoding.apply_grid``,
``supports_grid_path``) and ``infer.evaluate_grid``'s dispatch and options
(``return_latents``, ``transport="u16"``, ``transform``,
``device_eval_seconds``) of ``mri_interpolation_tpu_torch`` against the JAX
package, with the same parameters moved over by ``convert.params_from_jax``.
Inputs are made with numpy from a seed.

Tolerances and their reasons:

- ``apply_grid`` against JAX's and against the port's own per-point encode:
  atol 1e-6, the JAX tests' bound between its ``apply_grid`` and ``apply``
  (float32 lerps in another order than the per-point corner sum);
- ``evaluate_grid`` on the separable path against JAX's, relu_plain HashMLP:
  atol 1e-5 (the features to 1e-6 through a 16-wide ReLU decoder whose
  float32 sums run in another order); the mid-ramp anneal likewise;
- raw latents: atol 1e-6, as ``apply_grid``;
- u16: within one step, (max - min) / 65535, of the f32 volume (and of
  JAX's u16 volume, plus the f32 bound above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGridEncoding
from mri_interpolation_tpu.infer import evaluate_grid as jax_evaluate_grid
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import device_eval_seconds, evaluate_grid, flat_index_to_coords
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_hash_siren, make_multi_hash_mlp
from mri_interpolation_tpu_torch.ops import hash_encode as he

ATOL = 1e-5
GEOMETRIES = {
    # the flagship's shape at a small size: 4 dense levels x F=1, reference growth
    "flagship_small": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                           base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8)),
    # ngp's: 3 dense levels x F=8, paper growth
    "ngp_small": dict(dim=3, n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(4, 4, 2),
                      finest_resolution=(16, 16, 8), growth="paper"),
    "d2": dict(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=12, base_resolution=(3, 2),
               finest_resolution=(17, 9)),
}
SHAPES = {"flagship_small": (9, 10, 11), "ngp_small": (23, 31, 17), "d2": (7, 12)}
# the protocol model's shape at a small size: 4 dense levels x F=4, paper growth, relu_plain
PROTOCOL = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(4, 4, 2),
                finest_resolution=(16, 16, 8), growth="paper", dim_hidden=16, n_layers=2, decoder="relu_plain")


def _table(enc, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (enc.total_size, enc.n_features_per_level)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_apply_grid_matches_jax(name):
    cfg, shape = GEOMETRIES[name], SHAPES[name]
    enc, jenc = HashGridEncoding(**cfg), JaxHashGridEncoding(**cfg)
    assert enc.supports_grid_path() and jenc.supports_grid_path()
    table = _table(enc)
    got = enc.apply_grid(torch.from_numpy(table), shape).numpy()
    want = np.asarray(jenc.apply_grid({"table": jnp.asarray(table)}, shape))
    assert got.shape == (int(np.prod(shape)), enc.output_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_apply_grid_matches_the_per_point_encode(name):
    """Row r of ``apply_grid`` is the encoding of row r of
    ``flat_index_to_coords``: the dense rows of each level are its C-ordered
    ``(verts..., F)`` grid, with the strides ``vertex_strides`` gives."""
    cfg, shape = GEOMETRIES[name], SHAPES[name]
    enc = HashGridEncoding(**cfg)
    for l in range(enc.n_levels):
        verts = enc.level_resolutions[l].astype(np.int64) + 1
        np.testing.assert_array_equal(enc.vertex_strides(l), np.array(np.zeros(verts).strides) // 8)
    table = torch.from_numpy(_table(enc, seed=1))
    x = flat_index_to_coords(torch.arange(int(np.prod(shape))), shape)
    np.testing.assert_allclose(enc.apply_grid(table, shape).numpy(),
                               he.hash_encode_reference(enc, table, x).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(dim=3, n_levels=2, n_features_per_level=1, log2_hashmap_size=6, base_resolution=4, finest_resolution=32,
         storage="hashed"),
    dict(dim=3, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
         finest_resolution=None, per_level_scale=1.4),  # hash_siren's encoder: levels 0-3 dense, 4-9 hashed
    dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
         finest_resolution=None, per_level_scale=1.4),
    GEOMETRIES["flagship_small"], GEOMETRIES["ngp_small"],
], ids=["hashed", "hash_siren", "tcnn", "flagship_small", "ngp_small"])
def test_supports_grid_path_matches_jax(cfg):
    enc = HashGridEncoding(**cfg)
    assert enc.supports_grid_path() == JaxHashGridEncoding(**cfg).supports_grid_path()
    if not enc.supports_grid_path():
        with pytest.raises(ValueError, match="dense"):
            enc.apply_grid(enc.init(), (4, 4, 4))


def test_apply_grid_rejects_a_grid_of_another_rank():
    enc = HashGridEncoding(**GEOMETRIES["d2"])
    with pytest.raises(ValueError, match="rank"):
        enc.apply_grid(enc.init(), (4, 4, 4))


def _pair(kw=PROTOCOL, seed=0, anneal_step=None):
    jm = jax_make_hash_mlp(dim_in=3, fused="off", **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    shape = params["encoder"]["table"].shape
    params["encoder"]["table"] = np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)
    if anneal_step is not None:
        state = dict(state, anneal_step=np.asarray(anneal_step, np.int32))
    tm = make_hash_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


@pytest.fixture
def apply_grid_calls(monkeypatch):
    """The number of ``apply_grid`` calls, i.e. of separable evaluations."""
    calls = []
    original = HashGridEncoding.apply_grid

    def counted(self, *args, **kwargs):
        calls.append(1)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(HashGridEncoding, "apply_grid", counted)
    return calls


@pytest.mark.parametrize("chunk_size", [1 << 17, 128])
def test_fast_path_matches_jax(apply_grid_calls, chunk_size):
    """One chunk, and several with a padded tail."""
    jm, params, state, tm = _pair()
    shape = (9, 10, 11)
    want = np.asarray(jax_evaluate_grid(jm, params, state, shape, chunk_size=chunk_size))
    got = evaluate_grid(tm, shape, chunk_size=chunk_size, device="cpu")
    assert apply_grid_calls == [1] and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("step", [0, 2, 5])
def test_fast_path_matches_jax_mid_ramp(apply_grid_calls, step):
    """The port of the JAX ``test_grid_fast_path_matches_apply_mid_ramp``:
    a model with an 8-step level anneal, evaluated at counter ``step``; the
    decoder sees the curriculum-weighted features on the separable path as
    in the model's own forward."""
    jm, params, state, tm = _pair({**PROTOCOL, "level_anneal_steps": 8}, seed=1, anneal_step=step)
    shape = (12, 12, 6)
    want = np.asarray(jax_evaluate_grid(jm, params, state, shape, chunk_size=256))
    got = evaluate_grid(tm, shape, chunk_size=256, device="cpu")
    assert apply_grid_calls == [1]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    with torch.no_grad():
        direct = tm.eval()(flat_index_to_coords(torch.arange(12 * 12 * 6), shape)).numpy()
    np.testing.assert_allclose(got.reshape(-1, 1), direct, rtol=0, atol=ATOL)
    assert int(tm.anneal_step) == step  # evaluation does not advance the counter


@pytest.mark.parametrize("fast", [True, False])
def test_return_latents_match_jax(apply_grid_calls, fast):
    """Raw (unweighted) encoder features beside the volume, on the separable
    path (hi = 1) and the per-chunk path (hi = 0.5), mid-ramp."""
    jm, params, state, tm = _pair({**PROTOCOL, "level_anneal_steps": 8}, anneal_step=3)
    shape, hi = (8, 6, 5), (1.0 if fast else 0.5)
    jvol, jlat = jax_evaluate_grid(jm, params, state, shape, hi=hi, chunk_size=64, return_latents=True)
    vol, lat = evaluate_grid(tm, shape, hi=hi, chunk_size=64, device="cpu", return_latents=True)
    assert apply_grid_calls == ([1] if fast else [])
    assert lat.shape == shape + (16,) and vol.shape == shape
    np.testing.assert_allclose(vol, np.asarray(jvol), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lat, np.asarray(jlat), rtol=0, atol=1e-6)
    x = flat_index_to_coords(torch.arange(int(np.prod(shape))), shape, hi=hi)
    np.testing.assert_allclose(lat.reshape(-1, 16), tm.encode(x).detach().numpy(), rtol=0, atol=1e-6)


def test_u16_transport(apply_grid_calls):
    """u16 within one step of the range of the f32 volume, and of JAX's u16
    volume (plus the f32 parity bound); latents still come back in f32."""
    jm, params, state, tm = _pair(seed=2)
    shape = (9, 10, 11)
    f32 = evaluate_grid(tm, shape, device="cpu")
    u16, lat = evaluate_grid(tm, shape, device="cpu", transport="u16", return_latents=True)
    step = (f32.max() - f32.min()) / 65535.0
    assert u16.dtype == np.float32 and lat.dtype == np.float32
    assert np.abs(u16 - f32).max() <= step + 1e-7
    assert np.abs(u16 - f32).max() > 0  # quantised: not the f32 volume
    want = np.asarray(jax_evaluate_grid(jm, params, state, shape, transport="u16"))
    assert np.abs(u16 - want).max() <= step + ATOL
    assert u16.min() == pytest.approx(f32.min(), abs=1e-7) and u16.max() == pytest.approx(f32.max(), abs=step)


def test_u16_codes_round_half_to_even():
    """The quantiser rounds as ``jnp.round``: halves to even."""
    from mri_interpolation_tpu_torch.infer.grid import _quantise_u16

    y = torch.tensor([[0.0], [0.5], [1.5], [2.5], [65535.0]])
    q, vlo, vhi = _quantise_u16(y)
    codes = q.numpy().astype(np.int32) + 32768
    want = np.asarray(jnp.round((jnp.asarray(y.numpy()) - 0.0) * (65535.0 / (65535.0 + 1e-12))).astype(jnp.uint16))
    np.testing.assert_array_equal(codes, want.astype(np.int32))
    assert codes[:, 0].tolist() == [0, 0, 2, 2, 65535] and float(vlo) == 0.0 and float(vhi) == 65535.0


def test_transform_turns_the_fast_path_off(apply_grid_calls):
    """A transform is applied to each chunk's coordinates, as in JAX; the
    identity gives the separable path's volume through the per-point one."""
    jm, params, state, tm = _pair(seed=3)
    shape = (9, 10, 11)
    fast = evaluate_grid(tm, shape, chunk_size=256, device="cpu")
    same = evaluate_grid(tm, shape, chunk_size=256, device="cpu", transform=lambda x: x)
    assert apply_grid_calls == [1]
    np.testing.assert_allclose(same, fast, rtol=0, atol=ATOL)

    def remap(x):
        return x * 0.5

    want = np.asarray(jax_evaluate_grid(jm, params, state, shape, chunk_size=256, transform=remap))
    np.testing.assert_allclose(evaluate_grid(tm, shape, chunk_size=256, device="cpu", transform=remap), want,
                               rtol=0, atol=ATOL)
    assert apply_grid_calls == [1]


@pytest.mark.parametrize("case", ["all", "lo", "hi", "hashed", "no_split", "frame_idx"])
def test_dispatch_takes_the_separable_path_exactly_where_jax_does(apply_grid_calls, case):
    """Each condition of the JAX dispatch on both sides: the split model with
    an all-dense encoder on a [0, 1] grid takes it; lo = 0.25, hi = 0.5, a
    hashed level, a model with no split (hash_siren, the multi-frame
    HashMLP with its frame index) do not. ``transform`` has its own test."""
    kw, lo, hi = dict(PROTOCOL), 0.0, 1.0
    if case == "lo":
        lo = 0.25
    elif case == "hi":
        hi = 0.5
    elif case == "hashed":
        kw.update(log2_hashmap_size=8)
    if case == "no_split":
        model = make_hash_siren(3, dim_hidden=8, n_layers=2, n_levels=2, log2_hashmap_size=14, base_resolution=4,
                                per_level_scale=1.5, device="cpu")
        assert model.encoder.geometry.supports_grid_path()
    elif case == "frame_idx":
        model = make_multi_hash_mlp(dim_in=2, n_frames=2, n_levels=2, log2_hashmap_size=12, dim_hidden=8,
                                    device="cpu")
        assert model.geometry.supports_grid_path()
    else:
        jm, params, state, model = _pair(kw)
        assert model.encoder.geometry.supports_grid_path() == (case != "hashed")
        want = np.asarray(jax_evaluate_grid(jm, params, state, (6, 5, 4), lo=lo, hi=hi))
        np.testing.assert_allclose(evaluate_grid(model, (6, 5, 4), lo=lo, hi=hi, device="cpu"), want, rtol=0,
                                   atol=ATOL)
    shape = (6, 5) if case == "frame_idx" else (6, 5, 4)
    vol = evaluate_grid(model, shape, lo=lo, hi=hi, device="cpu", **({"frame_idx": 1} if case == "frame_idx" else {}))
    assert vol.shape == shape and np.isfinite(vol).all()
    assert apply_grid_calls == ([1, 1] if case == "all" else [])


def test_value_errors():
    """As in JAX: latents need the encode/decode split and no frame index;
    an unknown transport raises."""
    _, _, _, tm = _pair()
    siren_like = make_hash_siren(3, dim_hidden=8, n_layers=2, n_levels=2, log2_hashmap_size=10, device="cpu")
    with pytest.raises(ValueError, match="return_latents"):
        evaluate_grid(siren_like, (4, 4, 4), device="cpu", return_latents=True)
    with pytest.raises(ValueError, match="return_latents"):
        evaluate_grid(tm, (4, 4, 4), device="cpu", return_latents=True, frame_idx=0)
    with pytest.raises(ValueError, match="transport"):
        evaluate_grid(tm, (4, 4, 4), device="cpu", transport="f8")


def test_device_eval_seconds_runs_the_same_path(apply_grid_calls):
    """The separable path (a warm-up and three timed runs), and with a
    transform the per-chunk one."""
    _, _, _, tm = _pair()
    seconds = device_eval_seconds(tm, (9, 10, 11), iters=3, device="cpu")
    assert seconds > 0 and apply_grid_calls == [1] * 4
    assert device_eval_seconds(tm, (9, 10, 11), iters=2, device="cpu", transform=lambda x: x) > 0
    assert apply_grid_calls == [1] * 4
