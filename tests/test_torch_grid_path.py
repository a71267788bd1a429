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

import contextlib
import types

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


# ---------------------------------------------------------------------------
# the fused_grid route: one op call a chunk (hash_mlp_grid_forward), on the CPU its plain version

# relu_plain HashMLPs whose encoder the separable route does not take: (dim_in, factory keywords)
FUSED = {
    "3d_hashed_level": (3, {**PROTOCOL, "log2_hashmap_size": 8}),
    "3d_all_hashed": (3, {**PROTOCOL, "storage": "hashed", "log2_hashmap_size": 9}),
    "4d": (4, dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=10, base_resolution=(4, 4, 2, 2),
                   finest_resolution=(16, 16, 4, 6), growth="paper", dim_hidden=16, decoder="relu_plain")),
}
# grid shape, lo, hi, chunk size: each with a padded tail
FUSED_GRIDS = {
    "3d_hashed_level": [((9, 10, 11), 0.0, 1.0, 128), ((7, 1, 5), -1.0, 1.0, 16)],
    "3d_all_hashed": [((6, 5, 4), -1.0, 1.0, 50)],
    "4d": [((5, 4, 3, 6), -1.0, 1.0, 100), ((3, 5, 1, 7), 0.0, 1.0, 1 << 17), ((2, 3, 4, 5), 0.25, 0.5, 7)],
}


def _fused_model(name, seed=0):
    dim, kw = FUSED[name]
    model = make_hash_mlp(dim, seed=seed, device="cpu", **kw)
    with torch.no_grad():
        model.encoder.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("name, grid", [(n, g) for n in sorted(FUSED) for g in FUSED_GRIDS[n]])
def test_fused_grid_op_equals_the_chunked_route(name, grid):
    """The op's CPU impl gives the chunked route's volume bit for bit (an
    identity ``transform`` sends the same grid down the chunked route): 3-D
    and 4-D grids, a padded tail, [-1, 1], an axis of one voxel, hashed
    levels, one chunk for the whole grid."""
    from mri_interpolation_tpu_torch.infer import ROUTES, reset_routes

    shape, lo, hi, chunk = grid
    model = _fused_model(name)
    reset_routes()
    fused = evaluate_grid(model, shape, lo=lo, hi=hi, chunk_size=chunk, device="cpu")
    chunked = evaluate_grid(model, shape, lo=lo, hi=hi, chunk_size=chunk, device="cpu", transform=lambda x: x)
    assert ROUTES == {"separable": 0, "fused_grid": 1, "chunked": 1}
    assert fused.shape == shape and np.isfinite(fused).all() and np.abs(fused).max() > 0
    assert np.array_equal(fused, chunked)


def test_fused_grid_op_writes_one_chunk_in_place():
    """One call writes rows start, ..., start + len(scratch) - 1 of ``out``
    (the voxels past the last repeat it) and the encoder's features into
    ``scratch``, and touches no other row."""
    from mri_interpolation_tpu_torch.ops.hash_mlp_grid import grid_forward
    from mri_interpolation_tpu_torch.ops import fused_mlp as fm

    model = _fused_model("4d")
    shape, n = (3, 5, 2, 7), 210
    enc = model.encoder.geometry
    params = [t.detach() for layer in model.layers for t in (layer.w, layer.b)]
    scratch, out = torch.zeros((64, enc.output_dim)), torch.full((256, 1), 7.0)
    with torch.no_grad():
        grid_forward(model.encoder.table.detach(), params, list(fm.act_words(fm.mlp_acts(1, "relu"))),
                     list(enc.geometry_key()), list(shape), -1.0, 1.0, 192, scratch, out)
        x = flat_index_to_coords(torch.arange(192, 256).clamp_(max=n - 1), shape, -1.0, 1.0)
        assert torch.equal(scratch, model.encode(x))
        assert torch.equal(out[192:], model(x))
    assert torch.equal(out[:192], torch.full((192, 1), 7.0))
    assert torch.equal(out[n - 1:].unique(), out[n - 1])


def _route_case(case):
    """(model, evaluate_grid keywords, grid shape) of a route-counter case."""
    if case == "frame_idx":
        model = make_multi_hash_mlp(dim_in=2, n_frames=2, n_levels=2, log2_hashmap_size=6, dim_hidden=8,
                                    device="cpu")
        return model, {"frame_idx": 1}, (6, 5)
    kw = {**PROTOCOL, "log2_hashmap_size": 8}
    extra = {"norm": {"decoder": "norm"}, "norm_proper": {"decoder": "norm_proper"},
             "anneal": {"level_anneal_steps": 8}, "all_dense": {"log2_hashmap_size": 23}}.get(case, {})
    model = make_hash_mlp(3, device="cpu", **{**kw, **extra})
    options = {"transform": {"transform": lambda x: x}, "return_latents": {"return_latents": True}}.get(case, {})
    return model, options, (6, 5, 4)


@pytest.mark.parametrize("case, route", [
    ("fused", "fused_grid"), ("norm", "chunked"), ("norm_proper", "chunked"), ("anneal", "chunked"),
    ("transform", "chunked"), ("frame_idx", "chunked"), ("return_latents", "chunked"), ("all_dense", "separable")])
def test_routes_count_the_route_a_request_takes(case, route):
    """``ROUTES`` counts each request once, under its route: a relu_plain
    HashMLP with a hashed level takes ``fused_grid``; a norm decoder, a level
    anneal, a ``transform``, a frame index (the multi-frame model has no
    split), ``return_latents`` do not; an all-dense encoder on [0, 1] takes
    the separable route."""
    from mri_interpolation_tpu_torch.infer import ROUTES, reset_routes

    model, options, shape = _route_case(case)
    reset_routes()
    out = evaluate_grid(model, shape, chunk_size=32, device="cpu", **options)
    vol = out[0] if case == "return_latents" else out
    assert vol.shape == shape and np.isfinite(vol).all()
    assert ROUTES == {**{name: 0 for name in ROUTES}, route: 1}


def test_device_eval_seconds_takes_the_fused_grid_route():
    from mri_interpolation_tpu_torch.infer import ROUTES, reset_routes

    model = _fused_model("3d_hashed_level")
    reset_routes()
    assert device_eval_seconds(model, (9, 10, 11), chunk_size=256, iters=2, device="cpu") > 0
    assert ROUTES == {"separable": 0, "fused_grid": 3, "chunked": 0}


@pytest.mark.parametrize("lo, hi, chunk_size", [(0.0, 1.0, 128), (-1.0, 1.0, 1 << 17), (0.25, 0.5, 77)])
def test_fused_grid_matches_jax(lo, hi, chunk_size):
    """A relu_plain HashMLP with a hashed level, on the fused_grid route,
    against the JAX package's ``evaluate_grid``: atol 1e-5, as the separable
    route's parity."""
    from mri_interpolation_tpu_torch.infer import ROUTES, reset_routes

    jm, params, state, tm = _pair({**PROTOCOL, "log2_hashmap_size": 8}, seed=4)
    assert not tm.encoder.geometry.supports_grid_path()
    shape = (9, 10, 11)
    want = np.asarray(jax_evaluate_grid(jm, params, state, shape, lo=lo, hi=hi, chunk_size=chunk_size))
    reset_routes()
    got = evaluate_grid(tm, shape, lo=lo, hi=hi, chunk_size=chunk_size, device="cpu")
    assert ROUTES["fused_grid"] == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the volume's transfer to host memory: pinned slab by slab on the card, pageable otherwise

@pytest.mark.parametrize("case", ["f32", "u16", "return_latents"])
def test_transfers_count_pageable_once_a_request_on_the_cpu(case):
    """``TRANSFERS`` counts each request once: on the CPU device every
    request, ``u16`` and ``return_latents`` included, is ``pageable``."""
    from mri_interpolation_tpu_torch.infer import TRANSFERS, reset_transfers

    model = make_hash_mlp(3, device="cpu", **{**PROTOCOL, "log2_hashmap_size": 8})
    options = {"u16": {"transport": "u16"}, "return_latents": {"return_latents": True}}.get(case, {})
    reset_transfers()
    for _ in range(2):
        evaluate_grid(model, (6, 5, 4), chunk_size=32, device="cpu", **options)
    assert TRANSFERS == {"pinned": 0, "pageable": 2}


def test_reset_transfers_zeroes_the_counter():
    from mri_interpolation_tpu_torch.infer import TRANSFERS, reset_transfers

    evaluate_grid(_fused_model("3d_all_hashed"), (6, 5, 4), chunk_size=32, device="cpu")
    assert TRANSFERS["pageable"] > 0
    reset_transfers()
    assert TRANSFERS == {"pinned": 0, "pageable": 0}


class _InOrderStream:
    """A copy stream on the CPU: each copy runs when it is issued; counts the
    slabs by their events."""

    def __init__(self):
        self.slabs = 0

    def wait_stream(self, stream):
        pass

    def record_event(self):
        self.slabs += 1
        return types.SimpleNamespace(synchronize=lambda: None)


# (route, grid shape, chunk size, chunks a slab): padded tails, chunk counts that are not a multiple of the slab, one
# chunk for the whole grid, one chunk a slab
SLAB_CASES = [
    ("fused_grid", (9, 10, 11), 128, 3), ("fused_grid", (9, 10, 11), 128, 1), ("fused_grid", (5, 4, 3), 1 << 17, 4),
    ("separable", (9, 10, 11), 100, 4), ("separable", (7, 3, 2), 50, 1),
    ("chunked", (6, 5, 4), 32, 2), ("chunked", (6, 5, 4), 7, 5),
]


@pytest.mark.parametrize("route, shape, chunk, per_slab", SLAB_CASES)
def test_pinned_volume_copies_every_row_once_slab_by_slab(monkeypatch, route, shape, chunk, per_slab):
    """The slab bookkeeping of the pinned transfer, on the CPU with a stream
    that copies at once: the destination equals the device-side volume bit
    for bit, no row left unwritten, one slab a ``per_slab`` chunks and one
    for the rest. ``chunked`` runs a decoder of 2 outputs."""
    from mri_interpolation_tpu_torch.infer import ROUTES, reset_routes
    from mri_interpolation_tpu_torch.infer import grid as g

    if route == "fused_grid":
        model = _fused_model("3d_hashed_level")
    elif route == "separable":
        model = make_hash_mlp(3, device="cpu", **PROTOCOL)
    else:
        model = make_hash_mlp(3, device="cpu", **{**PROTOCOL, "log2_hashmap_size": 8, "decoder": "norm", "dim_out": 2})
    n = int(np.prod(shape))
    dim_out = model.dim_out
    monkeypatch.setattr(g, "_SLAB_BYTES", per_slab * min(chunk, n) * dim_out * 4)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    stream = _InOrderStream()
    host = g._PinnedVolume(torch.full((n, dim_out), float("nan")), chunk, stream)
    args = (model, shape, 0.0, 1.0, chunk, torch.device("cpu"), None, None, False)
    reset_routes()
    with torch.no_grad():
        want = g._grid_on_device(*args)[0]
        g._grid_on_device(*args, host)
    assert ROUTES[route] == 2
    got = host.volume()
    assert got.shape == (n, dim_out) and not np.isnan(got).any() and np.array_equal(got, want.numpy())
    assert stream.slabs == -(-(-(-n // chunk)) // per_slab)
