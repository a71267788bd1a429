"""Port parity: the hash-grid geometry and the hash-encode forward / table
gradient of ``mri_interpolation_tpu_torch`` against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the Pallas kernels run in interpret mode (as tests/test_pallas.py
runs them) and against ``HashGridEncoding.apply``. The CUDA kernels themselves
have no CPU mode: their tests are in test_torch_kernels_gpu.py.

Tolerance: forward and table gradient atol 1e-6 (float32 sums of at most 2^d
products of magnitude <= 1, taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu.ops.pallas.hash_encode import pallas_hash_encode
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.encodings.hashgrid import LEVEL_CONST_WIDTH
from mri_interpolation_tpu_torch.ops import build
from mri_interpolation_tpu_torch.ops import hash_encode as he

CONFIGS = {
    # the flagship (__graft_entry__.py:_flagship): 4 dense levels, F=1, 156,258 rows
    "flagship": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                     base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15)),
    "hashed": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=10,
                   base_resolution=(8, 8, 4), finest_resolution=(33, 33, 17), storage="hashed"),
    # coarse levels dense, fine levels hashed (as tests/test_pallas.py's mixed case)
    "mixed": dict(dim=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                  base_resolution=(8, 8, 4), finest_resolution=(33, 33, 17)),
    # base (4,4,2) under the reference growth reaches res 1228 on the last axis;
    # there the JAX package's Pallas interpret path and apply() differ by 5e-5
    # (an FMA contraction moves x*res - xi by an ulp), so it is held to apply()
    "mixed_wide": dict(dim=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                       base_resolution=(4, 4, 2), finest_resolution=(33, 33, 17)),
    "d2": dict(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=12,
               base_resolution=(8, 8), finest_resolution=(33, 33)),
    "d4": dict(dim=4, n_levels=2, n_features_per_level=2, log2_hashmap_size=12,
               base_resolution=(3, 3, 2, 2), finest_resolution=(9, 9, 5, 6)),
    "d4_hashed": dict(dim=4, n_levels=2, n_features_per_level=3, log2_hashmap_size=9,
                      base_resolution=(3, 3, 2, 2), finest_resolution=(9, 9, 5, 6), storage="hashed"),
}
# geometry-only configs: too large for interpret mode, cheap to compare
GEOMETRY_ONLY = {
    "tcnn16": dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                   base_resolution=16, finest_resolution=None, per_level_scale=1.4),
    "ngp_paper": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=23,
                      base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15), growth="paper"),
    "dense_forced": dict(dim=3, n_levels=2, n_features_per_level=1, log2_hashmap_size=14,
                         base_resolution=(3, 3, 2), finest_resolution=(9, 9, 5), storage="dense"),
}
# interpret mode costs seconds of tracing per geometry: it runs on the four
# that cover the flagship, hashing, and d = 2, 3 and 4; apply() on all
PALLAS_CONFIGS = ("flagship", "hashed", "d2", "d4_hashed")
ATOL = 1e-6


def _inputs(cfg, n=97, seed=0):
    """Points with the boundary (0, 1 and mixed corners), a U(-1,1) table and
    an upstream gradient, all from numpy."""
    rng = np.random.default_rng(seed)
    enc = HashGridEncoding(**cfg)
    d = cfg["dim"]
    x = rng.random((n, d), dtype=np.float32)
    x[0], x[1] = 0.0, 1.0
    x[2] = np.resize([0.0, 1.0], d)
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    g = rng.standard_normal((n, enc.output_dim)).astype(np.float32)
    return enc, JaxHashGrid(**cfg), x, table, g


def _jax_pallas(jenc, x, table, g):
    def f(t):
        return pallas_hash_encode(jenc, {"table": t}, jnp.asarray(x), tile=64, interpret=True)

    y, vjp = jax.vjp(f, jnp.asarray(table))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _jax_apply(jenc, x, table, g):
    @jax.jit
    def f(t):
        return jenc.apply({"table": t}, jnp.asarray(x))

    y, vjp = jax.vjp(f, jnp.asarray(table))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name", sorted({**CONFIGS, **GEOMETRY_ONLY}))
def test_geometry_matches_jax(name):
    cfg = {**CONFIGS, **GEOMETRY_ONLY}[name]
    enc, jenc = HashGridEncoding(**cfg), JaxHashGrid(**cfg)
    np.testing.assert_array_equal(enc.level_resolutions, jenc.level_resolutions)
    np.testing.assert_array_equal(enc.level_dense, jenc.level_dense)
    np.testing.assert_array_equal(enc.level_sizes, jenc.level_sizes)
    np.testing.assert_array_equal(enc.level_offsets, jenc.level_offsets)
    assert enc.total_size == jenc.total_size and enc.output_dim == jenc.output_dim


def test_flagship_geometry_numbers():
    enc = HashGridEncoding(**CONFIGS["flagship"])
    assert enc.total_size == 156_258 and enc.level_dense.all()
    tcnn = HashGridEncoding(**GEOMETRY_ONLY["tcnn16"])
    assert tcnn.total_size == 6_140_528 and int((~tcnn.level_dense).sum()) == 11


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_corner_ids_and_weights_match_jax(name):
    enc, jenc, x, _, _ = _inputs(CONFIGS[name])
    ids, w = enc.corner_ids_and_weights(torch.from_numpy(x))
    jids, jw = jenc.corner_ids_and_weights(jnp.asarray(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))  # same float32 ops in the same order


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_pallas_interpret_and_apply(name):
    enc, jenc, x, table, g = _inputs(CONFIGS[name])
    y = he.hash_encode_forward(enc, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    assert y.shape == (len(x), enc.output_dim)
    np.testing.assert_allclose(y, _jax_apply(jenc, x, table, g)[0], rtol=0, atol=ATOL)
    if name in PALLAS_CONFIGS:
        np.testing.assert_allclose(y, _jax_pallas(jenc, x, table, g)[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_grad_matches_pallas_interpret_and_apply(name):
    enc, jenc, x, table, g = _inputs(CONFIGS[name])
    dt = he.hash_encode_table_grad(enc, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert dt.shape == table.shape
    np.testing.assert_allclose(dt, _jax_apply(jenc, x, table, g)[1], rtol=0, atol=ATOL)
    if name in PALLAS_CONFIGS:
        np.testing.assert_allclose(dt, _jax_pallas(jenc, x, table, g)[1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["flagship", "d4_hashed"])
def test_autograd_function_on_cpu(name):
    enc, _, x, table, g = _inputs(CONFIGS[name])
    t = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x)
    y = he.HashEncode.apply(t, xt, enc)
    (y * torch.from_numpy(g)).sum().backward()
    ref = he.hash_encode_table_grad_reference(enc, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), ref.numpy())
    np.testing.assert_array_equal(y.detach().numpy(), he.hash_encode_reference(enc, t.detach(), xt).numpy())


@pytest.mark.parametrize("name", ["flagship", "d4_hashed"])
def test_table_grad_exact_is_the_float64_sum_rounded_once(name):
    """The card checks' reference for kernel 2: the plain version's float32
    terms summed in float64 (here against numpy's ``add.at``), cast once;
    x in [-1, 1], where clamped cells extrapolate the weights. Within an
    ulp of the float64 sum, and within the atomic bound of the float32
    plain version."""
    enc, _, x, _, g = _inputs(CONFIGS[name])
    xt, gt = torch.from_numpy(2 * x - 1), torch.from_numpy(g)
    got = he.hash_encode_table_grad_exact(enc, xt, gt)
    ids, terms = he._scatter_terms(enc, xt, gt, range(enc.n_levels))
    want = np.zeros((enc.total_size, enc.n_features_per_level), np.float64)
    np.add.at(want, ids.numpy(), terms.numpy().astype(np.float64))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-23, atol=1e-30)
    plain = he.hash_encode_table_grad_reference(enc, xt, gt)
    assert bool(((plain - got).abs() <= he.atomic_sum_bound(he.table_grad_abs_sum(enc, xt, gt))).all())


def test_cpu_path_does_not_count_launches():
    enc, _, x, table, g = _inputs(CONFIGS["d2"])
    he.reset_launches()
    he.hash_encode_forward(enc, torch.from_numpy(table), torch.from_numpy(x))
    he.hash_encode_table_grad(enc, torch.from_numpy(x), torch.from_numpy(g))
    assert he.LAUNCHES == {"hash_encode_forward": 0, "hash_encode_table_grad": 0,
                           "hash_encode_coarse_forward": 0, "hash_encode_coarse_table_grad": 0}


def test_init_range_and_seed():
    enc = HashGridEncoding(**CONFIGS["hashed"])
    a = enc.init(torch.Generator().manual_seed(3))
    b = enc.init(torch.Generator().manual_seed(3))
    assert a.shape == (enc.total_size, 2) and a.dtype == torch.float32
    assert float(a.abs().max()) <= 1e-4 and float(a.abs().max()) > 0
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["flagship", "d4_hashed"])
def test_kernel_constant_block_layout(name):
    enc = HashGridEncoding(**CONFIGS[name])
    consts = enc.kernel_constants
    assert consts.dtype == np.int32 and consts.flags.c_contiguous
    assert consts.shape == (enc.n_levels, LEVEL_CONST_WIDTH)
    d = enc.input_dim
    for lv in range(enc.n_levels):
        np.testing.assert_array_equal(consts[lv, :d], enc.level_resolutions[lv])
        np.testing.assert_array_equal(consts[lv, 4:4 + d], enc.vertex_strides(lv))
        assert consts[lv, 8].view(np.uint32) == enc.level_sizes[lv]
        assert consts[lv, 9] == enc.level_offsets[lv]
        assert consts[lv, 10] == int(enc.level_dense[lv])


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.compile_sources(build.SOURCES, build_dir=tmp_path)


def test_build_reports_a_failing_compiler(tmp_path):
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.compile_sources(build.SOURCES, build_dir=tmp_path, nvcc="false")
    assert list(tmp_path.iterdir()) == []  # no partial library is left behind


def test_sources_have_plain_c_interface():
    src = build.SOURCES["hash_encode"].read_text()
    assert "torch/" not in src and "ATen" not in src
    for fn in ("hash_encode_forward", "hash_encode_table_grad", "hash_encode_error_string"):
        assert f"{fn}(" in src
    assert 'extern "C"' in src and "compute_90a" in " ".join(build.NVCC_FLAGS)
