"""Port parity: the coarse-level hash encode (``coarse_onehot_levels``,
``hash_encode_coarse`` and its table gradient) of ``mri_interpolation_tpu_torch``
against the JAX package's ``pallas_hash_encode_coarse``.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the one-hot Pallas kernels in interpret mode (as
tests/test_pallas.py runs them) and against ``HashGridEncoding.apply``'s
columns of the coarse levels. The CUDA kernels have no CPU mode: their tests
are in test_torch_kernels_gpu.py.

Tolerances and their reasons:

- forward against the interpret path: atol 1e-5 (the JAX tests' own for this
  path); against ``apply``: atol 1e-6 (fp32 sums of 2^d products of
  magnitude <= 1 taken in another order);
- coordinates in [-1, 1]: dense levels clamp the cell index and the weights
  extrapolate (to ~res^d), so the features reach ~1e3 here and their terms
  cancel; the same bounds are taken relative to the largest reference value;
- table gradient against ``jax.grad`` through the interpret path: atol 1e-5
  (sums of ~100 terms of |g*w| <= 4 a row, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu.ops.pallas import coarse_onehot_levels as jax_coarse_levels
from mri_interpolation_tpu.ops.pallas import pallas_hash_encode_coarse
from mri_interpolation_tpu_torch import bench_kernels
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.ops import hash_encode as he

CONFIGS = {
    # tests/test_pallas.py TestOneHotCoarseEncode._enc: every level coarse
    "paper": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=11, base_resolution=(3, 3, 2),
                  finest_resolution=(11, 11, 6), storage="auto", growth="paper"),
    # TestOneHotCoarseEncode.test_partial_level_subset: only the coarse levels qualify
    "partial": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=14, base_resolution=(4, 4, 2),
                    finest_resolution=(40, 40, 12), storage="auto"),
    # scripts/bench_pallas_exec.py section 2 (bench_kernels.bench_geometry)
    "bench": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=14, base_resolution=(4, 4, 2),
                  finest_resolution=(16, 16, 8), storage="auto"),
}
# the multi-frame HashMLP of scripts/experiments.py:238-243: levels 0-3 coarse
MULTI_FRAME = dict(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                   finest_resolution=None, per_level_scale=1.4)


def _inputs(cfg, n, lo=0.0, seed=0):
    rng = np.random.default_rng(seed)
    enc = HashGridEncoding(**cfg)
    x = rng.uniform(lo, 1.0, (n, cfg["dim"])).astype(np.float32)
    x[0], x[1] = lo, 1.0
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    n_cols = len(he.coarse_onehot_levels(enc)) * cfg["n_features_per_level"]
    g = rng.standard_normal((n, n_cols)).astype(np.float32)
    return enc, JaxHashGrid(**cfg), x, table, g


def _jax_coarse(jenc, table, x, g):
    f = lambda t: pallas_hash_encode_coarse(jenc, {"table": t}, jnp.asarray(x), tile=256, interpret=True)  # noqa: E731
    y, vjp = jax.vjp(f, jnp.asarray(table))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _apply_columns(jenc, table, x, levels):
    full = np.asarray(jax.jit(lambda t: jenc.apply({"table": t}, jnp.asarray(x)))(jnp.asarray(table)))
    F = jenc.n_features_per_level
    return np.concatenate([full[:, l * F:(l + 1) * F] for l in levels], axis=-1)


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["multi_frame"])
def test_coarse_levels_match_jax(name):
    cfg = MULTI_FRAME if name == "multi_frame" else CONFIGS[name]
    enc, jenc = HashGridEncoding(**cfg), JaxHashGrid(**cfg)
    for max_rows in (2048, 400, 16):
        assert he.coarse_onehot_levels(enc, max_rows) == jax_coarse_levels(jenc, max_rows)
    if name == "multi_frame":
        assert he.coarse_onehot_levels(enc) == [0, 1, 2, 3]
        assert [int(enc.level_sizes[l]) for l in range(4)] == [289, 529, 1024, 1936]


# (geometry, N, lower end of x): a ragged N (not a multiple of the tile) and x in [-1, 1]
CASES = [("paper", 517, 0.0), ("partial", 256, 0.0), ("bench", 300, 0.0), ("paper", 517, -1.0),
         ("bench", 300, -1.0)]


@pytest.mark.parametrize("name,n,lo", CASES, ids=[f"{c}-{n}-{lo:g}" for c, n, lo in CASES])
def test_forward_and_table_grad_match_jax(name, n, lo):
    enc, jenc, x, table, g = _inputs(CONFIGS[name], n, lo)
    levels = he.coarse_onehot_levels(enc)
    want, want_grad = _jax_coarse(jenc, table, x, g)
    got = he.hash_encode_coarse_forward(enc, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max())) if lo < 0 else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, _apply_columns(jenc, table, x, levels), rtol=0, atol=1e-6 * scale)
    grad = he.hash_encode_coarse_table_grad(enc, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    gscale = max(1.0, float(np.abs(want_grad).max())) if lo < 0 else 1.0
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-5 * gscale)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_autograd_through_coarse_encode_matches_jax_grad(name):
    """jax.grad of a mean-squared loss through the interpret path against
    torch autograd through ``hash_encode_coarse`` (HashEncodeCoarse)."""
    enc, jenc, x, table, _ = _inputs(CONFIGS[name], 300, seed=1)
    levels = he.coarse_onehot_levels(enc)
    tgt = np.random.default_rng(2).standard_normal((300, len(levels) * enc.n_features_per_level)).astype(np.float32)

    def loss(t):
        z = pallas_hash_encode_coarse(jenc, {"table": t}, jnp.asarray(x), tile=256, interpret=True)
        return jnp.mean((z - jnp.asarray(tgt)) ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    z = he.hash_encode_coarse(enc, t, torch.from_numpy(x))
    ((z - torch.from_numpy(tgt)) ** 2).mean().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-5)
    # the gradient reaches the fused table at the coarse rows only
    coarse_rows = np.zeros(enc.total_size, dtype=bool)
    for l in levels:
        coarse_rows[enc.level_offsets[l]:enc.level_offsets[l + 1]] = True
    assert not t.grad.numpy()[~coarse_rows].any()


def test_no_coarse_level_raises():
    enc = HashGridEncoding(**CONFIGS["bench"])
    x, table = torch.rand((4, 3)), enc.init()
    with pytest.raises(ValueError, match="no dense level"):
        he.hash_encode_coarse(enc, table, x, max_rows=10)
    with pytest.raises(ValueError, match="no dense level"):
        he.hash_encode_coarse_forward(enc, table, x, max_rows=10)
    hashed = HashGridEncoding(**{**CONFIGS["bench"], "storage": "hashed"})
    assert he.coarse_onehot_levels(hashed) == []


def test_coarse_constants_pack_the_levels():
    enc = HashGridEncoding(**CONFIGS["partial"])
    levels = he.coarse_onehot_levels(enc)
    consts = he.coarse_constants(enc, levels)
    assert consts.dtype == np.int32 and consts.shape == (len(levels), 12)
    sizes = [int(enc.level_sizes[l]) for l in levels]
    assert consts[:, 9].tolist() == [sum(sizes[:j]) for j in range(len(levels))]  # packed, unpadded
    assert consts[:, 11].tolist() == [int(enc.level_offsets[l]) for l in levels]  # rows in the fused table
    np.testing.assert_array_equal(np.delete(consts, [9, 11], axis=1),
                                  np.delete(enc.kernel_constants[levels], [9, 11], axis=1))


def test_reference_counts_no_launch():
    enc, _, x, table, g = _inputs(CONFIGS["paper"], 64)
    he.reset_launches()
    he.hash_encode_coarse_forward(enc, torch.from_numpy(table), torch.from_numpy(x))
    he.hash_encode_coarse_table_grad(enc, torch.from_numpy(x), torch.from_numpy(g))
    assert set(he.LAUNCHES.values()) == {0}


# the card tests' per-row bound on an atomic scatter (he.atomic_sum_bound)
D1 = dict(dim=1, n_levels=3, n_features_per_level=8, log2_hashmap_size=5, base_resolution=(4,),
          finest_resolution=(64,))


@pytest.mark.parametrize("coarse", [False, True], ids=["all_levels", "coarse_levels"])
def test_atomic_sum_bound_covers_rounding_and_catches_a_dropped_term(coarse):
    """On the card tests' d1 inputs (4,099 points, N(0, 1) cotangents): the
    fp32 plain version lies within the bound of the float64 sum, and the
    bound lies far below one typical term, so one term dropped (or added
    twice) breaks it."""
    rng = np.random.default_rng(0)
    enc = HashGridEncoding(**D1)
    levels = he.coarse_onehot_levels(enc) if coarse else list(range(enc.n_levels))
    x = torch.from_numpy(rng.random((4099, 1), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((4099, len(levels) * 8)).astype(np.float32))
    if coarse:
        plain = he.hash_encode_coarse_table_grad_reference(enc, x, g)
    else:
        plain = he.hash_encode_table_grad_reference(enc, x, g)
    exact = torch.zeros(plain.shape, dtype=torch.float64)
    ids, terms = he._scatter_terms(enc, x.double(), g.double(), levels)
    exact.index_add_(0, ids, terms)
    bound = he.atomic_sum_bound(he.table_grad_abs_sum(enc, x, g, levels)).double()
    assert ((plain.double() - exact).abs() <= bound).all()
    typical = float(terms.abs().median())
    assert float(bound.max()) < typical / 100
    k = int(torch.nonzero(terms.abs().max(dim=1).values >= typical)[0, 0])  # a term of typical size
    dropped = exact.clone().index_add_(0, ids[k:k + 1], -terms[k:k + 1])
    assert ((dropped - exact).abs() > bound).any()


def test_bench_sections_run_on_the_cpu(capsys):
    summary = bench_kernels.run("cpu", sections=(1, 2), iters=2,
                                batches={"siren": (64,), "siren_grad": 96, "coarse": (100, 33), "coarse_grad": 80})
    names = [r["kernel"] for r in summary["kernels"]]
    assert names == ["fused_siren_apply", "fused_siren_apply_grad", "onehot_coarse_encode", "onehot_coarse_encode",
                     "onehot_coarse_encode_grad"]
    assert summary["device"] == "cpu"
    for rec in summary["kernels"]:
        assert {"kernel", "batch", "max_abs_err", "tolerance", "ok", "kernel_ms", "plain_ms",
                "speedup_vs_plain"} <= set(rec), rec
        assert rec["ok"] and rec["kernel_ms"] > 0 and rec["plain_ms"] > 0
    coarse = [r for r in summary["kernels"] if r["kernel"] == "onehot_coarse_encode"]
    assert coarse[0]["levels"] == [0, 1] and coarse[0]["rows"] == [75, 392]
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(printed) == len(summary["kernels"])
