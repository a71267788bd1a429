"""The CUDA kernels (hash encode of all levels and of the coarse levels, the
table gradient's private and global levels, fused MLP, probe) against their
plain PyTorch versions, on the card. Every test here carries the ``gpu`` marker and
skips without a CUDA device: a CUDA kernel has no CPU mode. The file imports no JAX (the card's
machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q -p no:cacheprovider

Tolerances of the hash kernels (all levels, and the coarse levels alone):

- forward: atol 2e-6 (fp32 sums of 2^d products of magnitude <= 1 in another
  order). With x in [-1, 1] dense levels clamp the cell index and the weights
  extrapolate (features reach ~5e5 on the tcnn geometry, with terms that
  cancel), so there the bound is 2e-6 of the largest reference value (and at
  least 2e-6).
- table gradient: per (row, feature), ``he.atomic_sum_bound``:
  1e-5 + 8 * 2^-24 * sum|g*w| over the terms the entry sums. fp32 atomics
  add in a run-dependent order (the plain version's ``index_add_`` too, on
  the card); with terms of both signs the rounding error grows with the
  row's sum|terms|, not with |sum|: a random walk of partial sums gives a
  deviation of about 0.5 * 2^-24 * sum|terms| per sum for these N(0, 1)
  cotangents, 0.7 for the difference of two, and c = 8 is some 11
  deviations (the derivation is in ``atomic_sum_bound``). On the d1 config
  the largest bound, 4.1e-4 at a level-0 row of 2,028 terms (sum|terms|
  831), is 640 times below the median term |g*w|, 0.26, so a dropped or
  doubled term still fails (tests/test_torch_hash_coarse.py holds that on
  the CPU).

Those of the fused MLP are stated above its tests below.
"""

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.ops import hash_encode as he

CONFIGS = {
    "flagship": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                     base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15)),
    "hashed": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=10,
                   base_resolution=(8, 8, 4), finest_resolution=(33, 33, 17), storage="hashed"),
    "d1": dict(dim=1, n_levels=3, n_features_per_level=8, log2_hashmap_size=5,
               base_resolution=(4,), finest_resolution=(64,)),
    "d2": dict(dim=2, n_levels=3, n_features_per_level=2, log2_hashmap_size=12,
               base_resolution=(8, 8), finest_resolution=(33, 33)),
    "d4_hashed": dict(dim=4, n_levels=2, n_features_per_level=3, log2_hashmap_size=9,
                      base_resolution=(3, 3, 2, 2), finest_resolution=(9, 9, 5, 6), storage="hashed"),
    # the NGP 3-level F=8 paper+cosine HashMLP's encoder: 2,224,303 dense rows, every level global in kernel 2
    "ngp": dict(dim=3, n_levels=3, n_features_per_level=8, log2_hashmap_size=23, base_resolution=(64, 64, 5),
                finest_resolution=(352, 352, 15), growth="paper"),
}


ZERO = {name: 0 for name in he.LAUNCHES}
# the multi-frame HashMLP's encoder (scripts/experiments.py:238-243): 10 dense levels x F = 2
COARSE_MULTI_FRAME = dict(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                          finest_resolution=None, per_level_scale=1.4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash-encode kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cfg, n, device, g_cols=None, seed=0):
    """Encoder, x in [0, 1) (0 and 1 in the first two rows, where there are
    two), a U(-1, 1) table and an N(0, 1) cotangent of ``g_cols`` columns
    (default all levels')."""
    rng = np.random.default_rng(seed)
    enc = HashGridEncoding(**cfg)
    x = rng.random((n, cfg["dim"]), dtype=np.float32)
    x[:2] = np.array([0.0, 1.0], dtype=np.float32)[:n, None]
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    g = rng.standard_normal((n, enc.output_dim if g_cols is None else g_cols)).astype(np.float32)
    return (enc, *(torch.from_numpy(a).to(device) for a in (x, table, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernels_match_plain_versions(name, cuda_device):
    enc, x, table, g = _inputs(CONFIGS[name], 4099, cuda_device)
    he.reset_launches()
    y = he.hash_encode_forward(enc, table, x)
    dt = he.hash_encode_table_grad(enc, x, g)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_forward": 1, "hash_encode_table_grad": 1}
    np.testing.assert_allclose(y.cpu().numpy(), he.hash_encode_reference(enc, table, x).cpu().numpy(),
                               rtol=0, atol=2e-6)
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


def _assert_within_atomic_bound(got, want, enc, x, g, levels=None):
    """Every (row, feature) of the table gradient ``got`` within
    ``he.atomic_sum_bound`` of ``want``, the bound taken over the terms that
    ``levels`` (default all; g holds their columns) add there. On failure,
    reports the entry of the largest excess: its row, level and feature, both
    values, its number of terms n, sum|t|, sqrt(n * sum t^2), the bound and
    the excess."""
    levels = list(range(enc.n_levels)) if levels is None else list(levels)
    bound = he.atomic_sum_bound(he.table_grad_abs_sum(enc, x, g, levels))
    excess = (got - want).abs() - bound
    worst = int(torch.argmax(excess))
    if float(excess.reshape(-1)[worst]) <= 0.0:
        return
    F = enc.n_features_per_level
    row, f = divmod(worst, F)
    ids, terms = he._scatter_terms(enc, x, g, levels)
    t = terms[ids == row][:, f].double().cpu()
    n, abs_sum, sq = t.numel(), float(t.abs().sum()), float((t.numel() * t.square().sum()).sqrt())
    level = int(np.searchsorted(enc.level_offsets, row, side="right")) - 1
    raise AssertionError(
        f"|kernel - plain| exceeds the per-row bound at row {row} (level {level}) feature {f}: kernel "
        f"{float(got.reshape(-1)[worst])!r}, plain {float(want.reshape(-1)[worst])!r}, {n} terms, "
        f"sum|t| {abs_sum!r}, sqrt(n sum t^2) {sq!r}, bound {float(bound.reshape(-1)[worst])!r}, "
        f"excess {float(excess.reshape(-1)[worst])!r}")


def _forward_bound(ref):
    return 2e-6 * max(1.0, float(ref.abs().max()))


OUTSIDE = {**{k: CONFIGS[k] for k in ("flagship", "d2", "hashed", "ngp")},
           "tcnn": dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                        finest_resolution=None, per_level_scale=1.4),
           # hash_siren's encoder (scripts/experiments.py:200-203), which --zero_centered feeds x in [-1, 1]:
           # 921,464 rows, levels 0-3 dense, 4-9 hashed
           "hash_siren": dict(dim=3, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                              finest_resolution=None, per_level_scale=1.4)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_kernels_match_plain_versions_outside_the_unit_cube(name, cuda_device):
    """x in [-1, 1], what ``--zero_centered true`` feeds a hash model: dense
    levels clamp the cell index at 0 and extrapolate the weights."""
    enc, x, table, g = _inputs(OUTSIDE[name], 4099, cuda_device)
    x = 2 * x - 1
    y = he.hash_encode_forward(enc, table, x)
    ref = he.hash_encode_reference(enc, table, x)
    assert float((y - ref).abs().max()) <= _forward_bound(ref)
    dt = he.hash_encode_table_grad(enc, x, g)
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


# the warp INR's canonical encoder (scripts/experiments.py:275-280): 2-D, 4 dense (cell-view) levels x F = 4,
# paper growth, 181,603 rows; its coordinates are clip(x + d(x, t), 0, 1), so a few percent sit on the bounds
WARP = dict(dim=2, n_levels=4, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64),
            finest_resolution=(352, 352), growth="paper")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [10_000, 131_072], ids=["train_batch", "grid_chunk"])
def test_warp_encoder_kernels_and_coordinate_gradient(n, cuda_device):
    """Kernels 1-2 on the warp encoder, x = clip(u + 0.05 * normal, 0, 1),
    under the forward and per-entry bounds; and the coordinate gradient
    (plain torch on both devices) through ``HashEncode``'s backward on the
    card against the same function on the CPU, within 1e-5 of its largest
    value (sums of corner terms in another order)."""
    enc, x, table, g = _inputs(WARP, n, cuda_device, seed=3)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 2)).astype(np.float32))
    x = torch.clamp(x + 0.05 * noise.to(cuda_device), 0.0, 1.0)
    assert 0.01 < float(((x == 0) | (x == 1)).float().mean()) < 0.1
    y = he.hash_encode_forward(enc, table, x)
    ref = he.hash_encode_reference(enc, table, x)
    assert float((y - ref).abs().max()) <= _forward_bound(ref)
    dt = he.hash_encode_table_grad(enc, x, g)
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)
    xg = x.clone().requires_grad_()
    he.reset_launches()
    (he.HashEncode.apply(table, xg, enc) * g).sum().backward()
    assert he.LAUNCHES == {**ZERO, "hash_encode_forward": 1}  # the table needs no gradient here
    want = he.hash_encode_coord_grad(enc, table.cpu(), x.cpu(), g.cpu())
    assert float((xg.grad.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# the full-4D recipe's encoder (scripts/experiments.py:398-402) as the launcher builds it for the (352, 352, 6,
# 15) volume: 5 levels x F = 4, paper growth, base rank-adapted to (64, 64, 2, 3); 12,134,251 rows, levels 0-3
# dense (last axes of 3-16 vertices), level 4 hashed; every level global in kernel 2's plan
FULL4D = dict(dim=4, n_levels=5, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2, 3),
              finest_resolution=(352, 352, 6, 15), growth="paper")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [50_000, 131_072], ids=["train_batch", "grid_chunk"])
def test_full4d_encoder_kernels(n, cuda_device):
    """Kernels 1-2 at the full-4D recipe's geometry, its training batch and
    a grid chunk, x in [0, 1]: 16 corners a point and level; the forward
    within 2e-6, the table gradient per entry within the atomic bound."""
    enc, x, table, g = _inputs(FULL4D, n, cuda_device, seed=5)
    assert enc.total_size == 12_134_251 and enc.level_dense.tolist() == [True, True, True, True, False]
    assert he.table_grad_plan(enc, n) == he.TableGradPlan((), (0, 1, 2, 3, 4), 1, 0)
    he.reset_launches()
    y = he.hash_encode_forward(enc, table, x)
    dt = he.hash_encode_table_grad(enc, x, g)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_forward": 1, "hash_encode_table_grad": 1}
    ref = he.hash_encode_reference(enc, table, x)
    assert float((y - ref).abs().max()) <= _forward_bound(ref)
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


SEEDS = list(range(1, 25))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_table_grad_outside_the_unit_cube_seeds(seed, cuda_device):
    """The flagship case of the test above with other inputs: kernel 2 with
    x in [-1, 1], where clamped dense cells extrapolate the weights, so the
    terms of one boundary row span orders of magnitude."""
    enc, x, _, g = _inputs(OUTSIDE["flagship"], 4099, cuda_device, seed=seed)
    x = 2 * x - 1
    dt = he.hash_encode_table_grad(enc, x, g)
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda_device):
    enc, x, table, g = _inputs(CONFIGS["flagship"], 4, cuda_device)
    he.reset_launches()
    assert he.hash_encode_forward(enc, table, x[:0]).shape == (0, 4)
    assert float(he.hash_encode_table_grad(enc, x[:0], g[:0]).abs().sum()) == 0.0
    assert he.LAUNCHES == ZERO


@pytest.mark.gpu
def test_wrapper_rejects_bad_tensors(cuda_device):
    enc, x, table, _ = _inputs(CONFIGS["flagship"], 16, cuda_device)
    with pytest.raises(ValueError, match="is on"):
        he.hash_encode_forward(enc, table, x.cpu())
    with pytest.raises(TypeError, match="float32"):
        he.hash_encode_forward(enc, table, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        he.hash_encode_forward(enc, table, x.t().contiguous().t())


@pytest.mark.gpu
def test_model_gradients_on_card_match_cpu(cuda_device):
    kw = dict(base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16, seed=1)
    x = torch.rand((512, 3), generator=torch.Generator().manual_seed(2))
    table = None
    grads = {}
    for dev in ("cpu", cuda_device):
        model = make_hash_mlp(3, device=dev, **kw)
        if table is None:  # one well-conditioned table for both (U(+-0.5), not the 1e-4 init)
            table = torch.empty(model.encoder.table.shape).uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            model.encoder.table.copy_(table)
        model(x.to(dev)).square().mean().backward()
        grads[str(dev)] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for key, want in grads["cpu"].items():
        np.testing.assert_allclose(grads[str(cuda_device)][key].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# kernel 2's plan on the card: privatised levels (shared-memory accumulator)
# and global levels (vector atomics) in one call


@pytest.mark.gpu
def test_table_grad_on_a_raster_order_frame(cuda_device):
    """One whole 352 x 352 frame in raster order, as fit_frames sends it, on
    all ten multi-frame levels: levels 0-3 privatised, 4-9 global with
    float2 atomics; neighbouring threads share corners."""
    cfg = COARSE_MULTI_FRAME
    enc = HashGridEncoding(**cfg)
    xs = np.linspace(0, 1, 352, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    x = torch.from_numpy(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)).to(cuda_device)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((x.shape[0], enc.output_dim))
                         .astype(np.float32)).to(cuda_device)
    plan = he.table_grad_plan(enc, x.shape[0])
    assert plan.private_levels == (0, 1, 2, 3) and plan.global_levels == (4, 5, 6, 7, 8, 9)
    he.reset_launches()
    dt = he.hash_encode_table_grad(enc, x, g)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_table_grad": 1}
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


MIXED_F = [1, 2, 4, 8]


@pytest.mark.gpu
@pytest.mark.parametrize("f", MIXED_F)
@pytest.mark.parametrize("lo", [0.0, -1.0])
def test_table_grad_private_and_global_levels_mixed(f, lo, cuda_device):
    """Levels of 81 and 169 rows privatised at N = 20,000, three dense and one
    hashed level global; F = 1, 2, 4, 8 (scalar, float2 and float4 atomics);
    x in [0, 1] and in [-1, 1]."""
    cfg = dict(dim=2, n_levels=6, n_features_per_level=f, log2_hashmap_size=11, base_resolution=8,
               finest_resolution=None, per_level_scale=1.5)
    enc, x, _, g = _inputs(cfg, 20_000, cuda_device)
    x = x * (1 - lo) + lo
    plan = he.table_grad_plan(enc, x.shape[0])
    assert plan.private_levels == (0, 1) and plan.global_levels == (2, 3, 4, 5)
    assert not enc.level_dense[5]
    he.reset_launches()
    dt = he.hash_encode_table_grad(enc, x, g)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_table_grad": 1}
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), enc, x, g)


# ---------------------------------------------------------------------------
# the coarse-level pair (kernels 3-4)

COARSE = {
    # scripts/bench_pallas_exec.py section 2: levels 0-1 of 75 and 392 rows
    "bench": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=14, base_resolution=(4, 4, 2),
                  finest_resolution=(16, 16, 8)),
    # tests/test_pallas.py TestOneHotCoarseEncode: every level coarse
    "paper": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=11, base_resolution=(3, 3, 2),
                  finest_resolution=(11, 11, 6), growth="paper"),
    # the multi-frame HashMLP (scripts/experiments.py:238-243): levels 0-3, 3,778 rows, 30 KB
    "multi_frame": dict(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                        finest_resolution=None, per_level_scale=1.4),
    # the same levels at F = 8: 121 KB of rows, past the 48 KB default (the opt-in)
    "multi_frame_f8": dict(dim=2, n_levels=10, n_features_per_level=8, log2_hashmap_size=17, base_resolution=16,
                           finest_resolution=None, per_level_scale=1.4),
    "d1": CONFIGS["d1"],
}
# (geometry, N, lower end of x): ragged, one 352 x 352 frame, x in [-1, 1]
COARSE_CASES = [("bench", 517, 0.0), ("bench", 65536, -1.0), ("paper", 517, 0.0), ("paper", 4099, -1.0),
                ("multi_frame", 123904, 0.0), ("multi_frame", 517, -1.0), ("multi_frame_f8", 20000, 0.0),
                ("d1", 4099, 0.0)]


def _coarse_check(enc, x, table, g, max_rows=he.ONEHOT_MAX_ROWS):
    levels = he.coarse_onehot_levels(enc, max_rows)
    he.reset_launches()
    y = he.hash_encode_coarse_forward(enc, table, x, max_rows)
    dt = he.hash_encode_coarse_table_grad(enc, x, g, max_rows)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_coarse_forward": 1, "hash_encode_coarse_table_grad": 1}
    ref = he.hash_encode_coarse_reference(enc, table, x, max_rows)
    assert y.shape == ref.shape == (x.shape[0], len(levels) * enc.n_features_per_level)
    assert float((y - ref).abs().max()) <= _forward_bound(ref)
    _assert_within_atomic_bound(dt, he.hash_encode_coarse_table_grad_reference(enc, x, g, max_rows), enc, x, g, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,lo", COARSE_CASES, ids=[f"{c}-{n}-{lo:g}" for c, n, lo in COARSE_CASES])
def test_coarse_kernels_match_plain_versions(name, n, lo, cuda_device):
    enc = HashGridEncoding(**COARSE[name])
    cols = len(he.coarse_onehot_levels(enc)) * enc.n_features_per_level
    enc, x, table, g = _inputs(COARSE[name], n, cuda_device, g_cols=cols)
    _coarse_check(enc, x * (1 - lo) + lo, table, g)


@pytest.mark.gpu
def test_coarse_kernels_stage_levels_in_groups(cuda_device):
    """Coarse levels of 1,681 + 2,809 + 4,624 rows at F = 8 (291 KB) exceed a
    block's 227 KB: the kernels stage levels 0-1, then level 2."""
    cfg = dict(dim=2, n_levels=4, n_features_per_level=8, log2_hashmap_size=16, base_resolution=40,
               finest_resolution=None, per_level_scale=1.3)
    enc = HashGridEncoding(**cfg)
    levels = he.coarse_onehot_levels(enc, 7000)
    assert [int(enc.level_sizes[l]) for l in levels] == [1681, 2809, 4624]
    enc, x, table, g = _inputs(cfg, 3001, cuda_device, g_cols=len(levels) * 8)
    _coarse_check(enc, x, table, g, max_rows=7000)
    with pytest.raises(ValueError, match="shared memory"):  # a level of 7,744 rows x 8 alone: 248 KB
        he.hash_encode_coarse_forward(enc, table, x, max_rows=8000)


def _one_cell(n, dim, rng):
    """n points in [0.5, 0.51)^dim: inside one cell of every coarse level of
    the multi-frame and bench geometries (resolutions up to 43), so every
    point hits the same 2^d rows on a level and each warp sums 32 terms a
    row (the deepest warp tree)."""
    return (0.5 + rng.uniform(0.0, 0.01, (n, dim))).astype(np.float32)


# kernel 4's plan at the edges: (geometry, N, how x is drawn)
PLAN_CASES = [("multi_frame", 20_001, "uniform"),  # ragged: not a whole number of 256 x cluster points
              ("multi_frame", 1, "uniform"), ("bench", 1, "uniform"),
              ("multi_frame", 352 * 352, "raster"),  # one frame in raster order: 2-3 cells a warp
              ("multi_frame", 50_000, "one cell"), ("bench", 4099, "one cell")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,how", PLAN_CASES, ids=[f"{c}-{n}-{h.replace(' ', '_')}" for c, n, h in PLAN_CASES])
def test_coarse_table_grad_plan_edges(name, n, how, cuda_device):
    enc = HashGridEncoding(**COARSE[name])
    cols = len(he.coarse_onehot_levels(enc)) * enc.n_features_per_level
    enc, x, table, g = _inputs(COARSE[name], n, cuda_device, g_cols=cols)
    if how == "raster":
        xs = np.linspace(0, 1, 352, dtype=np.float32)
        gx, gy = np.meshgrid(xs, xs, indexing="ij")
        x = torch.from_numpy(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)).to(cuda_device)
    elif how == "one cell":
        x = torch.from_numpy(_one_cell(n, enc.input_dim, np.random.default_rng(7))).to(cuda_device)
    plan = he._card_coarse_grad_plan(enc, he.coarse_onehot_levels(enc), n, x.device)
    assert plan.grid % plan.cluster == 0 and plan.cluster in (1, 2, 4, 8)
    _coarse_check(enc, x, table, g)


@pytest.mark.gpu
def test_coarse_refused_launch_raises(cuda_device, monkeypatch):
    """Plans that the C side refuses (a cluster past 8 blocks, a grid that is
    not a whole number of clusters, shared memory past the opt-in): the
    wrapper raises, counts no launch and takes no other route. All three are
    refused before ``cudaLaunchKernelEx``: no plan that passes the C side's
    checks is known that the H100 refuses to launch (clusters of at most 8
    blocks at up to the opt-in shared memory fit a GPC), so an error of the
    cluster launch itself reaches the same ``err != 0`` path in ``_launch``
    untested on the card."""
    enc, x, _, g = _inputs(COARSE["bench"], 4099, cuda_device, g_cols=4)
    card_plan = he._card_coarse_grad_plan
    for bad in (dict(grid=16, cluster=16), dict(grid=12, cluster=8), dict(shared_bytes=300_000)):
        monkeypatch.setattr(he, "_card_coarse_grad_plan", lambda *a, bad=bad: card_plan(*a)._replace(**bad))
        he.reset_launches()
        with pytest.raises(RuntimeError, match="hash_encode_coarse_table_grad launch failed"):
            he.hash_encode_coarse_table_grad(enc, x, g)
        assert he.LAUNCHES == ZERO


@pytest.mark.gpu
def test_coarse_empty_batch_and_bad_tensors(cuda_device):
    enc, x, table, g = _inputs(COARSE["bench"], 16, cuda_device, g_cols=4)
    he.reset_launches()
    assert he.hash_encode_coarse_forward(enc, table, x[:0]).shape == (0, 4)
    assert float(he.hash_encode_coarse_table_grad(enc, x[:0], g[:0]).abs().sum()) == 0.0
    assert he.LAUNCHES == ZERO
    with pytest.raises(ValueError, match="is on"):
        he.hash_encode_coarse_forward(enc, table, x.cpu())
    with pytest.raises(ValueError, match="shape"):
        he.hash_encode_coarse_table_grad(enc, x, torch.zeros((16, 6), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        he.hash_encode_coarse_forward(enc, table, x.t().contiguous().t())


@pytest.mark.gpu
def test_coarse_autograd_on_card_matches_cpu(cuda_device):
    """``hash_encode_coarse``'s table gradient (HashEncodeCoarse) on the card
    equals the CPU's within the per-row bound; zero outside the coarse rows."""
    enc, x, table, _ = _inputs(COARSE["multi_frame"], 5000, "cpu", g_cols=8)
    tgt = torch.from_numpy(np.random.default_rng(5).standard_normal((5000, 8)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        t = table.clone().to(dev).requires_grad_(True)
        ((he.hash_encode_coarse(enc, t, x.to(dev)) - tgt.to(dev)) ** 2).mean().backward()
        grads[str(dev)] = t.grad.cpu()
    g = 2 * (he.hash_encode_coarse_reference(enc, table, x) - tgt) / tgt.numel()
    _assert_within_atomic_bound(grads[str(cuda_device)], grads["cpu"], enc, x, g, range(4))
    assert not grads[str(cuda_device)][int(enc.level_offsets[4]):].any()


# ---------------------------------------------------------------------------
# the fused-MLP kernel pair and the probe
#
# Tolerances, as a share of the largest reference value: 1e-5 for relu, gelu
# and identity stacks (fp32 sums of up to 352 products taken in another order
# on the card, with FMA); 1e-4 where a sine layer at w0 = 30 sits in the stack,
# since the sine multiplies an ulp-level difference of z by w0 at every
# layer. dW and db add the slices' partial sums with atomics in a
# run-dependent order, which the same shares cover.

from mri_interpolation_tpu_torch.models import make_siren  # noqa: E402
from mri_interpolation_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from mri_interpolation_tpu_torch.ops import probe as pr  # noqa: E402

STACKS = {
    # name: (widths, acts, batch)
    "siren_3x32x3": ([3, 32, 32, 32, 1], fm.siren_acts(3, 30.0, 30.0), 1000),
    "siren_w0s": ([3, 48, 48, 2], fm.siren_acts(2, 25.0, 50.0), 777),
    "relu_plain": ([32, 128, 1], fm.mlp_acts(1, "relu"), 4099),
    "gelu_wide": ([40, 200, 136, 3], fm.mlp_acts(2, "gelu"), 513),
    "id_single": ([5, 7], (("id",),), 33),
    "siren_352": ([3, 352, 352, 1], fm.siren_acts(2, 30.0, 30.0), 300),
    "deep_16": ([4] + [24] * 15 + [2], fm.mlp_acts(15, "gelu"), 257),  # the most layers the kernels take
    "wide_832": ([8, 832, 3], fm.mlp_acts(1, "relu"), 100),  # the widest stack that fits shared memory
}


def _stack(name, device):
    return _make_stack(*STACKS[name], device)


def _make_stack(widths, acts, batch, device):
    rng = np.random.default_rng(1)
    ws, bs = [], []
    for k, n in zip(widths[:-1], widths[1:]):
        if acts[0][0] == "sine":  # the SIREN init
            bound = 1.0 / k if not ws else np.sqrt(6.0 / k) / 30.0
        else:
            bound = 1.0 / np.sqrt(k)
        ws.append(rng.uniform(-bound, bound, (k, n)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (n,)).astype(np.float32))
    x = rng.uniform(-1, 1, (batch, widths[0])).astype(np.float32)
    g = rng.standard_normal((batch, widths[-1])).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [t(w) for w in ws], [t(b) for b in bs], t(x), t(g), acts


def _share(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.fixture
def full_fp32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STACKS))
def test_fused_mlp_matches_plain_versions(name, cuda_device, full_fp32):
    ws, bs, x, g, acts = _stack(name, cuda_device)
    tol = 1e-4 if any(a[0] == "sine" for a in acts) else 1e-5
    fm.reset_launches()
    y = fm.mlp_forward(ws, bs, x, acts)
    dws, dbs, dx = fm.mlp_backward(ws, bs, x, g, acts, need_dx=True)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"fused_mlp_forward": 1, "fused_mlp_backward": 1}
    assert _share(y, fm.mlp_forward_reference(ws, bs, x, acts)) <= tol
    rdws, rdbs, rdx = fm.mlp_backward_reference(ws, bs, x, g, acts, need_dx=True)
    for l in range(len(ws)):
        assert _share(dws[l], rdws[l]) <= tol, f"dW[{l}]"
        assert _share(dbs[l], rdbs[l]) <= tol, f"db[{l}]"
    assert dx.is_contiguous() and _share(dx, rdx) <= tol
    _, _, none = fm.mlp_backward(ws, bs, x, g, acts, need_dx=False)
    assert none is None


# the backward (3xTF32 on the tensor cores) at the main paths' shapes: 64-row
# tiles from 16,896 rows on, 32-row tiles below; a ragged batch of each. The
# yardstick takes relu's derivative from the forward kernel's own z
# (fm.relu_masks), which the backward repeats bit for bit: at 10^5-10^6
# pre-activations some lie within rounding of 0, where the plain version's
# order of additions may give the other sign and a whole term of dW differs.
MAIN_STACKS = {
    "multi_siren_encoder": ([2] + [128] * 5, fm.siren_acts(4, 30.0, 30.0), 123_904),
    "multi_siren_decoder": ([128] * 5 + [1], fm.siren_acts(4, 30.0, 30.0), 123_904),
    "multi_hash_decoder": ([20, 64, 1], fm.mlp_acts(1, "relu"), 123_904),
    "path_a": ([3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0), 4096),
    "path_a_ragged_64": ([3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0), 20_001),
    "path_b_ragged_32": ([32, 128, 1], fm.mlp_acts(1, "relu"), 9_999),
}


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("name", sorted(MAIN_STACKS))
def test_fused_backward_at_main_path_shapes(name, need_dx, cuda_device, full_fp32):
    ws, bs, x, g, acts = _make_stack(*MAIN_STACKS[name], cuda_device)
    tol = 1e-4 if any(a[0] == "sine" for a in acts) else 1e-5
    fm.reset_launches()
    dws, dbs, dx = fm.mlp_backward(ws, bs, x, g, acts, need_dx=need_dx)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 1}
    rdws, rdbs, rdx = fm.mlp_backward_reference_masked(ws, bs, x, g, acts, need_dx, fm.relu_masks(ws, bs, x, acts))
    for l in range(len(ws)):
        assert _share(dws[l], rdws[l]) <= tol, f"dW[{l}]"
        assert _share(dbs[l], rdbs[l]) <= tol, f"db[{l}]"
    if need_dx:
        assert dx.is_contiguous() and _share(dx, rdx) <= tol
    else:
        assert dx is None


@pytest.mark.gpu
def test_fused_mlp_masked_rows_add_nothing(cuda_device, full_fp32):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    # a batch of 33 rows: one full tile and one row of the next
    full = fm.mlp_backward(ws, bs, x[:33], g[:33], acts, need_dx=True)
    ref = fm.mlp_backward_reference(ws, bs, x[:33], g[:33], acts, need_dx=True)
    for got, want in zip(full[0] + full[1] + [full[2]], ref[0] + ref[1] + [ref[2]]):
        assert _share(got, want) <= 1e-5


@pytest.mark.gpu
def test_fused_mlp_empty_batch_launches_nothing(cuda_device):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    fm.reset_launches()
    assert fm.mlp_forward(ws, bs, x[:0], acts).shape == (0, 1)
    dws, _, dx = fm.mlp_backward(ws, bs, x[:0], g[:0], acts, need_dx=True)
    assert dx.shape == (0, 32) and float(dws[0].abs().sum()) == 0.0
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 0}


@pytest.mark.gpu
def test_fused_mlp_wrapper_rejects_bad_stacks(cuda_device):
    ws, bs, x, g, acts = _stack("relu_plain", cuda_device)
    with pytest.raises(ValueError, match="is on"):
        fm.mlp_forward(ws, [b.cpu() for b in bs], x, acts)
    with pytest.raises(TypeError, match="float32"):
        fm.mlp_forward(ws, bs, x.double(), acts)
    with pytest.raises(ValueError, match="shape"):
        fm.mlp_forward(ws[::-1], bs[::-1], x, acts)
    wide = [torch.zeros((32, 1024), device=cuda_device), torch.zeros((1024, 1), device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        fm.mlp_forward(wide, [torch.zeros(1024, device=cuda_device), torch.zeros(1, device=cuda_device)],
                       x, acts)


@pytest.mark.gpu
def test_fused_mlp_refused_launch_raises(cuda_device, monkeypatch):
    """A stack past the card's shared memory, let through the wrapper's own
    check, is refused by the C side, and the wrapper raises."""
    monkeypatch.setattr(fm, "_MAX_SHARED_BYTES", 1 << 30)
    x = torch.zeros((40, 8), device=cuda_device)
    ws = [torch.zeros((8, 1024), device=cuda_device), torch.zeros((1024, 1), device=cuda_device)]
    bs = [torch.zeros(1024, device=cuda_device), torch.zeros(1, device=cuda_device)]
    fm.reset_launches()
    with pytest.raises(RuntimeError, match="fused_mlp_forward launch failed"):
        fm.mlp_forward(ws, bs, x, fm.mlp_acts(1, "relu"))
    with pytest.raises(RuntimeError, match="fused_mlp_backward launch failed"):
        fm.mlp_backward(ws, bs, x, torch.zeros((40, 1), device=cuda_device), fm.mlp_acts(1, "relu"), True)
    assert fm.LAUNCHES == {"fused_mlp_forward": 0, "fused_mlp_backward": 0}


@pytest.mark.gpu
def test_probe_is_exact(cuda_device):
    pr.reset_launches()
    pr.check_build(cuda_device)
    assert pr.LAUNCHES == {"probe": 1}
    x = torch.randn(pr.PROBE_SHAPE, device=cuda_device)
    assert torch.equal(pr.probe(x), 2 * x)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["siren", "relu_plain"])
def test_fused_model_gradients_on_card_match_cpu(model, cuda_device, full_fp32):
    """One model's parameters on the CPU and on the card: every parameter
    gradient, the hash table's (through dx) included, within 1e-4 of the
    largest."""
    rng = np.random.default_rng(4)
    if model == "siren":
        m = make_siren(3, dim_hidden=32, n_layers=3, device="cpu", seed=2)
        x = torch.from_numpy(rng.uniform(-1, 1, (700, 3)).astype(np.float32))
    else:
        m = make_hash_mlp(3, n_levels=4, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4,
                          finest_resolution=None, per_level_scale=1.5, dim_hidden=64, decoder="relu_plain",
                          device="cpu", seed=2)
        with torch.no_grad():  # a well-conditioned table, not the 1e-4 init
            m.encoder.table.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
        x = torch.from_numpy(rng.random((700, 3), dtype=np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        m.to(dev).zero_grad()
        m(x.to(dev)).square().mean().backward()
        grads[str(dev)] = {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()}
    for key, want in grads["cpu"].items():
        assert _share(grads[str(cuda_device)][key], want) <= 1e-4, key


# ---------------------------------------------------------------------------
# kernel 5's routes and block shapes (fm.forward_plan): route 1 (3xTF32 on the
# tensor cores) for sine, gelu and identity layers, route 2 (fp32 FMAs) for
# relu layers and for every layer of a stack too wide for route 1; widths 8
# to 832, first layers of K <= 8, last layers of N = 1, ragged batches that
# take each block shape. Tolerances as above.

FWD_SHAPES = {
    # name: (widths, acts, routes the plan gives)
    "sine_2_128x4_128": ([2] + [128] * 5, fm.siren_acts(4, 30.0, 30.0), (1,) * 5),
    "sine_3_64x3_1": ([3, 64, 64, 64, 1], fm.siren_acts(3, 30.0, 30.0), (1,) * 4),
    "relu_20_64_1": ([20, 64, 1], fm.mlp_acts(1, "relu"), (2, 1)),
    "relu_32_128_1": ([32, 128, 1], fm.mlp_acts(1, "relu"), (2, 1)),
    "relu_8_20_8_1": ([8, 20, 8, 1], fm.mlp_acts(2, "relu"), (2, 2, 1)),
    "gelu_8_200_136_3": ([8, 200, 136, 3], fm.mlp_acts(2, "gelu"), (1, 1, 1)),
    "id_5_7": ([5, 7], (("id",),), (1,)),
    "sine_3_352x2_1": ([3, 352, 352, 1], fm.siren_acts(2, 30.0, 30.0), (1, 1, 1)),
    "sine_3_800_1": ([3, 800, 1], fm.siren_acts(1, 30.0, 30.0), (2, 2)),
    "relu_8_832_3": ([8, 832, 3], fm.mlp_acts(1, "relu"), (2, 2)),
}
FWD_BATCHES = [1, 31, 65, 131_073]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", FWD_BATCHES)
@pytest.mark.parametrize("name", sorted(FWD_SHAPES))
def test_fused_forward_routes_match_plain_version(name, batch, cuda_device, full_fp32):
    widths, acts, routes = FWD_SHAPES[name]
    ws, bs, x, _, _ = _make_stack(widths, acts, batch, cuda_device)
    assert fm.forward_plan(widths, acts, batch).routes == routes
    tol = 1e-4 if any(a[0] == "sine" for a in acts) else 1e-5
    fm.reset_launches()
    y = fm.mlp_forward(ws, bs, x, acts)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {"fused_mlp_forward": 1, "fused_mlp_backward": 0}
    assert y.shape == (batch, widths[-1]) and bool(torch.isfinite(y).all())
    assert _share(y, fm.mlp_forward_reference(ws, bs, x, acts)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [4096, 8000, 123_904])
def test_fused_forward_block_shapes(batch, cuda_device, full_fp32):
    """The SIREN preset's stack at batches that pick 32-row blocks (a ring of
    4 weight chunks, then 2) and 64-row blocks, against the plain version."""
    widths, acts = [3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0)
    plan = fm.forward_plan(widths, acts, batch)
    assert (plan.rows, plan.ring) == {4096: (32, 4), 8000: (32, 2), 123_904: (64, 2)}[batch]
    ws, bs, x, _, _ = _make_stack(widths, acts, batch, cuda_device)
    assert _share(fm.mlp_forward(ws, bs, x, acts), fm.mlp_forward_reference(ws, bs, x, acts)) <= 1e-4


@pytest.mark.gpu
def test_relu_masks_come_from_the_fp32_route(cuda_device, full_fp32):
    """relu_masks' masks are the relu layer's own output > 0 from the fp32
    route (the z that kernel 6 repeats), bit for bit, at 123,904 rows; an
    identity layer in its place would take the tensor cores."""
    widths, acts = [20, 64, 1], fm.mlp_acts(1, "relu")
    ws, bs, x, _, _ = _make_stack(widths, acts, 123_904, cuda_device)
    assert fm.forward_plan(widths[:2], acts[:1], 123_904).routes == (fm.ROUTE_FP32,)
    assert fm.forward_plan(widths[:2], (("id",),), 123_904).routes == (fm.ROUTE_TC,)
    h = fm.mlp_forward(ws[:1], bs[:1], x, acts[:1])
    assert torch.equal(fm.relu_masks(ws, bs, x, acts)[0], h > 0)
    z = fm.mlp_forward_reference(ws[:1], bs[:1], x, (("id",),))
    assert _share(h, torch.clamp_min(z, 0.0)) <= 1e-5


# kernel 1 at L*F in {3, 4, 5, 20, 32}, F in {1, 2, 4, 8}, D = 1-4, ragged N:
# within 2e-6 of the plain version (of the largest value), and bitwise equal
# to kernel 3 on the coarse levels
ENCODE_SHAPES = {
    "d1_L3_F1": dict(dim=1, n_levels=3, n_features_per_level=1, log2_hashmap_size=8, base_resolution=(4,),
                     finest_resolution=(200,)),
    "d2_L4_F1": dict(dim=2, n_levels=4, n_features_per_level=1, log2_hashmap_size=12, base_resolution=8,
                     finest_resolution=None, per_level_scale=1.6),
    "d3_L5_F1": dict(dim=3, n_levels=5, n_features_per_level=1, log2_hashmap_size=14, base_resolution=(6, 6, 3),
                     finest_resolution=(60, 60, 12)),
    "d2_L10_F2": COARSE_MULTI_FRAME,
    "d3_L16_F2": OUTSIDE["tcnn"],
    "d4_L2_F4": dict(dim=4, n_levels=2, n_features_per_level=4, log2_hashmap_size=10, base_resolution=(3, 3, 2, 2),
                     finest_resolution=(9, 9, 5, 6)),
    "d2_L4_F8": dict(dim=2, n_levels=4, n_features_per_level=8, log2_hashmap_size=12, base_resolution=8,
                     finest_resolution=None, per_level_scale=1.6),
}
ENCODE_N = [3, 33, 4099, 131_075]


@pytest.mark.gpu
@pytest.mark.parametrize("n", ENCODE_N)
@pytest.mark.parametrize("name", sorted(ENCODE_SHAPES))
def test_encode_forward_shapes(name, n, cuda_device):
    cfg = ENCODE_SHAPES[name]
    enc, x, table, _ = _inputs(cfg, n, cuda_device, g_cols=1)
    x = 2 * x - 1 if n % 2 else x  # odd N: x in [-1, 1], where dense levels clamp and extrapolate
    he.reset_launches()
    y = he.hash_encode_forward(enc, table, x)
    torch.cuda.synchronize()
    assert he.LAUNCHES == {**ZERO, "hash_encode_forward": 1}
    ref = he.hash_encode_reference(enc, table, x)
    assert y.shape == ref.shape and float((y - ref).abs().max()) <= _forward_bound(ref)
    levels = he.coarse_onehot_levels(enc)
    if levels and levels == list(range(len(levels))):
        coarse = he.hash_encode_coarse_forward(enc, table, x)
        assert torch.equal(y[:, :coarse.shape[1]], coarse)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [2, 4])
def test_encode_forward_unaligned_table(f, cuda_device):
    """A table view that starts off 8 or 16 bytes gathers one float at a
    time, with the same result."""
    cfg = dict(ENCODE_SHAPES["d2_L4_F8"], n_features_per_level=f)
    enc, x, table, _ = _inputs(cfg, 4099, cuda_device, g_cols=1)
    flat = torch.empty(table.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(table.shape)
    shifted.copy_(table)
    assert shifted.data_ptr() % 8 != 0
    assert torch.equal(he.hash_encode_forward(enc, shifted, x), he.hash_encode_forward(enc, table, x))


# ---------------------------------------------------------------------------
# the dispatcher ops (ops/library.py) and a served artifact, on the card

OPS = ("hash_encode_forward", "hash_encode_table_grad", "hash_encode_coarse_forward",
       "hash_encode_coarse_table_grad", "fused_mlp_forward", "fused_mlp_backward")


def _op_args(name, device):
    """The op ``name`` and its arguments at small sizes on ``device``: the d2
    geometry (every level coarse) at 300 points, the siren_w0s stack."""
    enc, x, table, g = _inputs(CONFIGS["d2"], 300, device)
    key = list(enc.geometry_key())
    levels = he.coarse_onehot_levels(enc)
    ws, bs, mx, mg, acts = _stack("siren_w0s", device)
    params = [t for pair in zip(ws, bs) for t in pair]
    words = list(fm.act_words(acts))
    args = {
        "hash_encode_forward": (table, x, key),
        "hash_encode_table_grad": (x, g, key),
        "hash_encode_coarse_forward": (table, x, key, levels),
        "hash_encode_coarse_table_grad": (x, g[:, :len(levels) * enc.n_features_per_level].contiguous(), key, levels),
        "fused_mlp_forward": (mx, params, words),
        "fused_mlp_backward": (mx, mg, params, words, True),
    }[name]
    return getattr(torch.ops.mri_torch, name).default, args


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_op_schema_and_fake_impl_on_card(name, cuda_device):
    """Each op's CUDA impl against its schema (no input mutated or aliased)
    and its fake impl (the same output shapes, dtypes and devices)."""
    op, args = _op_args(name, cuda_device)
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


@pytest.mark.gpu
def test_exported_flagship_evaluator_on_card(cuda_device, tmp_path):
    """A flagship-shaped HashMLP (4 dense levels x F = 1, BatchNorm decoder)
    served from its ``.pt2`` on the card: equal to ``evaluate_grid``'s
    per-chunk route (kernel 1 a chunk) to 1e-6, kernel 1 launched once a
    chunk."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid, load_evaluator, save_evaluator

    model = make_hash_mlp(3, base_resolution=(4, 4, 2), finest_resolution=(24, 24, 8), dim_hidden=16,
                          device=cuda_device)
    shape, chunk = (20, 18, 9), 1024
    ref = evaluate_grid(model, shape, chunk_size=chunk, device=cuda_device, transform=lambda x: x)
    path = save_evaluator(str(tmp_path / "flagship.pt2"), model, shape, chunk_size=chunk)
    serve = load_evaluator(path)
    he.reset_launches()
    vol = serve()
    assert he.LAUNCHES == {**ZERO, "hash_encode_forward": -(-int(np.prod(shape)) // chunk)}
    assert vol.shape == shape
    np.testing.assert_allclose(vol, ref, rtol=0, atol=1e-6)
