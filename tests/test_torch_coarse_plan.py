"""Kernel 4's plan (``ops/hash_encode.py:coarse_grad_plan``) and its order of
summation, on the CPU.

On the card, ``hash_encode_coarse_table_grad`` walks the points in warps of
32 consecutive points; the lanes of a warp that hit one accumulator row sum
their terms pairwise in lane order and the group's lowest lane makes one
shared add (an atomic, or a plain add where each warp has its own copy of
the accumulator); after the points, each cluster of blocks sums its
accumulators in rank order, and each entry takes one global add per cluster. The kernel runs
only there; what is checked here is the plan it is given (grid, cluster,
groups of levels, shared bytes, refusals), the words it reads, and, through a
numpy emulation of that order, that it computes the JAX package's table
gradient of ``pallas_hash_encode_coarse`` (the one-hot Pallas kernels in
interpret mode, as tests/test_torch_hash_coarse.py runs them) within the
atomic bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu.ops.pallas import pallas_hash_encode_coarse
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.ops import hash_encode as he

OPT_IN = 232_448  # Hopper's shared memory per block (opt-in)
MULTI_FRAME = dict(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                   finest_resolution=None, per_level_scale=1.4)
GEOMETRIES = {
    # tests/test_torch_kernels_gpu.py COARSE
    "bench": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=14, base_resolution=(4, 4, 2),
                  finest_resolution=(16, 16, 8)),
    "paper": dict(dim=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=11, base_resolution=(3, 3, 2),
                  finest_resolution=(11, 11, 6), growth="paper"),
    "multi_frame": MULTI_FRAME,
    "multi_frame_f8": {**MULTI_FRAME, "n_features_per_level": 8},
    "d1": dict(dim=1, n_levels=3, n_features_per_level=8, log2_hashmap_size=5, base_resolution=(4,),
               finest_resolution=(64,)),
    # test_coarse_kernels_stage_levels_in_groups: 1,681 + 2,809 + 4,624 rows at F = 8 (max_rows 7,000)
    "groups": dict(dim=2, n_levels=4, n_features_per_level=8, log2_hashmap_size=16, base_resolution=40,
                   finest_resolution=None, per_level_scale=1.3),
}
# (geometry, N, max_rows, grid, cluster, copies, group ends, shared bytes) on an H100's 132 SMs
PLANS = [
    # one 352 x 352 frame: 3,778 rows x 2 x 4 bytes, one point a thread in 61 clusters
    ("multi_frame", 123_904, 2048, 488, 8, 1, (4,), 30_224),
    ("bench", 65_536, 2048, 256, 8, 8, (2,), 29_888),  # 75 + 392 rows: a copy a warp, 8 x 3,736 bytes
    ("bench", 8_192, 2048, 32, 8, 8, (2,), 29_888),  # the bench's gradient batch
    ("bench", 517, 2048, 4, 2, 8, (2,), 29_888),  # 3 blocks' points in two clusters of 2
    ("paper", 4_099, 2048, 24, 8, 1, (3,), 8_448),  # 48 + 144 + 864 rows: 8 copies would pass 48 KB
    ("multi_frame", 517, 2048, 2, 2, 1, (4,), 30_224),  # 16,544 updates for 7,556 entries: two blocks
    ("multi_frame", 20_000, 2048, 80, 8, 1, (4,), 30_224),
    ("multi_frame_f8", 20_000, 2048, 80, 8, 1, (4,), 120_896),  # past the 48 KB default: the opt-in
    ("d1", 4_099, 2048, 24, 8, 8, (3,), 10_752),  # 5 + 11 + 26 rows x 8 features, a copy a warp
    ("groups", 3_001, 7000, 2, 2, 1, (2, 3), 147_968),  # levels 0-1 (4,490 rows), then level 2 (4,624)
    ("multi_frame", 1, 2048, 1, 1, 1, (4,), 30_224),
    ("multi_frame", 10**7, 2048, 528, 8, 1, (4,), 30_224),  # four blocks an SM at most, 74 rounds
]


def _enc(name):
    return HashGridEncoding(**GEOMETRIES[name])


@pytest.mark.parametrize("name,n,max_rows,grid,cluster,copies,ends,shared", PLANS,
                         ids=[f"{p[0]}-{p[1]}" for p in PLANS])
def test_plan_of_each_geometry(name, n, max_rows, grid, cluster, copies, ends, shared):
    enc = _enc(name)
    levels = he.coarse_onehot_levels(enc, max_rows)
    sizes = [int(enc.level_sizes[l]) for l in levels]
    assert shared == copies * 4 * enc.n_features_per_level * max(
        sum(sizes[j0:j1]) for j0, j1 in zip((0, *ends[:-1]), ends))
    plan = he.coarse_grad_plan(enc, levels, n)
    assert plan == he.CoarseGradPlan(grid, cluster, copies, shared, ends)
    assert plan.grid % plan.cluster == 0 and plan.cluster in (1, 2, 4, 8)
    assert plan.grid <= he.COARSE_BLOCKS_PER_SM * he.H100_SMS and plan.shared_bytes <= OPT_IN
    # no block walks a round of points more than another, and no block more than one past the need
    rounds = -(-n // (plan.grid * he.COARSE_THREADS))
    assert plan.grid - plan.cluster < -(-n // (rounds * he.COARSE_THREADS)) <= plan.grid


def test_multi_frame_plan_words():
    enc = _enc("multi_frame")
    plan = he.coarse_grad_plan(enc, he.coarse_onehot_levels(enc), 123_904)
    words = he.coarse_plan_words(plan)
    assert words.dtype == np.int32 and words.tolist() == [488, 8, 1, 30_224, 1, 4]
    assert he.coarse_plan_words(plan) is words  # cached: one array for every call with this plan
    assert he.coarse_grad_plan(enc, [0, 1, 2, 3], 123_904) is plan


def test_plan_follows_the_card():
    """Fewer SMs, fewer blocks; accumulators that leave room for fewer than
    four blocks in an SM's shared memory give a grid of only those (no
    second wave of clusters)."""
    enc = _enc("multi_frame")
    levels = he.coarse_onehot_levels(enc)
    assert he.coarse_grad_plan(enc, levels, 123_904, sms=66).grid == 248  # 31 clusters, two rounds
    assert he.coarse_grad_plan(enc, levels, 123_904, sms=1).grid == 4  # a cluster of four blocks
    assert he.coarse_grad_plan(enc, levels, 10**7).grid == 528  # 30,224 bytes: four blocks an SM
    f8 = _enc("multi_frame_f8")  # 120,896 bytes a block: one an SM
    assert he.coarse_grad_plan(f8, levels, 10**7) == he.CoarseGradPlan(128, 8, 1, 120_896, (4,))
    assert he.coarse_grad_plan(f8, levels, 10**7, sms=66).grid == 64


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_every_plan_fits_the_card(f):
    """Every group fits the accumulators, every level is in one group, the
    grid is whole clusters of at most four blocks an SM, at any batch."""
    for dim, base in ((1, (8,)), (2, 16), (3, (4, 4, 2))):
        enc = HashGridEncoding(dim=dim, n_levels=8, n_features_per_level=f, log2_hashmap_size=16,
                               base_resolution=base, finest_resolution=None, per_level_scale=1.5)
        for max_rows in (2048, 7000):
            levels = he.coarse_onehot_levels(enc, max_rows)
            sizes = [int(enc.level_sizes[l]) for l in levels]
            if 4 * f * max(sizes) > OPT_IN:
                with pytest.raises(ValueError, match="shared memory"):
                    he.coarse_grad_plan(enc, levels, 1000)
                continue
            for n in (1, 255, 1000, 123_904, 10**7):
                plan = he.coarse_grad_plan(enc, levels, n)
                starts = (0, *plan.group_ends[:-1])
                assert plan.group_ends[-1] == len(levels) and all(a < b for a, b in zip(starts, plan.group_ends))
                for j0, j1 in zip(starts, plan.group_ends):
                    assert plan.copies * 4 * f * sum(sizes[j0:j1]) <= plan.shared_bytes <= OPT_IN
                assert plan.copies == 1 or (plan.copies == he.COARSE_WARPS and len(plan.group_ends) == 1
                                            and plan.shared_bytes <= he.COARSE_WARP_COPIES_BYTES)
                assert plan.cluster in (1, 2, 4, 8) and plan.grid % plan.cluster == 0
                assert 1 <= plan.grid <= he.COARSE_BLOCKS_PER_SM * he.H100_SMS
                assert plan.grid < -(-n // he.COARSE_THREADS) + plan.cluster  # no idle cluster


def test_a_level_past_shared_memory_is_refused():
    """The group geometry's level 3 (7,744 rows x 8 features, 248 KB) alone
    exceeds a block's shared memory: refused as the card test expects."""
    enc = _enc("groups")
    levels = he.coarse_onehot_levels(enc, 8000)
    assert int(enc.level_sizes[levels[-1]]) == 7744
    with pytest.raises(ValueError, match="shared memory"):
        he.coarse_grad_plan(enc, levels, 3001)


# ---------------------------------------------------------------------------
# the kernel's order of summation, emulated in numpy float32


def _warp_tree(terms):
    """Pairwise sum in lane order of one group's (m, F) terms: rank r takes
    rank r + s's partial for s = 1, 2, 4, ... where r % 2s == 0."""
    v = [t.copy() for t in terms]
    s = 1
    while s < len(v):
        for r in range(0, len(v) - s, 2 * s):
            v[r] = (v[r] + v[r + s]).astype(np.float32)
        s *= 2
    return v[0]


def emulate(enc, levels, x, g, plan):
    """Kernel 4's sums for one order its atomics may take: warps of 32
    consecutive points in order, each (level, corner)'s groups of equal rows
    summed by _warp_tree into the accumulator of the block that walks the
    warp (with ``plan.copies`` > 1, into that warp's own copy, and the
    block's copies then summed in warp order); then each cluster's
    accumulators summed in rank order, and the clusters' sums added to the
    fused gradient in cluster order."""
    F = enc.n_features_per_level
    ids, w = enc.corner_ids_and_weights(torch.from_numpy(x), levels)
    ids, w = ids.numpy(), w.numpy()
    gl = g.reshape(len(x), len(levels), F)
    sizes = [int(enc.level_sizes[l]) for l in levels]
    packed = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros((enc.total_size, F), dtype=np.float32)
    starts = (0, *plan.group_ends[:-1])
    for j0, j1 in zip(starts, plan.group_ends):
        acc = np.zeros((plan.grid, plan.copies, packed[j1] - packed[j0], F), dtype=np.float32)
        for p0 in range(0, len(x), 32):
            block = (p0 // he.COARSE_THREADS) % plan.grid
            copy = (p0 % he.COARSE_THREADS) // 32 if plan.copies > 1 else 0
            for j in range(j0, j1):
                rows = ids[p0:p0 + 32, j] - int(enc.level_offsets[levels[j]]) + packed[j] - packed[j0]
                for c in range(ids.shape[2]):
                    terms = (gl[p0:p0 + 32, j] * w[p0:p0 + 32, j, c:c + 1]).astype(np.float32)
                    for row in np.unique(rows[:, c]):
                        lanes = np.nonzero(rows[:, c] == row)[0]
                        acc[block, copy, row] = (acc[block, copy, row] + _warp_tree(terms[lanes])).astype(np.float32)
        blocks = acc[:, 0]
        for w in range(1, plan.copies):
            blocks = (blocks + acc[:, w]).astype(np.float32)
        for c0 in range(0, plan.grid, plan.cluster):
            total = np.zeros(blocks.shape[1:], dtype=np.float32)
            for r in range(plan.cluster):
                total = (total + blocks[c0 + r]).astype(np.float32)
            for j in range(j0, j1):
                dst = slice(int(enc.level_offsets[levels[j]]), int(enc.level_offsets[levels[j]] + sizes[j]))
                out[dst] = (out[dst] + total[packed[j] - packed[j0]:packed[j + 1] - packed[j0]]).astype(np.float32)
    return out


def _one_cell(n, dim, rng):
    return (0.5 + rng.uniform(0.0, 0.01, (n, dim))).astype(np.float32)


# (geometry, N, how x is drawn): a plan of several clusters, x in [-1, 1]
# (clamped cells, extrapolated weights), every point in one cell (trees of
# 32 lanes), one ragged warp
CASES = [("multi_frame", 900, "uniform"), ("bench", 700, "x in [-1, 1]"), ("bench", 600, "one cell"),
         ("paper", 517, "uniform")]


@pytest.mark.parametrize("name,n,how", CASES, ids=[f"{c}-{n}-{h.replace(' ', '_')}" for c, n, h in CASES])
def test_summation_order_computes_the_jax_table_gradient(name, n, how):
    cfg = {k: v for k, v in GEOMETRIES[name].items()}
    enc, jenc = HashGridEncoding(**cfg), JaxHashGrid(**cfg)
    levels = he.coarse_onehot_levels(enc)
    rng = np.random.default_rng(11)
    if how == "one cell":
        x = _one_cell(n, cfg["dim"], rng)
    else:
        lo = -1.0 if how == "x in [-1, 1]" else 0.0
        x = rng.uniform(lo, 1.0, (n, cfg["dim"])).astype(np.float32)
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    g = rng.standard_normal((n, len(levels) * cfg["n_features_per_level"])).astype(np.float32)
    # a plan of several clusters at this small N: the multi-frame batch's grid and cluster
    plan = he.coarse_grad_plan(enc, levels, n)._replace(grid=16, cluster=8)
    got = torch.from_numpy(emulate(enc, levels, x, g, plan))

    f = lambda t: pallas_hash_encode_coarse(jenc, {"table": t}, jnp.asarray(x), tile=256, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(f, jnp.asarray(table))
    want = torch.from_numpy(np.array(vjp(jnp.asarray(g))[0]))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    bound = he.atomic_sum_bound(he.table_grad_abs_sum(enc, xt, gt, levels), atol=1e-6)
    for ref in (want, he.hash_encode_coarse_table_grad_reference(enc, xt, gt)):
        assert float(((got - ref).abs() - bound).max()) <= 0.0
    coarse = np.zeros(enc.total_size, dtype=bool)
    for l in levels:
        coarse[enc.level_offsets[l]:enc.level_offsets[l + 1]] = True
    assert not got.numpy()[~coarse].any()


def test_warp_tree_adds_in_pairs_of_lane_order():
    t = np.array([[1.0], [2.0 ** -24], [2.0 ** -24], [-1.0], [3.0]], dtype=np.float32)
    # ((t0 + t1) + (t2 + t3)) + t4, each rounded to float32
    want = np.float32(np.float32(np.float32(1.0 + 2.0 ** -24) + np.float32(2.0 ** -24 - 1.0)) + 3.0)
    assert _warp_tree(t)[0] == want
