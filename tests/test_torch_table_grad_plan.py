"""The table gradient's per-level plan (``ops/hash_encode.py:table_grad_plan``).

On the card, ``hash_encode_table_grad`` adds the privatised levels through a
shared-memory accumulator (their rows packed one level after another) and the
others with global atomics, split into corner groups. The kernels run only
there; what is checked here is the plan they are given: which levels each
geometry privatises at its main path's batch, that the accumulator fits a
block's shared memory, the words the kernel reads, and, through a plain
emulation of the packing, that the split computes the JAX package's table
gradient (``HashGridEncoding.apply``'s VJP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.ops import hash_encode as he

OPT_IN = 232_448  # Hopper's shared memory per block (opt-in)

GEOMETRIES = {
    # the flagship (launcher defaults): 4 dense levels of 25k-59k rows, F = 1
    "flagship": dict(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                     base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15)),
    # path B's encoder (hashed16 in chip_smoke.py): 5 dense levels, 11 hashed, F = 2
    "tcnn16": dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                   base_resolution=16, finest_resolution=None, per_level_scale=1.4),
    # the multi-frame HashMLP (scripts/experiments.py:238-243): 10 dense levels, F = 2
    "multi_frame": dict(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17,
                        base_resolution=16, finest_resolution=None, per_level_scale=1.4),
    "d1": dict(dim=1, n_levels=3, n_features_per_level=8, log2_hashmap_size=5,
               base_resolution=(4,), finest_resolution=(64,)),
}
# (geometry, batch): the private levels, the global levels and the corner split
PLANS = [
    ("flagship", 10_000, (), (0, 1, 2, 3), 2),  # 80,000 corners over 25k+ rows a level: 3 a row at most
    ("tcnn16", 10_000, (), tuple(range(16)), 1),  # 4,913 rows at level 0: 16 a row
    ("multi_frame", 123_904, (0, 1, 2, 3), (4, 5, 6, 7, 8, 9), 1),  # one 352 x 352 frame: 256-1,715 a row
    ("multi_frame", 80_000, (0, 1, 2), tuple(range(3, 10)), 1),  # 320,000 corners: level 3 takes 165 a row
    ("d1", 4099, (0, 1, 2), (), 1),  # 5, 11 and 26 rows
    ("d1", 1500, (0, 1), (2,), 2),  # 1,500 threads: the most groups d = 1 has
]


@pytest.mark.parametrize("name,n,private,global_,split", PLANS, ids=[f"{p[0]}-{p[1]}" for p in PLANS])
def test_plan_of_each_geometry(name, n, private, global_, split):
    enc = HashGridEncoding(**GEOMETRIES[name])
    plan = he.table_grad_plan(enc, n)
    assert plan.private_levels == private and plan.global_levels == global_ and plan.corner_split == split
    sizes = [int(s) for s in enc.level_sizes]
    assert plan.shared_bytes == min(4 * enc.n_features_per_level * sum(sizes[l] for l in private),
                                    he.PRIVATE_MAX_BYTES)
    for l in private:  # dense, and at least PRIVATE_MIN_UPDATES updates a row
        assert enc.level_dense[l] and n * 2**enc.input_dim >= he.PRIVATE_MIN_UPDATES * sizes[l]


def test_multi_frame_plan_words():
    enc = HashGridEncoding(**GEOMETRIES["multi_frame"])
    plan = he.table_grad_plan(enc, 123_904)
    assert [int(s) for s in enc.level_sizes[:4]] == [289, 529, 1024, 1936]
    words = he.plan_words(enc, plan)
    assert words.dtype == np.int32
    assert words.tolist() == [4, 6, 1, 30_224,  # 3,778 rows x 2 features x 4 bytes
                              0, 1, 2, 3, 0, 289, 818, 1842, 4, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_shared_bytes_fit_a_block(f):
    """Every private level fits the accumulator, which fits half a block's
    opt-in shared memory, at any batch: two blocks share an SM."""
    for dim, base in ((1, (8,)), (2, 16), (3, 16)):
        enc = HashGridEncoding(dim=dim, n_levels=12, n_features_per_level=f, log2_hashmap_size=16,
                               base_resolution=base, finest_resolution=None, per_level_scale=1.5)
        for n in (1, 1000, 123_904, 10**7):
            plan = he.table_grad_plan(enc, n)
            assert set(plan.private_levels) | set(plan.global_levels) == set(range(12))
            assert not set(plan.private_levels) & set(plan.global_levels)
            assert plan.shared_bytes <= he.PRIVATE_MAX_BYTES <= OPT_IN // 2
            for l in plan.private_levels:
                assert 4 * f * int(enc.level_sizes[l]) <= plan.shared_bytes
            assert 1 <= plan.corner_split <= 2**dim


def test_corner_split_reaches_every_sm():
    """The fewest corner groups whose grid holds two 256-thread blocks an
    SM (the flagship's 4 levels: 4 * n * split threads)."""
    enc = HashGridEncoding(**GEOMETRIES["flagship"])
    assert he.MIN_GRID_THREADS == 2 * 132 * 256
    for n, split in ((2_000, 8), (5_000, 4), (10_000, 2), (16_000, 2), (17_000, 1), (123_904, 1)):
        plan = he.table_grad_plan(enc, n)
        assert plan.corner_split == split
        assert split == 8 or n * 4 * split >= he.MIN_GRID_THREADS  # enough threads
        assert split == 1 or n * 4 * (split // 2) < he.MIN_GRID_THREADS  # and no more groups than that takes


def emulate(enc, x, g, plan):
    """The two kernels' split in plain torch: the private levels' terms into
    one packed accumulator, each level's block of it then added at the
    level's offset, the global levels' terms straight into the table."""
    F = enc.n_features_per_level
    words = he.plan_words(enc, plan)
    n_private = len(plan.private_levels)
    packed = words[4 + n_private:4 + 2 * n_private]
    sizes, offsets = enc.level_sizes, enc.level_offsets
    acc = torch.zeros((int(sum(sizes[l] for l in plan.private_levels)), F))
    out = torch.zeros((enc.total_size, F))
    for p, l in enumerate(plan.private_levels):
        ids, terms = he._scatter_terms(enc, x, g[:, l * F:(l + 1) * F], [l])
        acc.index_add_(0, ids - int(offsets[l]) + int(packed[p]), terms)
    for p, l in enumerate(plan.private_levels):
        out[int(offsets[l]):int(offsets[l] + sizes[l])] += acc[int(packed[p]):int(packed[p] + sizes[l])]
    for l in plan.global_levels:
        ids, terms = he._scatter_terms(enc, x, g[:, l * F:(l + 1) * F], [l])
        out.index_add_(0, ids, terms)
    return out


@pytest.mark.parametrize("name,n,lo", [("multi_frame", 3000, 0.0), ("d1", 1500, 0.0), ("d1", 1500, -1.0)])
def test_split_computes_the_jax_table_gradient(name, n, lo):
    """Levels 0-3 of the multi-frame geometry privatised (as at a whole
    frame) and the rest global; d1 mixed; x in [-1, 1] clamps dense levels."""
    cfg = GEOMETRIES[name]
    enc = HashGridEncoding(**cfg)
    rng = np.random.default_rng(3)
    x = (rng.random((n, cfg["dim"]), dtype=np.float32) * (1.0 - lo) + lo).astype(np.float32)
    table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
    g = rng.standard_normal((n, enc.output_dim)).astype(np.float32)
    plan = he.table_grad_plan(enc, 123_904 if name == "multi_frame" else n)
    assert plan.private_levels and plan.global_levels
    got = emulate(enc, torch.from_numpy(x), torch.from_numpy(g), plan)

    jenc = JaxHashGrid(**cfg)
    _, vjp = jax.vjp(lambda t: jenc.apply({"table": t}, jnp.asarray(x)), jnp.asarray(table))
    want = torch.from_numpy(np.array(vjp(jnp.asarray(g))[0]))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    bound = he.atomic_sum_bound(he.table_grad_abs_sum(enc, xt, gt), atol=1e-6)
    for ref in (want, he.hash_encode_table_grad_reference(enc, xt, gt)):
        assert float(((got - ref).abs() - bound).max()) <= 0.0
