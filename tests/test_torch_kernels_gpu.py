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


def _inputs(cfg, n, device, g_cols=None):
    """Encoder, x in [0, 1) (0 and 1 in the first two rows), a U(-1, 1)
    table and an N(0, 1) cotangent of ``g_cols`` columns (default all levels')."""
    rng = np.random.default_rng(0)
    enc = HashGridEncoding(**cfg)
    x = rng.random((n, cfg["dim"]), dtype=np.float32)
    x[0], x[1] = 0.0, 1.0
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
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), he.table_grad_abs_sum(enc, x, g))


def _assert_within_atomic_bound(got, want, abs_sum):
    bound = he.atomic_sum_bound(abs_sum)
    excess = ((got - want).abs() - bound).max()
    assert float(excess) <= 0.0, f"max |kernel - plain| exceeds the per-row bound by {float(excess)}"


def _forward_bound(ref):
    return 2e-6 * max(1.0, float(ref.abs().max()))


OUTSIDE = {**{k: CONFIGS[k] for k in ("flagship", "d2", "hashed")},
           "tcnn": dict(dim=3, n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=16,
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
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), he.table_grad_abs_sum(enc, x, g))


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
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), he.table_grad_abs_sum(enc, x, g))


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
    _assert_within_atomic_bound(dt, he.hash_encode_table_grad_reference(enc, x, g), he.table_grad_abs_sum(enc, x, g))


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
    _assert_within_atomic_bound(dt, he.hash_encode_coarse_table_grad_reference(enc, x, g, max_rows),
                                he.table_grad_abs_sum(enc, x, g, levels))


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
    _assert_within_atomic_bound(grads[str(cuda_device)], grads["cpu"], he.table_grad_abs_sum(enc, x, g, range(4)))
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
