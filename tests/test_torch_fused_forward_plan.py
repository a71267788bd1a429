"""The fused-MLP forward kernel's host-side plan (``ops/fused_mlp.py:
forward_plan``), checked on the CPU: the route of each layer, the block
shape, the chunk widths and the shared memory, for every stack that the
kernels take (widths 8-832, depths 1-16) and for each main-path stack; and
``relu_masks``' routing to the fp32 route. The kernel takes the plan's
choices and derives the same layout (``csrc/fused_mlp.cu:pack_forward``),
and the card tests (``tests/test_torch_kernels_gpu.py``) hold each route
against the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.ops import fused_mlp as fm

TC, FP32 = fm.ROUTE_TC, fm.ROUTE_FP32
LIMIT = 232_448  # Hopper's shared memory per block


def _acts(kind, depth):
    if kind == "sine":
        return fm.siren_acts(depth - 1, 30.0, 30.0)
    return fm.mlp_acts(depth - 1, kind)


def _check(dims, acts, batch):
    plan = fm.forward_plan(dims, acts, batch)
    assert plan.shared_bytes <= LIMIT, (dims, plan)
    assert plan.rows == fm.FWD_ROWS[plan.config]
    ld = -(-max(dims) // 32) * 32
    assert plan.nbuf == (1 if ld <= 128 else 2)
    for a, r in zip(acts, plan.routes):
        if a[0] == "relu":
            assert r == FP32  # relu's mask stays the fp32 one that the backward repeats
    if TC in plan.routes:
        assert all(r == TC for a, r in zip(acts, plan.routes) if a[0] != "relu")
    else:  # a stack too wide for route 1 takes route 2 throughout
        assert plan.split_words == 0
    for r, n, c in zip(plan.routes, dims[1:], plan.chunks):
        if r == TC:  # a pass of c column blocks of 8: the layer's columns, at most 128 of them
            assert 1 <= c <= 16 and (8 * c >= n if n <= 128 else c == 16)
        else:  # columns a chunk: the fewest of 32, 64, 128 that hold N (a dot product for N <= 8)
            assert c == 0 if n <= 8 else c in (32, 64, 128) and (c >= n or c == 128) and (c == 32 or c // 2 < n)
    return plan


WIDTHS = [8, 20, 32, 64, 100, 128, 160, 200, 256, 352, 512, 736, 800, 832]


@pytest.mark.parametrize("kind", ["sine", "relu", "gelu", "id"])
@pytest.mark.parametrize("width", WIDTHS)
def test_every_accepted_stack_has_a_plan_that_fits(kind, width):
    for depth in (1, 2, 3, 16):
        for k0, n_out in ((2, 1), (3, 128), (8, 3), (32, width)):
            dims = [k0] + [width] * (depth - 1) + [n_out]
            if fm.shared_bytes(dims) > LIMIT:
                continue
            for batch in (1, 4096, 10_000, 123_904):
                _check(dims, _acts(kind, depth), batch)


def test_the_widest_accepted_stack_and_the_first_refused():
    assert fm.shared_bytes([8, 832, 3]) <= LIMIT < fm.shared_bytes([8, 864, 3])
    plan = _check([8, 832, 3], fm.mlp_acts(1, "relu"), 100)
    assert (plan.rows, plan.routes, plan.chunks) == (32, (FP32, FP32), (128, 0))
    # past the limit the plan is the last block shape, which the kernel refuses
    assert fm.forward_plan([8, 1024, 1], fm.mlp_acts(1, "relu"), 40).shared_bytes > LIMIT


MAIN = {
    # name: (dims, acts, batch, (rows, routes, chunks, nbuf))
    "A step": ([3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0), 4096, (32, (TC,) * 7, (16,) * 6 + (1,), 1)),
    "A grid chunk": ([3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0), 1 << 17,
                     (64, (TC,) * 7, (16,) * 6 + (1,), 1)),
    "B step": ([32, 128, 1], fm.mlp_acts(1, "relu"), 10_000, (64, (FP32, TC), (128, 1), 1)),
    "B grid chunk": ([32, 128, 1], fm.mlp_acts(1, "relu"), 1 << 17, (64, (FP32, TC), (128, 1), 1)),
    "multi_siren encoder": ([2] + [128] * 5, fm.siren_acts(4, 30.0, 30.0), 123_904, (64, (TC,) * 5, (16,) * 5, 1)),
    "multi_siren decoder": ([128] * 5 + [1], fm.siren_acts(4, 30.0, 30.0), 123_904,
                            (64, (TC,) * 5, (16,) * 4 + (1,), 1)),
    "multi_hash decoder": ([20, 64, 1], fm.mlp_acts(1, "relu"), 123_904, (64, (FP32, TC), (64, 1), 1)),
    "bench siren": ([3, 64, 64, 64, 1], fm.siren_acts(3, 30.0, 30.0), 65_536, (64, (TC,) * 4, (8, 8, 8, 1), 1)),
    "siren 352x5": ([3] + [352] * 5 + [1], fm.siren_acts(5, 30.0, 30.0), 20_000,
                    (32, (TC,) * 6, (16,) * 5 + (1,), 2)),
    # too wide for route 1's weight stages beside two 32-row buffers: route 2 throughout
    "sine 3-800-1": ([3, 800, 1], fm.siren_acts(1, 30.0, 30.0), 20_000, (32, (FP32,) * 2, (128, 0), 2)),
}


@pytest.mark.parametrize("name", sorted(MAIN))
def test_main_path_plans(name):
    dims, acts, batch, (rows, routes, chunks, nbuf) = MAIN[name]
    plan = _check(dims, acts, batch)
    assert (plan.rows, plan.routes, plan.chunks, plan.nbuf) == (rows, routes, chunks, nbuf)


def test_plan_words_layout():
    plan = fm.forward_plan([32, 128, 1], fm.mlp_acts(1, "relu"), 10_000)
    assert (plan.nbuf, plan.chunks) == (1, (128, 1))
    # the kernel takes the choices (block shape, ring, routes) and derives the rest
    assert list(fm.forward_plan_words(plan)) == [plan.config, plan.ring, FP32, TC]
    # split words of the route-1 layer 128 -> 1: 16 steps of 8 x 1 column block x 32 lanes
    assert plan.split_words == 16 * 1 * 32
    # shared memory: one 64-row buffer of 128 + 4 floats, a ring of 8 route-1 stages of 4 steps x 1 column block,
    # one route-2 chunk of 32 x 132 floats (the larger), two staged biases
    assert (plan.rows, plan.ring) == (64, 8)
    assert plan.shared_bytes == 4 * (64 * 132 + max(8 * 4 * 1 * 32 * 4, 32 * 132) + 2 * 128)


def test_ring_depth():
    """Route 1's ring of weight chunks: as deep as two blocks an SM allow
    where the grid has more blocks than SMs (multi_siren's encoder: 1,936
    blocks of 64 rows), as deep as fits where it has fewer (path A's step:
    128 blocks of 32 rows, half of a 128-wide layer in flight)."""
    enc = fm.forward_plan([2] + [128] * 5, fm.siren_acts(4, 30.0, 30.0), 123_904)
    assert (enc.rows, enc.ring) == (64, 2) and enc.shared_bytes <= 113 * 1024
    step = fm.forward_plan([3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0), 4096)
    assert (step.rows, step.ring) == (32, 4) and 113 * 1024 < step.shared_bytes <= LIMIT


def test_plan_is_cached_and_follows_the_sm_count():
    """forward_plan is a pure function of (widths, activations, batch, SMs),
    cached: one plan object and one word array serve every call. Blocks
    take the most rows that still give one block per SM: 4,096 rows are 64
    blocks of 64 rows, enough for a card of 64 SMs, not for an H100's 132."""
    dims, acts = [3] + [128] * 6 + [1], fm.siren_acts(6, 30.0, 30.0)
    plan = fm.forward_plan(dims, acts, 4096)
    assert fm.forward_plan(tuple(dims), list(acts), 4096) is plan
    assert fm.forward_plan_words(plan) is fm.forward_plan_words(plan)
    assert fm.forward_plan(dims, acts, 4096, sms=fm.H100_SMS) is plan and plan.rows == 32
    assert fm.forward_plan(dims, acts, 4096, sms=64).rows == 64


def test_relu_masks_take_the_fp32_route(monkeypatch):
    """relu_masks cuts the stack after each relu layer and asks the forward
    for that stack as it is: the plan routes its relu layers to fp32 (an
    identity layer would take the tensor cores, whose z the backward does
    not repeat), and relu(z) > 0 is z > 0."""
    rng = np.random.default_rng(0)
    dims = [20, 64, 64, 1]
    ws = [torch.from_numpy(rng.uniform(-0.3, 0.3, (k, n)).astype(np.float32)) for k, n in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.uniform(-0.3, 0.3, (n,)).astype(np.float32)) for n in dims[1:]]
    x = torch.from_numpy(rng.uniform(-1, 1, (300, 20)).astype(np.float32))
    acts = fm.mlp_acts(2, "relu")
    seen = []
    real = fm.mlp_forward

    def recording(w, b, xx, a):
        seen.append(tuple(a))
        return real(w, b, xx, a)

    monkeypatch.setattr(fm, "mlp_forward", recording)
    masks = fm.relu_masks(ws, bs, x, acts)
    assert seen == [(("relu",),), (("relu",), ("relu",))]
    for l, a in enumerate(seen):
        assert fm.forward_plan(dims[:l + 2], a, 300).routes == (FP32,) * (l + 1)
        assert fm.forward_plan(dims[:l + 2], a[:-1] + (("id",),), 300).routes[-1] == TC
    # on the CPU, the plain version: the masks are z > 0
    h = x
    for l in range(2):
        z = h @ ws[l] + bs[l]
        assert torch.equal(masks[l], z > 0)
        h = torch.clamp_min(z, 0.0)


def test_relu_masks_are_z_positive_at_nan_and_signed_zeros():
    """relu(z) > 0 is z > 0 where z is NaN, -0, +0 or a subnormal of either
    sign (torch's clamp keeps NaN, the kernel's fmaxf(z, 0) gives 0: neither
    is > 0)."""
    z = torch.tensor([float("nan"), -0.0, 0.0, 1e-40, -1e-40, 2.0, -2.0])
    ws, bs = [torch.zeros((3, 7))], [z]
    masks = fm.relu_masks(ws, bs, torch.ones((4, 3)), (("relu",),))
    assert list(masks) == [0]
    assert torch.equal(masks[0], (z > 0).expand(4, 7))
    assert masks[0][0].tolist() == [False, False, False, True, False, True, False]


def _sin_reduced_constants():
    """The fp32 constants of csrc/fused_mlp.cu:sin_reduced, in source order."""
    src = (Path(fm.__file__).parent / "csrc" / "fused_mlp.cu").read_text()
    body = src[src.index("float sin_reduced(float a) {"):]
    body = body[:body.index("\n}\n")]
    return [np.float32(v) for v in re.findall(r"(-?\d\.\d+e[+-]\d+)f", body)]


def _sin_reduced(a, consts):
    """sin_reduced emulated in float32 (each fmaf as a float64 product and
    sum, rounded once to float32)."""
    f32 = np.float32

    def fma(x, y, z):
        return (x.astype(np.float64) * np.float64(y) + z.astype(np.float64)).astype(f32) if np.ndim(y) == 0 else \
            (x.astype(np.float64) * y.astype(np.float64) + z.astype(np.float64)).astype(f32)

    (inv, c1, c2, c3, s0, s1, s2, s3, k0, k1, k2, k3, k4) = consts
    j = np.rint((a * inv).astype(f32)).astype(f32)
    q = j.astype(np.int64)
    r = fma(j, c1, a)
    r = fma(j, c2, r)
    r = fma(j, c3, r)
    s = (r * r).astype(f32)
    ps = np.full_like(a, s0)
    for c in (s1, s2, s3):
        ps = fma(ps, s, np.full_like(a, c))
    ps = fma(ps, (r * s).astype(f32), r)
    pc = np.full_like(a, k0)
    for c in (k1, k2, k3, k4):
        pc = fma(pc, s, np.full_like(a, c))
    v = np.where(q & 1, pc, ps)
    return np.where(q & 2, -v, v).astype(f32)


@pytest.mark.parametrize("bound", [1.0, 50.0, 105_615.0])
def test_sin_reduced_is_as_accurate_as_sinf(bound):
    """Route 1's sine (csrc/fused_mlp.cu:sin_reduced, its constants read from
    the source) stays within 1.5 ulp of sin over its domain, as sinf does
    (CUDA documents 2 ulp); the first SIREN layer's arguments reach ~40 rad."""
    consts = _sin_reduced_constants()
    assert len(consts) == 13
    x = np.random.default_rng(0).uniform(-bound, bound, 400_000).astype(np.float32)
    want = np.sin(x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert float((np.abs(_sin_reduced(x, consts).astype(np.float64) - want) / ulp).max()) <= 1.5
