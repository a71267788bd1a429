"""Fused MLP stack, forward and backward: CUDA kernels and plain versions.

Port of ``mri_interpolation_tpu/ops/pallas/fused_mlp.py`` (the tcnn
FullyFusedMLP counterpart: ``fused_mlp_forward``/``fused_mlp_apply`` over a
``[{"w", "b"}, ...]`` layer list, and ``fused_siren_forward``/
``fused_siren_apply`` over the SIREN tree ``{"layers": [...], "last": {...}}``).
The kernels are in ``csrc/fused_mlp.cu`` (built by ``ops/build.py``, bound
with ctypes).

Layers keep the JAX layout: W_l is (dim_in, dim_out), b_l is (dim_out,), and
layer l computes ``act_l(h @ W_l + b_l)``. An activation is one of
``("sine", w0)`` (sin(w0 z)), ``("relu",)``, ``("gelu",)`` (the tanh
approximation) and ``("id",)``, exactly as the JAX module's ``_act`` /
``_act_grad``.

Dispatch: :func:`mlp_forward` and :func:`mlp_backward` call the ops
``torch.ops.mri_torch.fused_mlp_forward`` / ``fused_mlp_backward``
(``ops/library.py``), which take the layers as one list (w_0, b_0, w_1, ...)
and the activations as kind codes (:data:`ACT_CODES`) and sine frequencies
in one float list (:func:`act_words`). Their CPU impls are the plain
PyTorch versions (:func:`mlp_forward_reference`,
:func:`mlp_backward_reference`); their CUDA impls launch the kernels, or
raise. The CUDA impls add one to their entry of :data:`LAUNCHES` per call
that launches its kernel(s), and nowhere else.

The forward kernel routes each layer before launch, by activation and shape
(:func:`forward_plan`; the C side derives the layout from its choices and
refuses a plan that does not fit): relu layers on fp32
FMAs in the order that the backward repeats, sine, gelu and identity layers
on the tensor cores in 3xTF32, and every layer of a stack too wide for the
tensor-core route's shared memory on fp32. No route is a fallback: the plan
is fixed before the launch, and a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .build import H100_SMS

__all__ = [
    "LAUNCHES",
    "MAX_LAYERS",
    "ACT_CODES",
    "act_words",
    "reset_launches",
    "siren_acts",
    "mlp_acts",
    "act_apply",
    "act_grad",
    "mlp_forward",
    "mlp_backward",
    "mlp_forward_reference",
    "mlp_backward_reference",
    "relu_masks",
    "mlp_backward_reference_masked",
    "shared_bytes",
    "ForwardPlan",
    "forward_plan",
    "forward_plan_words",
    "scratch_shape",
    "FusedMLP",
    "fused_mlp_forward",
    "fused_mlp_apply",
    "fused_siren_forward",
    "fused_siren_apply",
]

LAUNCHES = {"fused_mlp_forward": 0, "fused_mlp_backward": 0}

MAX_LAYERS = 16  # csrc/fused_mlp.cu kMaxLayers
ACT_CODES = {"id": 0, "relu": 1, "gelu": 2, "sine": 3}  # csrc/fused_mlp.cu's activation kinds
# the widths both kernels take: two 32-row activation buffers of the widest
# layer (rounded up to 32) and one staged 32 x 128 weight chunk must fit
# Hopper's per-block limit (shared_bytes)
_TILE_ROWS, _CHUNK_K, _CHUNK_LD = 32, 32, 132
_MAX_SHARED_BYTES = 232448
# csrc/fused_mlp.cu, the forward: block shapes (tile rows of a block of 8
# warps, two blocks an SM); routes; the widest route-1 pass (column blocks
# of 8), its staged steps of 8, route 2's chunk depth
FWD_ROWS = (64, 32)
ROUTE_TC, ROUTE_FP32 = 1, 2
_FWD_MAX_NB, _FWD_STEPS, _FWD_CHUNK_K = 16, 4, 32
# route 1's ring of staged weight chunks: the deepest that fits the block's
# share of an SM (all of it where the grid has no more blocks than SMs,
# else _FWD_TWO_BLOCKS_BYTES, so that two blocks share one)
_FWD_RINGS = (8, 4, 2)
_FWD_TWO_BLOCKS_BYTES = 113 * 1024
# the backward: its largest row tile (the scratch is padded to it), the
# weight-gradient tile (dW in 128 x 128 blocks) and its staged rows
_BWD_MAX_TILE_ROWS, _GRAD_TILE, _GRAD_ROWS = 64, 128, 32
# weight-gradient blocks aimed for (about two per SM of an H100) and the
# fewest rows one of them sums
_GRAD_BLOCKS, _MIN_SLICE_ROWS = 264, 256

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

Act = Tuple  # ("sine", w0) | ("relu",) | ("gelu",) | ("id",)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def siren_acts(n_layers: int, w0: float, w0_initial: float) -> Tuple[Act, ...]:
    """Layer 0 sine(w0_initial), hidden layers sine(w0), identity output."""
    return tuple([("sine", float(w0_initial))] + [("sine", float(w0))] * (n_layers - 1) + [("id",)])


def mlp_acts(n_hidden: int, activation: str) -> Tuple[Act, ...]:
    """``activation`` between layers, identity output."""
    return tuple([(activation,)] * n_hidden + [("id",)])


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side yardstick)


def act_apply(a: Act, z: torch.Tensor) -> torch.Tensor:
    if a[0] == "sine":
        return torch.sin(a[1] * z)
    if a[0] == "relu":
        return torch.clamp_min(z, 0.0)
    if a[0] == "gelu":
        u = _SQRT_2_OVER_PI * (z + 0.044715 * (z * z * z))
        return 0.5 * z * (1.0 + torch.tanh(u))
    return z


def act_grad(a: Act, z: torch.Tensor) -> torch.Tensor:
    """d act / d z at the pre-activation z."""
    if a[0] == "sine":
        return a[1] * torch.cos(a[1] * z)
    if a[0] == "relu":
        return (z > 0.0).to(z.dtype)
    if a[0] == "gelu":
        u = _SQRT_2_OVER_PI * (z + 0.044715 * (z * z * z))
        t = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * (z * z))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    return torch.ones_like(z)


def mlp_forward_reference(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                          x: torch.Tensor, acts: Sequence[Act]) -> torch.Tensor:
    h = x
    for w, b, a in zip(weights, biases, acts):
        h = act_apply(a, h @ w + b)
    return h


def mlp_backward_reference(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                           x: torch.Tensor, g: torch.Tensor, acts: Sequence[Act], need_dx: bool
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor], Optional[torch.Tensor]]:
    """(dW per layer, db per layer, dx or None) for upstream g, as the kernel
    computes them: recompute the forward keeping every z, then
    dz = g * act'(z) and, layer by layer downwards, dW = h^T dz,
    db = sum(dz), dz = (dz W^T) * act'(z_prev); dx = dz_0 W_0^T."""
    return mlp_backward_reference_masked(weights, biases, x, g, acts, need_dx, {})


def relu_masks(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], x: torch.Tensor,
               acts: Sequence[Act]) -> dict:
    """{l: z_l > 0} for every relu layer l, as relu(z_l) > 0 (the same
    thing, NaN and -0 included) from :func:`mlp_forward` of the stack cut
    after layer l: on the card, kernel 5's fp32 route, whose order of
    additions the backward kernel repeats bit for bit for relu layers; on
    the CPU, the plain version. No autograd."""
    with torch.no_grad():
        return {l: mlp_forward(weights[:l + 1], biases[:l + 1], x, tuple(acts[:l + 1])) > 0
                for l, a in enumerate(acts) if a[0] == "relu"}


def mlp_backward_reference_masked(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                                  x: torch.Tensor, g: torch.Tensor, acts: Sequence[Act], need_dx: bool,
                                  masks: dict):
    """:func:`mlp_backward_reference` with the derivative of relu layer l
    taken from ``masks[l]`` (:func:`relu_masks`): the yardstick of a relu
    stack at sizes where some pre-activation lies within rounding of 0, so
    that two orders of additions disagree on its sign."""
    hs, zs = [x], []
    for w, b, a in zip(weights, biases, acts):
        zs.append(hs[-1] @ w + b)
        hs.append(act_apply(a, zs[-1]))

    def grad(l):
        return masks[l].to(x.dtype) if l in masks else act_grad(acts[l], zs[l])

    n_layers = len(weights)
    dws: List[Optional[torch.Tensor]] = [None] * n_layers
    dbs: List[Optional[torch.Tensor]] = [None] * n_layers
    dx = None
    dz = g * grad(n_layers - 1)
    for l in range(n_layers - 1, -1, -1):
        dws[l] = hs[l].T @ dz
        dbs[l] = dz.sum(dim=0)
        if l > 0:
            dz = (dz @ weights[l].T) * grad(l - 1)
        elif need_dx:
            dx = dz @ weights[0].T
    return dws, dbs, dx


# ---------------------------------------------------------------------------
# kernel wrappers


def _library() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    if lib.fused_mlp_forward.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.fused_mlp_forward.argtypes = [p, p, i64, i32, p, p, p, p, p, p, p, i64, p]
        lib.fused_mlp_backward.argtypes = [p, p, p, p, p, p, i64, i64, i32, p, p, p, p, p, p, p, p]
        for fn in (lib.fused_mlp_forward, lib.fused_mlp_backward):
            fn.restype = ctypes.c_int
        lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def shared_bytes(dims: Sequence[int]) -> int:
    """The widths the kernels take: two 32-row activation buffers of the
    widest layer (rounded up to 32) and one staged 32 x 128 weight chunk, as
    shared memory; a stack past ``_MAX_SHARED_BYTES`` is refused. Within it
    :func:`forward_plan` always finds a block shape that fits, and the
    backward's 32-row tiles fit."""
    ld = -(-max(dims) // _CHUNK_K) * _CHUNK_K
    return 4 * (2 * _TILE_ROWS * ld + _CHUNK_K * _CHUNK_LD)


class ForwardPlan(NamedTuple):
    """How the forward kernel runs a stack (:func:`forward_plan`). The
    kernel takes the choices (config, ring, routes: :func:`forward_plan_words`)
    and derives the rest itself (``csrc/fused_mlp.cu:pack_forward``); the
    rest is here for the choice and for the split scratch's size."""

    config: int  # index of FWD_ROWS (csrc/fused_mlp.cu: fwd_rows, fwd_warp_cols)
    rows: int  # a block's tile rows
    routes: Tuple[int, ...]  # per layer: ROUTE_TC (3xTF32 tensor cores) or ROUTE_FP32
    chunks: Tuple[int, ...]  # route 1: column blocks of 8 a pass; route 2: columns a chunk (0: N <= 8, a dot product)
    nbuf: int  # activation buffers: 1 (each layer writes over its input) or 2
    ring: int  # route 1's staged weight chunks in flight
    shared_bytes: int
    split_words: int  # 16-byte words of the split-weight scratch (route-1 layers)


def _fwd_chunk(route: int, n: int) -> int:
    if route == ROUTE_TC:
        return min(_FWD_MAX_NB, -(-n // 8))
    return 0 if n <= 8 else 32 if n <= 32 else 64 if n <= 64 else 128


def _fwd_layout(config: int, dims: Sequence[int], routes: Sequence[int], ring: int) -> ForwardPlan:
    rows = FWD_ROWS[config]
    ld = -(-max(dims) // 32) * 32
    nbuf = 1 if ld <= 128 else 2
    chunks = tuple(_fwd_chunk(r, n) for r, n in zip(routes, dims[1:]))
    wfloats, bias, split = 0, 0, 0
    for k, n, r, c in zip(dims[:-1], dims[1:], routes, chunks):
        if r == ROUTE_TC:
            wfloats = max(wfloats, ring * _FWD_STEPS * c * 32 * 4)  # ring stages of 4 steps, 4 words a fragment
            bias = 2 * ld  # two staged biases, by layer
            split += -(-n // (8 * _FWD_MAX_NB)) * -(-k // 8) * c * 32
        elif c:
            wfloats = max(wfloats, _FWD_CHUNK_K * (c + 4))
    smem = 4 * (nbuf * rows * (ld + 4) + wfloats + bias)
    return ForwardPlan(config, rows, tuple(routes), chunks, nbuf, ring, smem, split)


def _fwd_deepest(config: int, dims: Sequence[int], routes: Sequence[int], batch: int, sms: int) -> ForwardPlan:
    rows = FWD_ROWS[config]
    budget = _MAX_SHARED_BYTES if -(-batch // rows) <= sms else _FWD_TWO_BLOCKS_BYTES
    plans = [_fwd_layout(config, dims, routes, ring) for ring in _FWD_RINGS]
    return next((p for p in plans if p.shared_bytes <= budget), plans[-1])


def forward_plan(dims: Sequence[int], acts: Sequence[Act], batch: int, sms: int = H100_SMS) -> ForwardPlan:
    """The forward kernel's plan for the widths ``dims`` at ``batch`` rows
    on a card of ``sms`` SMs (a pure function of them, cached).

    Route per layer, by activation: relu on the CUDA cores in fp32, where
    the backward repeats its 0/1 mask bit for bit; sine, gelu and the
    identity on the tensor cores in 3xTF32. Block shape: of the shapes
    whose shared memory fits, the one of most rows that still gives a block
    per SM, else the one of fewest rows; for each, the deepest ring of
    route-1 weight chunks (``_fwd_deepest``). A stack that no shape holds
    with route-1 weight stages (the widest ones) takes route 2 for every
    layer. Where nothing fits (a stack past ``shared_bytes``'s limit), the
    last shape, which the kernel refuses."""
    return _forward_plan(tuple(int(d) for d in dims), tuple(tuple(a) for a in acts), int(batch), int(sms))


@functools.lru_cache(maxsize=1024)
def _forward_plan(dims: Tuple[int, ...], acts: Tuple[Act, ...], batch: int, sms: int) -> ForwardPlan:
    mixed = tuple(ROUTE_FP32 if a[0] == "relu" else ROUTE_TC for a in acts)
    for routes in (mixed, (ROUTE_FP32,) * len(acts)):
        plans = [_fwd_deepest(c, dims, routes, batch, sms) for c in range(len(FWD_ROWS))]
        fits = [p for p in plans if p.shared_bytes <= _MAX_SHARED_BYTES]
        if fits:
            full = [p for p in fits if -(-batch // p.rows) >= sms]
            return full[0] if full else min(fits, key=lambda p: p.rows)
    return _fwd_layout(len(FWD_ROWS) - 1, dims, (ROUTE_FP32,) * len(acts), _FWD_RINGS[-1])


@functools.lru_cache(maxsize=1024)
def forward_plan_words(plan: ForwardPlan):
    """The plan's choices as the kernel reads them (int32): block shape,
    ring depth, then the route of each layer. Read only by the kernel's
    host side, so one array serves every call with this plan."""
    words = [plan.config, plan.ring, *plan.routes]
    return (ctypes.c_int32 * len(words))(*words)


def _chain(weights, biases, x, acts) -> List[int]:
    """Validate the stack for the kernels; return the widths [K_0, N_0, ..., N_{L-1}]."""
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS or len(biases) != n_layers or len(acts) != n_layers:
        raise ValueError(f"the kernels take 1 to {MAX_LAYERS} layers with one bias and one "
                         f"activation each; got {n_layers} weights, {len(biases)} biases, {len(acts)} acts")
    dims = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    for l, (w, b, a) in enumerate(zip(weights, biases, acts)):
        build.check_tensor(f"weights[{l}]", w, (dims[l], dims[l + 1]), x.device)
        build.check_tensor(f"biases[{l}]", b, (dims[l + 1],), x.device)
        if a[0] not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r}")
    build.check_tensor("x", x, (x.shape[0], dims[0]), x.device)
    if shared_bytes(dims) > _MAX_SHARED_BYTES:
        raise ValueError(f"widths {dims} need {shared_bytes(dims)} bytes of shared memory per block; "
                         f"the card gives {_MAX_SHARED_BYTES}")
    return dims


def _layer_arrays(dims, acts, weights, biases):
    n = len(weights)
    return ((ctypes.c_int32 * (n + 1))(*dims),
            (ctypes.c_int32 * n)(*(ACT_CODES[a[0]] for a in acts)),
            (ctypes.c_float * n)(*(float(a[1]) if a[0] == "sine" else 0.0 for a in acts)),
            (ctypes.c_void_p * n)(*(w.data_ptr() for w in weights)),
            (ctypes.c_void_p * n)(*(b.data_ptr() for b in biases)))


def _raise_on(lib: ctypes.CDLL, fn_name: str, err: int) -> None:
    if err != 0:
        msg = lib.fused_mlp_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (cudaError {err})")


def _rows_per_slice(batch: int, dims: Sequence[int]) -> int:
    """Rows one weight-gradient block sums: enough slices of the batch that
    the blocks (one per 128 x 128 tile of a dW and slice) fill the card,
    none of fewer than 256 rows, a multiple of 32."""
    tiles = sum(-(-k // _GRAD_TILE) * -(-n // _GRAD_TILE) for k, n in zip(dims[:-1], dims[1:]))
    slices = max(1, min(-(-_GRAD_BLOCKS // tiles), batch // _MIN_SLICE_ROWS))
    rows = -(-batch // slices)
    return -(-rows // _GRAD_ROWS) * _GRAD_ROWS


def scratch_shape(batch: int, dims: Sequence[int]) -> Tuple[int, int, int]:
    """(rows, width, hidden width) of the backward's scratch: act'(z_l) and
    dz_l of every layer (width), h_{l+1} = act(z_l) of every layer but the
    last (hidden width). Rows: the batch rounded up to the largest row tile;
    every layer's width rounded up to 4 floats, so that each layer's block
    of a row starts on 16 bytes."""
    rows = -(-batch // _BWD_MAX_TILE_ROWS) * _BWD_MAX_TILE_ROWS
    padded = [-(-n // 4) * 4 for n in dims[1:]]
    return rows, sum(padded), sum(padded[:-1])


def _forward_kernel(weights, biases, x, acts) -> torch.Tensor:
    dims = _chain(weights, biases, x, acts)
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    lib = _library()
    plan = forward_plan(dims, acts, n, build.sm_count(x.device.index))
    # the split weights' scratch; none where no layer takes the tensor cores (a relu stack), which the
    # kernel's host side accepts (csrc/fused_mlp.cu:pack_forward)
    split = torch.empty((plan.split_words, 4), dtype=torch.int32, device=x.device) if plan.split_words else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_mlp_forward(x.data_ptr(), out.data_ptr(), n, len(weights),
                                    *_layer_arrays(dims, acts, weights, biases), forward_plan_words(plan),
                                    None if split is None else split.data_ptr(), plan.split_words, stream)
    _raise_on(lib, "fused_mlp_forward", err)
    if n > 0:
        LAUNCHES["fused_mlp_forward"] += 1
    return out


def _backward_kernel(weights, biases, x, g, acts, need_dx):
    dims = _chain(weights, biases, x, acts)
    n = x.shape[0]
    build.check_tensor("g", g, (n, dims[-1]), x.device)
    dws = [torch.zeros_like(w) for w in weights]
    dbs = [torch.zeros_like(b) for b in biases]
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device) if need_dx else None
    rows, width, hidden = scratch_shape(n, dims)
    dact, dzs = (torch.empty((rows, width), dtype=torch.float32, device=x.device) for _ in range(2))
    hact = torch.empty((rows, hidden), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_mlp_backward(
            x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None, dact.data_ptr(), hact.data_ptr(),
            dzs.data_ptr(),
            n, _rows_per_slice(max(n, 1), dims), len(weights),
            *_layer_arrays(dims, acts, weights, biases),
            (ctypes.c_void_p * len(dws))(*(t.data_ptr() for t in dws)),
            (ctypes.c_void_p * len(dbs))(*(t.data_ptr() for t in dbs)), stream)
    _raise_on(lib, "fused_mlp_backward", err)
    if n > 0:
        LAUNCHES["fused_mlp_backward"] += 1
    return dws, dbs, dx


def act_words(acts: Sequence[Act]) -> Tuple[float, ...]:
    """The ops' form of an activation stack: per layer its kind code
    (:data:`ACT_CODES`) and its sine frequency (0.0 where the layer is not a
    sine), in one float list (every list argument costs the dispatcher host
    time: ``ops/library.py``). Cached; raises ValueError on an unknown
    activation."""
    try:
        return _act_words(acts)
    except TypeError:  # a list, unhashable
        return _act_words(tuple(tuple(a) for a in acts))


@functools.lru_cache(maxsize=1024)
def _act_words(acts: Tuple[Act, ...]) -> Tuple[float, ...]:
    for a in acts:
        if a[0] not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r}")
    return tuple(w for a in acts for w in (float(ACT_CODES[a[0]]), float(a[1]) if a[0] == "sine" else 0.0))


@functools.lru_cache(maxsize=1024)
def _acts_of(words: Tuple[float, ...]) -> Tuple[Act, ...]:
    """:func:`act_words` undone."""
    names = {code: name for name, code in ACT_CODES.items()}
    kinds = [names[int(k)] for k in words[0::2]]
    return tuple((k, w) if k == "sine" else (k,) for k, w in zip(kinds, words[1::2]))


def mlp_forward(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], x: torch.Tensor,
                acts: Sequence[Act]) -> torch.Tensor:
    """The stack applied to x (B, K_0) -> (B, N_L), through the op
    ``fused_mlp_forward`` (the layers as one list, w_0, b_0, w_1, b_1, ...):
    CUDA tensors launch the forward kernel; CPU tensors take the plain
    version."""
    params = [t for pair in zip(weights, biases) for t in pair]
    return torch.ops.mri_torch.fused_mlp_forward.default(x, params, act_words(acts))


def _forward_cpu(x, params, acts) -> torch.Tensor:
    return mlp_forward_reference(params[0::2], params[1::2], x, _acts_of(tuple(acts)))


def _forward_cuda(x, params, acts) -> torch.Tensor:
    return _forward_kernel(params[0::2], params[1::2], x, _acts_of(tuple(acts)))


def mlp_backward(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], x: torch.Tensor,
                 g: torch.Tensor, acts: Sequence[Act], need_dx: bool = False):
    """(dW list, db list, dx or None) for upstream g (B, N_L), through the op
    ``fused_mlp_backward`` (one list: dW_0, db_0, dW_1, db_1, ..., then dx
    where ``need_dx``): CUDA tensors launch the backward kernels; CPU tensors
    take the plain version."""
    params = [t for pair in zip(weights, biases) for t in pair]
    grads = torch.ops.mri_torch.fused_mlp_backward.default(x, g, params, act_words(acts), need_dx)
    n = len(params)
    return grads[0:n:2], grads[1:n:2], (grads[n] if need_dx else None)


def _flat_grads(dws, dbs, dx) -> List[torch.Tensor]:
    return [*(t for pair in zip(dws, dbs) for t in pair), *(() if dx is None else (dx,))]


def _backward_cpu(x, g, params, acts, need_dx) -> List[torch.Tensor]:
    return _flat_grads(*mlp_backward_reference(params[0::2], params[1::2], x, g, _acts_of(tuple(acts)), need_dx))


def _backward_cuda(x, g, params, acts, need_dx) -> List[torch.Tensor]:
    return _flat_grads(*_backward_kernel(params[0::2], params[1::2], x, g, _acts_of(tuple(acts)), need_dx))


class FusedMLP(torch.autograd.Function):
    """Differentiable stack: ``FusedMLP.apply(x, acts, w_0, b_0, ..., w_L, b_L)``.
    The forward launches kernel 5, the backward kernel 6, which returns dW
    and db for every layer and dx only when x needs a gradient (the JAX
    ``need_dx``): SIREN's coordinates get none, an encoder's features do."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, acts: Tuple[Act, ...], *params: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        ctx.acts = acts
        ctx.save_for_backward(x, *params)
        return torch.ops.mri_torch.fused_mlp_forward.default(x, list(params), act_words(acts))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, *params = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dws, dbs, dx = mlp_backward(params[0::2], params[1::2], x, g.contiguous(), ctx.acts, need_dx)
        grads = [t for pair in zip(dws, dbs) for t in pair]
        grads = [t if ctx.needs_input_grad[2 + i] else None for i, t in enumerate(grads)]
        return (dx if need_dx else None, None, *grads)


def _flat(layers) -> List[torch.Tensor]:
    return [t for layer in layers for t in (layer["w"], layer["b"])]


def _siren_layers(params, n_layers: int):
    return [params["layers"][i] for i in range(n_layers)] + [params["last"]]


def fused_mlp_forward(layers, x: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """Inference forward over a ``[{"w", "b"}, ...]`` layer list:
    ``activation`` between layers, identity output (no autograd)."""
    acts = mlp_acts(len(layers) - 1, activation)
    with torch.no_grad():
        return mlp_forward([l["w"] for l in layers], [l["b"] for l in layers], x, acts)


def fused_mlp_apply(layers, x: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """Differentiable :func:`fused_mlp_forward` (wrt the layers, and wrt x
    when x needs a gradient)."""
    return FusedMLP.apply(x, mlp_acts(len(layers) - 1, activation), *_flat(layers))


def fused_siren_forward(params, x: torch.Tensor, n_layers: int, w0: float, w0_initial: float) -> torch.Tensor:
    """Inference forward of the SIREN tree ``{"layers": [...], "last": {...}}``."""
    layers = _siren_layers(params, n_layers)
    with torch.no_grad():
        return mlp_forward([l["w"] for l in layers], [l["b"] for l in layers], x,
                           siren_acts(n_layers, w0, w0_initial))


def fused_siren_apply(params, x: torch.Tensor, n_layers: int, w0: float, w0_initial: float) -> torch.Tensor:
    """Differentiable fused SIREN stack; the same function as
    ``models.siren._siren_forward``."""
    return FusedMLP.apply(x, siren_acts(n_layers, w0, w0_initial), *_flat(_siren_layers(params, n_layers)))
