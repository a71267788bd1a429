"""The plain reference the benchmark judges the port by.

Plain PyTorch, written from the published semantics of the hash-grid
HashMLP (Instant-NGP's multiresolution grid, tcnn's spatial hash, the
reference repository's decoders) and imported from nothing of the port:
the level geometry, the corners and their multilinear weights, the
encoding, the two decoders, the MSE loss, Adam (torch's formula, with
tcnn's betas where asked) under the cosine decay, and the grid
coordinates. Autograd over these plain operations gives the gradients.

``precision="tf32"`` is the control: every product of the decoders takes
its operands rounded to TF32 (10 mantissa bits, to nearest), as a TF32
tensor core does, and accumulates in float32; everything else stays
float32. The port's configurations state float32 with TF32 off, so TF32 is
the nearest precision below them.

Large inputs are processed in blocks of rows, so the reference fits beside
whatever else is on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_MASK32 = 0xFFFFFFFF
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


# ---------------------------------------------------------------------------
# geometry


@dataclass(frozen=True)
class Level:
    res: Tuple[int, ...]
    dense: bool
    size: int  # rows of the fused table this level owns
    offset: int  # its first row


@dataclass(frozen=True)
class Grid:
    dim: int
    n_features: int
    levels: Tuple[Level, ...]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def rows(self) -> int:
        last = self.levels[-1]
        return last.offset + last.size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def make_grid(enc: Dict) -> Grid:
    """The level geometry of an encoder config (``configs/*.json``'s
    ``encoder``): per level ``res = floor(base * b**l)`` (float64), with
    ``b = exp((ln finest - ln base) / D)``, D = base - 1 per axis for the
    reference repository's growth and L - 1 for the paper's (Instant-NGP eq.
    3). A level is dense when its vertex grid, prod(res + 1), fits the
    2^log2 budget, and then owns that many rows; a hashed level owns
    min(max(res)^d, 2^log2) rows."""
    dim, L, F = int(enc["dim"]), int(enc["n_levels"]), int(enc["n_features_per_level"])
    budget = 2 ** int(enc["log2_hashmap_size"])
    base = np.asarray(enc["base_resolution"], np.float64)
    fine = np.asarray(enc["finest_resolution"], np.float64)
    if base.shape != (dim,) or fine.shape != (dim,):
        raise ValueError(f"resolutions must have {dim} axes")
    denom = base - 1.0 if enc["growth"] == "reference" else np.full(dim, max(L - 1, 1), np.float64)
    if enc["growth"] not in ("reference", "paper"):
        raise ValueError(f"unknown growth {enc['growth']!r}")
    b = np.exp((np.log(fine) - np.log(base)) / denom)
    levels, offset = [], 0
    for lvl in range(L):
        res = tuple(int(r) for r in np.floor(base * b**lvl))
        verts = int(np.prod([r + 1 for r in res], dtype=object))
        dense = verts <= budget
        size = verts if dense else min(int(max(res)) ** dim, budget)
        levels.append(Level(res, dense, int(size), offset))
        offset += int(size)
    return Grid(dim, F, tuple(levels))


# ---------------------------------------------------------------------------
# encoding


def _hash(corner: List[torch.Tensor], size: int) -> torch.Tensor:
    h = None
    for k, c in enumerate(corner):
        t = ((c & _MASK32) * PRIMES[k]) & _MASK32
        h = t if h is None else h ^ t
    return h % size


def corners(grid: Grid, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table rows (int64) and multilinear weights (float32) of every corner
    of every level: each (N, L, 2^d). The cell index is the truncated
    ``x * res``, clamped to [0, res - 1] on a dense level; corner c takes
    index + 1 on the axes whose bit is set; its weight is the product over
    the axes of the fraction or its complement. Dense rows are row-major
    over the vertex grid; hashed rows are tcnn's spatial hash."""
    d, C = grid.dim, 1 << grid.dim
    ids_l, w_l = [], []
    for lv in grid.levels:
        scaled = [x[:, k] * float(lv.res[k]) for k in range(d)]
        xi = [s.to(torch.int32) for s in scaled]
        if lv.dense:
            xi = [torch.clamp(i, 0, lv.res[k] - 1) for k, i in enumerate(xi)]
        frac = [s - i.to(torch.float32) for s, i in zip(scaled, xi)]
        xi = [i.to(torch.int64) for i in xi]
        strides = np.cumprod([1] + [r + 1 for r in lv.res[::-1]])[:-1][::-1]
        ids_c, w_c = [], []
        for c in range(C):
            bits = [(c >> k) & 1 for k in range(d)]
            w = None
            for k in range(d):
                f = frac[k] if bits[k] else 1.0 - frac[k]
                w = f if w is None else w * f
            corner = [xi[k] + bits[k] for k in range(d)]
            if lv.dense:
                row = sum(corner[k] * int(strides[k]) for k in range(d))
            else:
                row = _hash(corner, lv.size)
            ids_c.append(row + lv.offset)
            w_c.append(w)
        ids_l.append(torch.stack(ids_c, -1))
        w_l.append(torch.stack(w_c, -1))
    return torch.stack(ids_l, 1), torch.stack(w_l, 1)


def encode(grid: Grid, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, L*F): level l's F features at columns l*F..l*F+F-1, each the
    weighted sum of its corners' rows. Differentiable in ``table``."""
    ids, w = corners(grid, x)
    rows = table[ids]  # (N, L, C, F)
    return (rows * w.unsqueeze(-1)).sum(2).reshape(x.shape[0], grid.out_dim)


def touched_rows(grid: Grid, x: torch.Tensor) -> int:
    """Distinct table rows that the points ``x`` read."""
    ids, _ = corners(grid, x)
    return int(torch.unique(ids).numel())


# ---------------------------------------------------------------------------
# decoders


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def gelu_tanh(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * z * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)))


def decode(dec: Dict, params: Dict[str, torch.Tensor], z: torch.Tensor, precision: str = "fp32",
           train: bool = False) -> torch.Tensor:
    """The decoder of config ``dec`` on features ``z``:

    - ``"norm"``: every block, the last one included, is Linear -> BatchNorm
      -> GELU (tanh form); BatchNorm normalises by the batch statistics
      (biased variance) in training and by the running ones in eval, eps
      1e-5;
    - ``"relu_plain"``: Linear -> ReLU between the layers, identity output.

    A Linear is ``z @ w + b`` with w (dim_in, dim_out)."""
    n_layers = int(dec["n_layers"])
    for i in range(n_layers):
        z = matmul(z, params[f"layers.{i}.w"], precision) + params[f"layers.{i}.b"]
        if dec["kind"] == "norm":
            if train:
                mean, var = z.mean(0), z.var(0, unbiased=False)
            else:
                mean, var = params[f"bn.{i}.mean"], params[f"bn.{i}.var"]
            z = (z - mean) / torch.sqrt(var + 1e-5) * params[f"bn.{i}.scale"] + params[f"bn.{i}.bias"]
            z = gelu_tanh(z)
        elif dec["kind"] == "relu_plain":
            if i < n_layers - 1:
                z = torch.clamp_min(z, 0.0)
        else:
            raise ValueError(f"unknown decoder {dec['kind']!r}")
    return z


def forward(cfg: Dict, grid: Grid, params: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "fp32",
            train: bool = False) -> torch.Tensor:
    return decode(cfg["decoder"], params, encode(grid, params["encoder.table"], x), precision, train)


# ---------------------------------------------------------------------------
# grid evaluation


def grid_coords(shape: Sequence[int], start: int, stop: int, device) -> torch.Tensor:
    """Rows start..stop-1 of the C-ordered grid of ``shape``: axis k's
    coordinate is digit_k / (shape_k - 1) in float32."""
    idx = torch.arange(start, stop, device=device, dtype=torch.int64)
    cols, rest = [], idx
    for s in reversed(shape):
        cols.append(rest % s)
        rest = rest // s
    cols = cols[::-1]
    return torch.stack([c.to(torch.float32) / float(max(s - 1, 1)) for c, s in zip(cols, shape)], -1)


@torch.no_grad()
def grid_volume(cfg: Dict, params: Dict[str, torch.Tensor], shape: Sequence[int], precision: str = "fp32",
                block: int = 1 << 18) -> torch.Tensor:
    """The model in eval mode on every point of the grid, (prod(shape),) on
    the parameters' device, ``block`` points at a time."""
    grid = make_grid(cfg["encoder"])
    n = int(np.prod(shape))
    dev = params["encoder.table"].device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = forward(cfg, grid, params, grid_coords(shape, start, stop, dev), precision)[:, 0]
    return out


# ---------------------------------------------------------------------------
# training


def cosine_lr(lr: float, count: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule(lr, D) at update ``count`` (0 first)."""
    decay = max(decay_steps, 1)
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))


def adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, t: int, lr: float,
                betas: Tuple[float, float], eps: float) -> None:
    """One Adam update of ``p`` in place, torch's formula: the moments'
    running means, then ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""
    b1, b2 = betas
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    denom = v.sqrt() / math.sqrt(1.0 - b2**t) + eps
    p.sub_(lr / (1.0 - b1**t) * m / denom)


ADAM = {"adam": ((0.9, 0.999), 1e-8), "adam_tcnn": ((0.9, 0.99), 1e-15)}


@dataclass
class FitReading:
    losses: List[float]  # each step's MSE, as the step saw it
    grad_norms: Dict[str, float]  # each leaf's first gradient
    change_norms: Dict[str, float]  # each leaf's change after the steps


def fit_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              steps_per_epoch: int, precision: str = "fp32", frozen: Sequence[str] = ()) -> FitReading:
    """The config's training steps (``cfg["train"]``: MSE, Adam or tcnn's
    Adam, constant or cosine rate) from ``params`` over ``batches`` of (x,
    y); the names in ``frozen`` (buffers) are read, not trained. ``params``
    are taken as they are and left unchanged."""
    tr = cfg["train"]
    grid = make_grid(cfg["encoder"])
    betas, eps = ADAM[tr["optimizer"]]
    names = sorted(k for k in params if k not in frozen)
    p = {k: params[k].detach().clone().requires_grad_(k in names) for k in params}
    start = {k: params[k].detach() for k in names}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    decay = int(tr.get("cosine_t_max", 0)) * steps_per_epoch
    losses, grad_norms = [], {}
    for t, (x, y) in enumerate(batches, start=1):
        loss = torch.mean((forward(cfg, grid, p, x, precision, train=True) - y) ** 2)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in zip(names, grads)}
        lr = cosine_lr(tr["lr"], t - 1, decay) if tr.get("lr_schedule") == "cosine" else tr["lr"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                adam_update(p[k], g, m[k], v[k], t, lr, betas, eps)
    change = {k: float(torch.linalg.vector_norm((p[k].detach() - start[k]).double())) for k in names}
    return FitReading(losses, grad_norms, change)


# ---------------------------------------------------------------------------
# the comparisons


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves: Optional[Sequence[str]] = None) -> float:
    """The worst leaf's gap between two norms, |program - reference|, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    leaves = sorted(reference) if leaves is None else list(leaves)
    median = float(np.median([reference[k] for k in sorted(reference)]))
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in leaves)


def moving_leaves(grad_norms: Dict[str, float], floor: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``floor`` of the
    median leaf's: the others move under Adam by round-off alone."""
    median = float(np.median([grad_norms[k] for k in sorted(grad_norms)]))
    return [k for k in sorted(grad_norms) if grad_norms[k] >= floor * median]


def fit_gaps(program: FitReading, reference: FitReading) -> Dict[str, float]:
    """The numbers a fit cell compares: the worst step's relative loss gap,
    the worst leaf's first-gradient gap and change gap."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program.losses, reference.losses))
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(program.grad_norms, reference.grad_norms),
            "change_gap": leaf_gap(program.change_norms, reference.change_norms,
                                   moving_leaves(reference.grad_norms))}


def volume_gap(answer: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest voxel error over the largest reference magnitude; a
    volume with a non-finite voxel or another size reads infinite."""
    answer = answer.reshape(-1)
    if answer.shape != reference.shape or not bool(torch.isfinite(answer).all()):
        return math.inf
    return float((answer - reference).abs().max() / reference.abs().max().clamp_min(1e-30))
