"""The plain reference of the hash SIREN, which the benchmark judges the port's
``HashSiren`` by.

Plain PyTorch in float32, imported from nothing of the port, written from
the published descriptions: Mehta et al., "Modulated Periodic Activations
for Generalizable Local Functional Representations", ICCV 2021
(arXiv:2104.03960), a ReLU modulator network beside a SIREN synthesis
network; the reference repository's ``HashSirenNet`` (``models.py:325-394``,
its ``Modulator`` ``models.py:236-260``), which feeds the modulator a hash
encoding of the coordinates; and Instant-NGP's multiresolution hash grid
(arXiv:2201.05989), whose settings ``config/hash_config.json`` carries:

- the latent: the hash encoding, levels of resolution ``floor(base *
  scale^l)`` per axis, a level dense where its vertex grid fits 2^log2 rows
  and hashed (tcnn's spatial hash) otherwise, each level's F features the
  multilinear sum of its cell's 2^d corners (``reference.corners`` and
  ``reference.encode``);
- the modulator: layer 0 is ``m_0 = relu(lat W'_0 + b'_0)``, layer i > 0
  ``m_i = relu(cat(m_{i-1}, lat) W'_i + b'_i)``;
- the SIREN: ``y_0 = x``, ``y_{i+1} = sin(w0_i (y_i W_i + b_i)) * m_i`` (w0_0
  = w0_initial, then w0), and the value ``y_n W + b``, linear;
- the MSE over every row fed, and torch's Adam (betas 0.9, 0.999, eps 1e-8)
  at a constant rate.

Departures from the published description, each the port's as well:

- the latent is a row's own hash encoding: Mehta et al.'s modulator takes
  one latent vector a signal (and the reference's ``Modulator`` concatenates
  it with ``torch.cat((x, z))`` along the only axis), here the latent
  varies with the coordinate, so each row's is concatenated with its own
  hidden state along the feature axis;
- the modulator is as deep and as wide as the SIREN (one layer a sine
  layer, 256 wide), as the reference's ``HashSirenNet`` builds it;
- the grid's levels grow by ``per_level_scale`` (Instant-NGP's b = 1.4),
  as tcnn's HashGrid takes it; ``reference.make_grid`` knows only a growth
  from the base to the finest resolution, so :func:`make_grid` builds the
  levels from the scale itself;
- the weights are drawn from a ``torch.Generator`` seeded with the seed on
  the host, as the port's factory draws them: the table U(-1e-4, 1e-4)
  (tcnn's initialisation), then the SIREN layer after layer, the weight
  then the bias (SIREN's U(-1/d, 1/d) for the first, U(-sqrt(sigma/d)/w0,
  ...) after, the last layer's at w0), then the modulator's layers
  (torch's Linear bound, U(-1/sqrt(fan_in), 1/sqrt(fan_in))), not from
  torch's global stream in module order;
- no learning-rate schedule: the port's ``Trainer.fit`` takes a constant
  rate, and the configuration states one.

A fit is read step by step (``reference_wire.StepReading``: each step's
loss, starting parameters and gradient fed Adam, then the parameters and
Adam's first moment) and :func:`step_gaps` holds each step to the
reference from the state the fit reached, as ``reference_wire.step_gaps``
does for WIRE: the port's table gradient (kernel 2) sums with float
atomics in no fixed order, so two fits from one state part within a few
steps, Adam's first step moving every touched entry by the rate whatever
its gradient's size.

The products run in float32 with TF32 off (``common.strict_fp32``, around
every loss and gradient), whatever the process had set.

``precision="tf32"`` is the control: every product of both networks takes
its operands rounded to TF32 (``reference.tf32_round``); everything else
stays float32. The configuration states float32 with TF32 off, so TF32 is
the nearest precision below it. Two faults can be planted, for the
calibration and the tests: ``fault="gates_one"`` (each sine layer's output
left unmultiplied, the modulator cut off) and ``fault="latent_zero"`` (the
modulator fed zeros in place of the encoding).

A batch is processed ``block`` rows at a time, the loss and the gradients
summed over the blocks, so that the reference fits beside the program's
state on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .common import strict_fp32
from .reference import Grid, Level, encode, matmul
from .reference_wire import StepReading, _worst_leaf, replay_adam

FAULTS = (None, "gates_one", "latent_zero")


def make_grid(cfg: Dict) -> Grid:
    """The level geometry of the config's ``encoder``: level l's resolution
    ``floor(base * scale**l)`` on every axis (float64); dense where its
    vertex grid, (res + 1)^d, fits the 2^log2 budget, and then that many
    rows; hashed otherwise, min(res^d, 2^log2) rows."""
    enc = cfg["encoder"]
    dim, budget = int(enc["dim"]), 2 ** int(enc["log2_hashmap_size"])
    base, scale = float(enc["base_resolution"]), float(enc["per_level_scale"])
    levels, offset = [], 0
    for lvl in range(int(enc["n_levels"])):
        res = int(math.floor(base * scale**lvl))
        verts = (res + 1) ** dim
        dense = verts <= budget
        size = verts if dense else min(res**dim, budget)
        levels.append(Level((res,) * dim, dense, size, offset))
        offset += size
    return Grid(dim, int(enc["n_features_per_level"]), tuple(levels))


def init_params(cfg: Dict, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """The hash SIREN's weights for ``seed`` under the port's names
    (``encoder.table``, ``siren.layers.{i}.w`` / ``.b``, ``siren.last.w`` /
    ``.b``, ``modulator.{i}.w`` / ``.b``; a weight is (dim_in, dim_out)),
    drawn on the host in the port factory's order, then moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    s = cfg["siren"]
    d, h, n, d_out = int(s["dim_in"]), int(s["dim_hidden"]), int(s["n_layers"]), int(s["dim_out"])
    w0, sigma = float(s["w0"]), float(s["sigma"])
    grid = make_grid(cfg)

    def uniform(shape, bound):
        return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)

    params = {"encoder.table": uniform((grid.rows, grid.n_features), 1e-4)}
    dims = [d] + [h] * n + [d_out]
    for i, (k, m) in enumerate(zip(dims[:-1], dims[1:])):
        name = "siren.last" if i == n else f"siren.layers.{i}"
        bound = 1.0 / k if i == 0 else math.sqrt(sigma / k) / w0
        params[f"{name}.w"], params[f"{name}.b"] = uniform((k, m), bound), uniform((m,), bound)
    for i in range(n):
        k = grid.out_dim if i == 0 else h + grid.out_dim
        bound = 1.0 / math.sqrt(k)
        params[f"modulator.{i}.w"], params[f"modulator.{i}.b"] = uniform((k, h), bound), uniform((h,), bound)
    return {k: v.to(device) for k, v in params.items()}


def forward(cfg: Dict, grid: Grid, params: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "fp32",
            fault: Optional[str] = None) -> torch.Tensor:
    """The hash SIREN on rows ``x`` (N, dim_in) in [0, 1]: (N, dim_out)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    s = cfg["siren"]
    n, w0, w0_initial = int(s["n_layers"]), float(s["w0"]), float(s["w0_initial"])
    lat = encode(grid, params["encoder.table"], x)
    if fault == "latent_zero":
        lat = lat * 0.0
    h, mods = lat, []
    for i in range(n):
        if i:
            h = torch.cat([h, lat], -1)
        h = torch.relu(matmul(h, params[f"modulator.{i}.w"], precision) + params[f"modulator.{i}.b"])
        mods.append(h)
    y = x
    for i in range(n):
        z = matmul(y, params[f"siren.layers.{i}.w"], precision) + params[f"siren.layers.{i}.b"]
        y = torch.sin((w0_initial if i == 0 else w0) * z)
        if fault != "gates_one":
            y = y * mods[i]
    return matmul(y, params["siren.last.w"], precision) + params["siren.last.b"]


def loss_and_grads(cfg: Dict, grid: Grid, params: Dict[str, torch.Tensor], names: Sequence[str], x: torch.Tensor,
                   y: torch.Tensor, precision: str = "fp32", fault: Optional[str] = None,
                   block: int = 1 << 16) -> Tuple[float, List[torch.Tensor]]:
    """The MSE over the batch and its gradient in each of ``names``, ``block``
    rows at a time, float32 products with TF32 off whatever the process set:
    each block's squared errors summed, over the whole batch's count; a leaf
    the loss does not reach (the modulator under ``gates_one``) has a zero
    gradient."""
    n = x.shape[0]
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    grads = [torch.zeros_like(params[k]) for k in names]
    with strict_fp32():
        for start in range(0, n, block):
            xb, yb = x[start:start + block], y[start:start + block]
            part = ((forward(cfg, grid, params, xb, precision, fault) - yb) ** 2).sum() / (n * yb.shape[-1])
            for acc, g in zip(grads, torch.autograd.grad(part, [params[k] for k in names], materialize_grads=True)):
                acc += g
            loss += part.detach().double()
    return float(loss), grads


def fit_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              precision: str = "fp32", fault: Optional[str] = None, block: int = 1 << 16) -> StepReading:
    """The config's training steps (torch's Adam at a constant rate) from
    ``params`` over ``batches`` of (x, y), as a ``StepReading``; ``params``
    are left unchanged."""
    grid = make_grid(cfg)
    names = sorted(params)
    start = {k: params[k].detach().clone() for k in names}
    losses, states, fed = [], [], []
    for x, y in batches:
        p, _ = replay_adam(cfg, start, fed)
        states.append(p)
        leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        loss, grads = loss_and_grads(cfg, grid, leaves, names, x, y, precision, fault, block)
        losses.append(loss)
        fed.append(dict(zip(names, grads)))
    after, moment = replay_adam(cfg, start, fed)
    return StepReading(losses, states, fed, after, moment)


def step_gaps(cfg: Dict, reading: StepReading, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              block: int = 1 << 16) -> Dict[str, float]:
    """The numbers ``hash_siren.fit`` compares, each step held to the
    reference from the state the fit reached:

    - ``loss_gap``: the worst step's |loss - ref| / ref, the reference's
      loss at the parameters that step started from, over its batch;
    - ``grad_gap``: the worst step's worst leaf (the table included), the
      norm of the gradient fed Adam less the reference's there, over the
      norm of the reference's leaf or of its median leaf, whichever is
      larger;
    - ``change_gap``: Adam replayed from the first state over the gradients
      the fit fed it; the worst leaf of the fit's change over the steps
      against the replay's, and of its first moment against the replay's,
      whichever is worse. A step that leaves its state unchanged reads 1.

    A reading that is not finite reads infinite."""
    grid = make_grid(cfg)
    names = sorted(reading.params[0])
    loss_gap = grad_gap = 0.0
    for t, (x, y) in enumerate(batches):
        leaves = {k: reading.params[t][k].to(x.device, copy=True).requires_grad_(True) for k in names}
        loss, grads = loss_and_grads(cfg, grid, leaves, names, x, y, block=block)
        gap = abs(reading.losses[t] - loss) / max(abs(loss), 1e-30)
        loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
        ref = dict(zip(names, grads))
        grad_gap = max(grad_gap, _worst_leaf({k: reading.grads[t][k].to(x.device) - ref[k] for k in names}, ref))
    start = {k: t.to(batches[0][0].device) for k, t in reading.params[0].items()}
    params, m = replay_adam(cfg, start, reading.grads)
    change = {k: params[k] - start[k] for k in names}
    change_gap = max(
        _worst_leaf({k: reading.after[k].to(start[k].device) - params[k] for k in names}, change),
        _worst_leaf({k: reading.first_moment[k].to(start[k].device) - m[k] for k in names}, m))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
