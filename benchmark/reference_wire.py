"""The plain reference of WIRE, which the benchmark judges the port's complex
GaborNet by.

Plain PyTorch in float32, imported from nothing of the port, written from
the published description: Saragadam et al., "WIRE: Wavelet Implicit
Neural Representations", CVPR 2023 (arXiv:2301.05187), its code's
``models/wire.py`` and the image experiment ``wire_image.py``:

- ``z = x W + b``; a Gabor layer's activation is ``exp(i w0 z - |s0
  z|^2)``, which with ``z = p + i q`` is ``exp(-w0 q - s0^2 (p^2 + q^2))
  (cos(w0 p) + i sin(w0 p))``;
- the INR: one Gabor layer from the real coordinates (real W and b), then
  ``hidden_layers`` Gabor layers with complex W and b, then a plain complex
  Linear to ``dim_out`` (``outermost_linear``), whose real part is the
  value; w0 and s0 the same in every Gabor layer, fixed;
- the MSE of the value against the volume over every row fed, and torch's
  Adam (betas 0.9, 0.999, eps 1e-8) at a constant rate.

Every complex number is held as two real tensors: a complex weight as its
real and imaginary parts (``<name>.re``, ``<name>.im``), a complex
activation likewise, and each product with a complex weight is the real
2 x 2 block product ``[xr xi] [[wr, wi], [-wi, wr]]``. The gradients are
plain real autograd over these, and Adam steps each real part as a leaf
of its own: nothing here rests on the port's complex arithmetic or on
torch's convention for the gradient of a complex leaf.

A fit is read step by step (:class:`StepReading`: each step's loss,
starting parameters and gradient fed Adam, then the parameters and Adam's
first moment), and :func:`step_gaps` holds each step to the reference from
the state the fit reached, not the fit's whole path to the reference's:
Adam's first step moves every weight by the rate whatever its gradient's
size, and two float32 summation orders part by ~1e-4 in the loss within
three steps at WIRE's widths.

Departures from WIRE, each the port's as well:

- no learning-rate decay: ``wire_image.py`` decays the rate with a
  ``LambdaLR`` to a tenth over its iterations; the port's ``Trainer.fit``
  has a constant rate or the cosine, and the configuration states a
  constant one (its ``assumed``);
- the weights are drawn from a ``torch.Generator`` seeded with the seed on
  the host, as the port's factory draws them: layer after layer, the
  weight then the bias, a complex tensor's real part (all of it) before
  its imaginary part, each U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
  Linear bound, which WIRE's layers take), not from WIRE's global stream;
- the coordinates are the grid's ``linspace(-1, 1, s)`` per axis and the
  values the volume's own, as WIRE's image experiment feeds them.

``precision="tf32"`` is the control: every product takes its operands
rounded to TF32 (``reference.tf32_round``); everything else stays
float32. The configuration states float32 with TF32 off, so TF32 is the
nearest precision below it. Two faults can be planted, for the
calibration and the tests: ``s0=0`` (the Gaussian envelope dropped) and
``conjugate=True`` (Adam fed the conjugate gradient, the imaginary parts'
gradients negated).

A batch is processed ``block`` rows at a time, the loss and the gradients
summed over the blocks, so that a full batch of the (352, 352, 15) volume
(1,858,560 rows, about 20 GB of saved activations unblocked) fits beside
the program's state on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reference import ADAM, adam_update, matmul

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (real part, imaginary part or None for a real tensor)


def layer_dims(cfg: Dict) -> List[int]:
    """The widths: [dim_in, hidden x (1 + hidden_layers), dim_out]."""
    w = cfg["wire"]
    return [int(w["dim_in"])] + [int(w["dim_hidden"])] * (1 + int(w["hidden_layers"])) + [int(w["dim_out"])]


def layer_names(cfg: Dict) -> List[str]:
    """The port's names of the linear layers, in order: the Gabor layers'
    ``layers.{i}.lin``, then the complex Linear ``last``."""
    return [f"layers.{i}.lin" for i in range(1 + int(cfg["wire"]["hidden_layers"]))] + ["last"]


def init_params(cfg: Dict, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """WIRE's weights for ``seed`` as real tensors: the first layer's
    ``layers.0.lin.w`` (dim_in, H) and ``.b``; every later layer's weight and
    bias as ``<name>.re`` and ``<name>.im``. Drawn on the host, in the port
    factory's order, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dims = layer_dims(cfg)
    out = {}
    for i, (name, k, m) in enumerate(zip(layer_names(cfg), dims[:-1], dims[1:])):
        bound = 1.0 / math.sqrt(k)
        for key, shape in ((f"{name}.w", (k, m)), (f"{name}.b", (m,))):
            for part in ("",) if i == 0 else (".re", ".im"):
                out[key + part] = torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    return {k: v.to(device) for k, v in out.items()}


def port_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of these weights: each ``.re``/``.im`` pair
    as one complex64 tensor."""
    out = {}
    for key, t in params.items():
        if key.endswith(".re"):
            out[key[:-3]] = torch.complex(t, params[key[:-3] + ".im"])
        elif not key.endswith(".im"):
            out[key] = t
    return out


def real_parts(name: str, t: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """``[(name, t)]`` for a real tensor; ``[(name.re, real), (name.im,
    imaginary)]`` for a complex one, views through ``torch.view_as_real``."""
    if not t.is_complex():
        return [(name, t)]
    r = torch.view_as_real(t)
    return [(f"{name}.re", r[..., 0]), (f"{name}.im", r[..., 1])]


def linear(x: Pair, params: Dict[str, torch.Tensor], name: str, precision: str = "fp32") -> Pair:
    """``x W + b``: real where x and W are (the first layer), else the real
    2 x 2 block product over the parts."""
    xr, xi = x
    if f"{name}.w" in params:
        return matmul(xr, params[f"{name}.w"], precision) + params[f"{name}.b"], None
    wr, wi = params[f"{name}.w.re"], params[f"{name}.w.im"]
    if xi is None:
        xs, block = xr, torch.cat([wr, wi], 1)
    else:
        xs, block = torch.cat([xr, xi], 1), torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)
    y = matmul(xs, block, precision)
    m = wr.shape[1]
    return y[:, :m] + params[f"{name}.b.re"], y[:, m:] + params[f"{name}.b.im"]


def gabor(z: Pair, w0: float, s0: float) -> Pair:
    """``exp(i w0 z - |s0 z|^2)`` of z = p + i q, in its real form."""
    p, q = z
    if q is None:
        env = torch.exp(-(s0 * s0) * (p * p))
    else:
        env = torch.exp(-w0 * q - (s0 * s0) * (p * p + q * q))
    return env * torch.cos(w0 * p), env * torch.sin(w0 * p)


def forward(cfg: Dict, params: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "fp32",
            s0: Optional[float] = None) -> torch.Tensor:
    """WIRE on rows ``x`` (N, dim_in): the real part of the last Linear, (N,
    dim_out). ``s0`` in place of the config's where given (a fault)."""
    w = cfg["wire"]
    w0, s0 = float(w["w0"]), float(w["s0"] if s0 is None else s0)
    names = layer_names(cfg)
    z: Pair = (x, None)
    for name in names[:-1]:
        z = gabor(linear(z, params, name, precision), w0, s0)
    return linear(z, params, names[-1], precision)[0]


@torch.no_grad()
def grid_volume(cfg: Dict, params: Dict[str, torch.Tensor], coords, n: int, precision: str = "fp32",
                block: int = 1 << 17) -> torch.Tensor:
    """WIRE on the ``n`` grid rows that ``coords(start, stop)`` gives, (n,)
    for dim_out 1, ``block`` rows at a time."""
    out = torch.empty(n, dtype=torch.float32, device=next(iter(params.values())).device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        out[start:stop] = forward(cfg, params, coords(start, stop), precision)[:, 0]
    return out


def loss_and_grads(cfg: Dict, params: Dict[str, torch.Tensor], names: Sequence[str], x: torch.Tensor,
                   y: torch.Tensor, precision: str = "fp32", s0: Optional[float] = None,
                   block: int = 1 << 17) -> Tuple[float, List[torch.Tensor]]:
    """The MSE over the batch and its gradient in each of ``names``, ``block``
    rows at a time: each block's squared errors summed, over the whole
    batch's count. The last bias's imaginary part does not reach the value
    (its real part): its gradient is zero."""
    n = x.shape[0]
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    grads = [torch.zeros_like(params[k]) for k in names]
    for start in range(0, n, block):
        xb, yb = x[start:start + block], y[start:start + block]
        part = ((forward(cfg, params, xb, precision, s0) - yb) ** 2).sum() / (n * yb.shape[-1])
        for acc, g in zip(grads, torch.autograd.grad(part, [params[k] for k in names], materialize_grads=True)):
            acc += g
        loss += part.detach().double()
    return float(loss), grads


@dataclass
class StepReading:
    """The first k steps of a fit as it took them, each tensor as the
    reference's real leaves (``real_parts``): each step's loss, the
    parameters each step started from, the gradient each step fed Adam,
    and after the last step the parameters and Adam's first moment."""

    losses: List[float]
    params: List[Dict[str, torch.Tensor]]
    grads: List[Dict[str, torch.Tensor]]
    after: Dict[str, torch.Tensor]
    first_moment: Dict[str, torch.Tensor]


def _adam(cfg: Dict) -> Tuple[float, Tuple[float, float], float]:
    tr = cfg["train"]
    if tr["optimizer"] != "adam" or tr.get("lr_schedule"):
        raise ValueError("WIRE's reference takes torch's Adam at a constant rate")
    betas, eps = ADAM["adam"]
    return float(tr["lr"]), betas, eps


@torch.no_grad()
def replay_adam(cfg: Dict, start: Dict[str, torch.Tensor], grads: Sequence[Dict[str, torch.Tensor]]):
    """torch's Adam from ``start`` over the gradients ``grads``, one dict a
    step, each real leaf on its own: (parameters, first moment) after."""
    lr, betas, eps = _adam(cfg)
    p = {k: t.detach().clone() for k, t in start.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    for t, g in enumerate(grads, start=1):
        for k in p:
            adam_update(p[k], g[k].to(p[k].device), m[k], v[k], t, lr, betas, eps)
    return p, m


def fit_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              precision: str = "fp32", s0: Optional[float] = None, conjugate: bool = False,
              block: int = 1 << 17) -> StepReading:
    """The config's training steps (``cfg["train"]``: torch's Adam at a
    constant rate) from ``params`` over ``batches`` of (x, y), as a
    :class:`StepReading`; ``conjugate``: Adam fed the conjugate gradient
    (each ``.im`` leaf's negated), a fault. ``params`` are left unchanged."""
    lr, betas, eps = _adam(cfg)
    names = sorted(params)
    p = {k: params[k].detach().clone() for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, states, fed = [], [], []
    for t, (x, y) in enumerate(batches, start=1):
        states.append({k: p[k].clone() for k in names})
        leaves = {k: p[k].clone().requires_grad_(True) for k in names}
        loss, grads = loss_and_grads(cfg, leaves, names, x, y, precision, s0, block)
        grads = {k: -g if conjugate and k.endswith(".im") else g for k, g in zip(names, grads)}
        losses.append(loss)
        fed.append(grads)
        with torch.no_grad():
            for k in names:
                adam_update(p[k], grads[k], m[k], v[k], t, lr, betas, eps)
    return StepReading(losses, states, fed, p, m)


def _worst_leaf(diff: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's norm of ``diff`` over the norm of ``ref``'s leaf or
    of its median leaf, whichever is larger; a non-finite one reads
    infinite."""
    norms = {k: float(torch.linalg.vector_norm(t.double())) for k, t in ref.items()}
    median = float(np.median(list(norms.values())))
    gaps = [float(torch.linalg.vector_norm(diff[k].double())) / max(norms[k], median, 1e-30) for k in ref]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def step_gaps(cfg: Dict, reading: StepReading, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              block: int = 1 << 17) -> Dict[str, float]:
    """The numbers ``wire.fit`` compares, each step held to the reference
    from the state the fit reached, so that what one step leaves behind
    (Adam's first step moves every weight by the rate, whatever the sign of
    its gradient's last bits) does not grow into the next step's reading:

    - ``loss_gap``: the worst step's |loss - ref| / ref, the reference's
      loss at the parameters that step started from, over its batch;
    - ``grad_gap``: the worst step's worst leaf, ``_worst_leaf`` of the
      gradient fed Adam against the reference's gradient there;
    - ``change_gap``: Adam replayed (``replay_adam``) from the first state
      over the gradients the fit fed it; the worst leaf of the fit's change
      over the steps against the replay's, and of its first moment against
      the replay's, whichever is worse. A step that leaves its state
      unchanged reads 1."""
    names = sorted(reading.params[0])
    loss_gap = grad_gap = 0.0
    for t, (x, y) in enumerate(batches):
        leaves = {k: reading.params[t][k].to(x.device, copy=True).requires_grad_(True) for k in names}
        loss, grads = loss_and_grads(cfg, leaves, names, x, y, block=block)
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
