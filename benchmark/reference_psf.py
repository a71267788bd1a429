"""The plain reference of the PSF SIREN, which the benchmark judges the port by.

Plain PyTorch in float32, imported from nothing of the port, written from
the published descriptions: the reference repository's ``PsfSirenNet``
(https://github.com/Benjamin-Fouquet/mri_interpolation, ``models.py``) and
SIREN (Sitzmann et al. 2020, arXiv:2006.09661):

- SIREN: ``n_layers`` sine layers ``sin(w0 (x W + b))`` (the first at
  ``w0_initial``), then a linear output layer ``x W + b``. Initialisation:
  the first layer's weights and biases U(-1/d, 1/d), every later layer's
  U(-sqrt(c/d)/w0, sqrt(c/d)/w0), d its fan-in and c the config's
  ``sigma`` (6 in the paper);
- the slice-profile objective: each voxel centre x expands to the K =
  n^3 points x + o, the offsets o an ``ij`` meshgrid of ``linspace(-s_k,
  s_k, n)`` per axis; the SIREN predicts each point; a separable Gaussian of
  sigma 1/2.3548 (a FWHM of one unit) on ``linspace(-0.5, 0.5, n)`` per
  axis, normalised to sum 1, integrates the K predictions back to one
  value; the MSE of those against the voxels' values;
- torch's Adam (betas 0.9, 0.999, eps 1e-8) at a constant rate.

Autograd over these operations gives the gradients.

Departures from the reference repository, each the port's and the
launcher's as well:

- the half-extents ``s_k`` are ``0.5 / (size_k - 1)`` on coordinates in
  [-1, 1]: half a voxel of a [0, 1] grid, so a quarter of a voxel of the
  grid the model is fitted on (the launcher's choice, kept as it is);
- the weights are drawn from a ``torch.Generator`` seeded on the device,
  one call a tensor (weights, then biases, layer after layer), not from
  the reference's global stream;
- the biases take their layer's weight bound, as the reference
  repository's SIREN layers do (the paper leaves them unstated).

``precision="tf32"`` is the control: every product (the SIREN's layers
and the Gaussian integration) takes its operands rounded to TF32, as a TF32
tensor core does (``reference.tf32_round``); everything else stays
float32. The configuration states float32 with TF32 off, so TF32 is the
nearest precision below it.

A batch is processed ``block`` voxel centres at a time, the loss and the
gradients summed over the blocks, so that the reference fits beside the
program's state on the card (one unblocked step of 4,096 centres at K = 125
holds about ten 512,000 x 256 activations, 5 GB).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .reference import ADAM, FitReading, adam_update, matmul

SIGMA_FWHM = 1.0 / 2.3548  # a Gaussian whose full width at half maximum is 1


def layer_dims(cfg: Dict) -> List[int]:
    """The widths of the stack: [dim_in, hidden x n_layers, dim_out]."""
    s = cfg["siren"]
    return [int(s["dim_in"])] + [int(s["dim_hidden"])] * int(s["n_layers"]) + [int(s["dim_out"])]


def layer_names(cfg: Dict) -> List[str]:
    """The port's names of the linear layers, in order."""
    return [f"layers.{i}" for i in range(int(cfg["siren"]["n_layers"]))] + ["last"]


def init_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """SIREN's initialisation for ``seed``, under the port's parameter names
    (``layers.{i}.w`` (fan-in, fan-out), ``layers.{i}.b``, ``last.w``,
    ``last.b``)."""
    s = cfg["siren"]
    w0, sigma = float(s["w0"]), float(s["sigma"])
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = layer_dims(cfg)
    out = {}
    for i, (name, k, m) in enumerate(zip(layer_names(cfg), dims[:-1], dims[1:])):
        bound = 1.0 / k if i == 0 else math.sqrt(sigma / k) / w0
        for key, shape in (("w", (k, m)), ("b", (m,))):
            out[f"{name}.{key}"] = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
                -bound, bound, generator=gen)
    return out


def half_extents(cfg: Dict) -> List[float]:
    """The PSF's half-extent on each spatial axis: 0.5 / (size - 1) of the
    volume's first three axes."""
    return [0.5 / max(int(v) - 1, 1) for v in cfg["volume"][:3]]


def psf_points(spacing: Sequence[float], n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets (n^d, d), weights (n^d,)) in float32, computed in float64:
    the ``ij`` meshgrid of ``linspace(-s, s, n)`` per axis; the separable
    Gaussian on ``linspace(-0.5, 0.5, n)`` per axis, normalised to sum 1."""
    f64 = dict(dtype=torch.float64, device=device)
    axes = [torch.linspace(-float(s), float(s), n, **f64) for s in spacing]
    offsets = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(spacing))
    unit = torch.linspace(-0.5, 0.5, n, **f64)
    g = torch.exp(-unit * unit / (2.0 * SIGMA_FWHM * SIGMA_FWHM))
    w = g
    for _ in range(len(spacing) - 1):
        w = (w[:, None] * g[None, :]).reshape(-1)
    return offsets.to(torch.float32), (w / w.sum()).to(torch.float32)


def siren(cfg: Dict, params: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """The SIREN on rows ``x`` (N, dim_in): (N, dim_out)."""
    s = cfg["siren"]
    for i, name in enumerate(layer_names(cfg)[:-1]):
        w0 = float(s["w0_initial"] if i == 0 else s["w0"])
        x = torch.sin(w0 * (matmul(x, params[f"{name}.w"], precision) + params[f"{name}.b"]))
    return matmul(x, params["last.w"], precision) + params["last.b"]


def psf_predict(cfg: Dict, params: Dict[str, torch.Tensor], x: torch.Tensor, offsets: torch.Tensor,
                weights: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """The PSF-integrated prediction at voxel centres ``x`` (B, d): (B, dim_out)."""
    b, d = x.shape
    k = offsets.shape[0]
    rows = (x[:, None, :] + offsets[None, :, :]).reshape(b * k, d)
    z = siren(cfg, params, rows, precision).reshape(b, k, -1)
    return matmul(z.transpose(1, 2).reshape(-1, k), weights[:, None], precision).reshape(b, -1)


def psf_loss_and_grads(cfg: Dict, params: Dict[str, torch.Tensor], names: Sequence[str], x: torch.Tensor,
                       y: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, precision: str = "fp32",
                       block: int = 1024) -> Tuple[float, List[torch.Tensor]]:
    """The MSE of the PSF-integrated prediction against ``y`` over the batch
    and its gradient in each of ``names``, ``block`` centres at a time: each
    block's squared errors summed, over the whole batch's count."""
    n = x.shape[0]
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    grads = [torch.zeros_like(params[k]) for k in names]
    for start in range(0, n, block):
        xb, yb = x[start:start + block], y[start:start + block]
        part = ((psf_predict(cfg, params, xb, offsets, weights, precision) - yb) ** 2).sum() / (n * yb.shape[-1])
        for acc, g in zip(grads, torch.autograd.grad(part, [params[k] for k in names])):
            acc += g
        loss += part.detach().double()
    return float(loss), grads


def fit_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              precision: str = "fp32", psf: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              block: int = 1024) -> FitReading:
    """The config's training steps (``cfg["train"]``: torch's Adam at a
    constant rate) from ``params`` over ``batches`` of voxel centres and
    values; ``psf`` (offsets, weights) in place of the config's where given.
    ``params`` are taken as they are and left unchanged."""
    tr = cfg["train"]
    if tr["optimizer"] != "adam" or tr.get("lr_schedule"):
        raise ValueError("the PSF SIREN's reference takes torch's Adam at a constant rate")
    betas, eps = ADAM["adam"]
    lr = float(tr["lr"])
    dev = next(iter(params.values())).device
    offsets, weights = psf if psf is not None else psf_points(half_extents(cfg), int(cfg["psf"]["n_sample"]), dev)
    names = sorted(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, grad_norms = [], {}
    for t, (x, y) in enumerate(batches, start=1):
        loss, grads = psf_loss_and_grads(cfg, p, names, x, y, offsets, weights, precision, block)
        losses.append(loss)
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                adam_update(p[k], g, m[k], v[k], t, lr, betas, eps)
    change = {k: float(torch.linalg.vector_norm((p[k].detach() - params[k].detach()).double())) for k in names}
    return FitReading(losses, grad_norms, change)
