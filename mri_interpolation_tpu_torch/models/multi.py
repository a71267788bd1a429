"""Multi-frame models: per-frame encoders and one shared decoder.

Port of ``mri_interpolation_tpu/models/multi.py`` (reference ``MultiSiren``
and ``MultiHashMLP``): a training batch is one whole frame, routed by its
frame index; both use Adam with weight decay 1e-5 in the reference.

Each per-frame parameter is ONE stacked ``nn.Parameter`` with a leading
``n_frames`` axis, named as the JAX tree (``encoders.table``,
``encoders.layers.{i}.w``, ...), so ``convert.params_from_jax`` moves a JAX
model across as it is. ``forward(x, frame_idx)`` selects ``p[frame_idx]``, a
contiguous view, so the kernels read it in place. The gradient of a stacked
parameter is dense, zero outside the selected frame; the optimizer then
updates every frame's moments (and, with weight decay, weights) on every
step, as the JAX optimizer does over its stacked tree. Per-frame tensors
would leave the other frames' gradients ``None`` and torch's Adam would skip
them.

- ``MultiHashMLP``: the frame's hash table through ``ops.hash_encode.HashEncode``
  (the hash-encode kernel pair on the card), then the ReLU decoder with an
  identity output as one ``ops.fused_mlp.FusedMLP``, whose input cotangent
  feeds the table gradient;
- ``MultiSiren``: the frame's SIREN encoder, then the shared SIREN decoder,
  each as one fused SIREN stack (the fused-MLP kernel pair on the card). The
  JAX package runs both unfused (``_siren_forward``); the function is the
  same. The decoder hands dx on to the encoder; the encoder's coordinates
  need none.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..encodings.hashgrid import HashGridEncoding
from ..ops.fused_mlp import fused_mlp_apply, fused_siren_apply
from ..ops.hash_encode import HashEncode
from .core import Dense, Model, dense_init
from .hash_mlp import as_f32
from .siren import siren_init

__all__ = ["MultiSiren", "MultiHashMLP", "make_multi_siren", "make_multi_hash_mlp"]


def _stack_leaves(trees):
    """Trees of one structure -> one tree whose leaves are stacked on a leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack_leaves([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


class _SirenParams(nn.Module):
    """A SIREN tree as modules (``layers.{i}.w``, ``last.b``, ...), its leaves
    stacked over frames or not."""

    def __init__(self, tree):
        super().__init__()
        self.layers = nn.ModuleList(Dense(layer) for layer in tree["layers"])
        self.last = Dense(tree["last"])

    def params(self, frame_idx: Optional[int] = None):
        """The JAX tree; of frame ``frame_idx`` when the leaves are stacked."""
        if frame_idx is None:
            pick = lambda layer: layer.params  # noqa: E731
        else:
            pick = lambda layer: {"w": layer.w[frame_idx], "b": layer.b[frame_idx]}  # noqa: E731
        return {"layers": [pick(layer) for layer in self.layers], "last": pick(self.last)}


class MultiSiren(Model):
    name = "multi_siren"

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, n_layers: int, n_frames: int, w0: float,
                 w0_initial: float, sigma: float, generator: torch.Generator):
        super().__init__(dim_in, dim_out)
        self.n_layers, self.w0, self.w0_initial = n_layers, w0, w0_initial
        # each frame's encoder is drawn whole, one after another, then the decoder
        frames = [siren_init(dim_in, dim_hidden, dim_hidden, n_layers, w0, w0_initial, sigma, generator)
                  for _ in range(n_frames)]
        self.encoders = _SirenParams(_stack_leaves(frames))
        self.decoder = _SirenParams(siren_init(dim_hidden, dim_hidden, dim_out, n_layers, w0, w0_initial, sigma,
                                                generator))

    def forward(self, x: torch.Tensor, frame_idx: int = 0) -> torch.Tensor:
        z = fused_siren_apply(self.encoders.params(frame_idx), x, self.n_layers, self.w0, self.w0_initial)
        return fused_siren_apply(self.decoder.params(), z, self.n_layers, self.w0, self.w0_initial)


class _TableStack(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)  # (n_frames, T, F)


class MultiHashMLP(Model):
    name = "multi_hash_mlp"

    def __init__(self, geometry: HashGridEncoding, widths: Sequence[int], n_frames: int,
                 generator: torch.Generator):
        super().__init__(geometry.input_dim, widths[-1])
        self.geometry = geometry
        self.encoders = _TableStack(torch.stack([geometry.init(generator) for _ in range(n_frames)]))
        self.decoder = nn.ModuleList(Dense(dense_init(widths[i], widths[i + 1], generator))
                                     for i in range(len(widths) - 1))

    def forward(self, x: torch.Tensor, frame_idx: int = 0) -> torch.Tensor:
        z = HashEncode.apply(as_f32(self.encoders.table[frame_idx]), x, self.geometry)
        return fused_mlp_apply([layer.params for layer in self.decoder], z, "relu")


def make_multi_siren(
    dim_in: int = 3,
    dim_hidden: int = 64,
    dim_out: int = 1,
    n_layers: int = 4,
    n_frames: int = 15,
    w0: float = 30.0,
    w0_initial: float = 30.0,
    sigma: float = 6.0,
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    seed: int = 0,
    device: DeviceLike = None,
) -> MultiSiren:
    """One SIREN encoder (dim_in -> dim_hidden) per frame and a shared SIREN
    decoder (dim_hidden -> dim_out), with the JAX factory's defaults (``lr``
    and ``weight_decay`` are recorded in ``hparams``, as there). Parameters
    are drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and
    moved to ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = MultiSiren(dim_in, dim_hidden, dim_out, n_layers, n_frames, w0, w0_initial, sigma, gen)
    model.hparams = {"lr": lr, "weight_decay": weight_decay, "n_frames": n_frames}
    return model.to(dev)


def make_multi_hash_mlp(
    dim_in: int = 3,
    dim_out: int = 1,
    n_frames: int = 15,
    n_levels: int = 16,
    n_features_per_level: int = 2,
    log2_hashmap_size: int = 19,
    base_resolution: Union[int, Sequence[int]] = 16,
    per_level_scale: float = 1.4,
    dim_hidden: int = 128,
    n_layers: int = 2,
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    seed: int = 0,
    device: DeviceLike = None,
) -> MultiHashMLP:
    """One hash table per frame (stacked: ``encoders.table`` is
    (n_frames, T, F)) and a shared ReLU decoder with an identity output, with
    the JAX factory's defaults. Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device``."""
    dev = resolve_device(device)
    geometry = HashGridEncoding(
        dim=dim_in,
        n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        log2_hashmap_size=log2_hashmap_size,
        base_resolution=base_resolution,
        finest_resolution=None,
        per_level_scale=per_level_scale,
    )
    gen = torch.Generator().manual_seed(seed)
    widths = [geometry.output_dim] + [dim_hidden] * (n_layers - 1) + [dim_out]
    model = MultiHashMLP(geometry, widths, n_frames, gen)
    model.hparams = {"lr": lr, "weight_decay": weight_decay, "n_frames": n_frames, "encoder": geometry}
    return model.to(dev)
