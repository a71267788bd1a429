"""Kernels 1-6 and the sine-layer pair as PyTorch dispatcher ops, in the
namespace ``mri_torch``.

One op per kernel or kernel pair (``hash_encode_forward``,
``hash_encode_table_grad``, ``hash_encode_coarse_forward``,
``hash_encode_coarse_table_grad``, ``fused_mlp_forward``,
``fused_mlp_backward``, ``sine_layer_forward``, ``sine_layer_backward``:
one SIREN sine layer's bias, w0 scale and sine after a cuBLAS product,
``ops/sine_layer.py``), and ``hash_mlp_grid_forward``: one chunk of a
dense grid through a hash encoder and a fused decoder, kernel 1's grid
variant then kernel 5, written in place into a feature buffer and the
volume's rows (``ops/hash_mlp_grid.py``; ``infer/grid.py``'s
``fused_grid`` route).

Each op has three impls:

- ``CUDA``: the ctypes launch of ``hash_encode.py`` / ``fused_mlp.py`` /
  ``sine_layer.py`` (the shared library is built at the first launch,
  never here), which counts its launch in the module's ``LAUNCHES`` and
  raises on what the kernel does not take;
- ``CPU``: the plain PyTorch version;
- fake: the output shapes and dtypes, from the arguments alone, so that
  ``torch.export`` traces a model through an op as one graph node
  (``infer/export.py``) and a loaded program finds the op again once this
  module is imported.

The dispatcher picks the impl by the tensors' device; there is no fallback
from the card to the plain version. Autograd stays with the
``torch.autograd.Function`` s of the three modules (``HashEncode``,
``HashEncodeCoarse``, ``FusedMLP``, ``SineLayer``), whose ``forward`` and
``backward`` call these ops through the public wrappers: an autograd
formula registered on the op would cost more host time a call.
``hash_mlp_grid_forward`` serves inference alone and has none.

Arguments are schema types: a hash geometry is
``HashGridEncoding.geometry_key()`` (rebuilt by ``HashGridEncoding.from_key``,
cached), the coarse pair's levels an ``int[]``, a stack's layers one
``Tensor[]`` (w_0, b_0, w_1, ...) and its activations one ``float[]`` of kind
codes and sine frequencies (``fused_mlp.act_words``): every list argument
costs the dispatcher about 1.5-2 µs a call.
"""

from __future__ import annotations

import torch

from ..encodings.hashgrid import HashGridEncoding
from . import fused_mlp as fm
from . import hash_encode as he
from . import hash_mlp_grid as hg
from . import sine_layer as sl

__all__ = ["NAMESPACE", "SCHEMAS"]

NAMESPACE = "mri_torch"

SCHEMAS = {
    "hash_encode_forward": "hash_encode_forward(Tensor table, Tensor x, int[] geometry) -> Tensor",
    "hash_encode_table_grad": "hash_encode_table_grad(Tensor x, Tensor g, int[] geometry) -> Tensor",
    "hash_encode_coarse_forward":
        "hash_encode_coarse_forward(Tensor table, Tensor x, int[] geometry, int[] levels) -> Tensor",
    "hash_encode_coarse_table_grad":
        "hash_encode_coarse_table_grad(Tensor x, Tensor g, int[] geometry, int[] levels) -> Tensor",
    "fused_mlp_forward": "fused_mlp_forward(Tensor x, Tensor[] params, float[] acts) -> Tensor",
    "fused_mlp_backward":
        "fused_mlp_backward(Tensor x, Tensor g, Tensor[] params, float[] acts, bool need_dx) -> Tensor[]",
    "sine_layer_forward": "sine_layer_forward(Tensor z, Tensor b, float w0) -> Tensor",
    "sine_layer_backward": "sine_layer_backward(Tensor g, Tensor z, Tensor b, float w0) -> Tensor[]",
    "hash_mlp_grid_forward":
        "hash_mlp_grid_forward(Tensor table, Tensor[] params, float[] acts, int[] geometry, int[] shape, float lo, "
        "float hi, int start, Tensor(a!) scratch, Tensor(b!) out) -> ()",
}


def _table_grad_fake(x, g, geometry, levels=None):
    enc = HashGridEncoding.from_key(geometry)
    return g.new_empty((enc.total_size, enc.n_features_per_level))


def _fake_fused_mlp_backward(x, g, params, acts, need_dx):
    return [p.new_empty(p.shape) for p in params] + ([x.new_empty(x.shape)] if need_dx else [])


# name: (CPU impl, CUDA impl, fake impl)
_IMPLS = {
    "hash_encode_forward": (
        he._forward_cpu, he._forward_cuda,
        lambda table, x, geometry: x.new_empty((x.shape[0], HashGridEncoding.from_key(geometry).output_dim))),
    "hash_encode_table_grad": (he._table_grad_cpu, he._table_grad_cuda, _table_grad_fake),
    "hash_encode_coarse_forward": (
        he._coarse_forward_cpu, he._coarse_forward_cuda,
        lambda table, x, geometry, levels: x.new_empty((x.shape[0], len(levels) * geometry[1]))),
    "hash_encode_coarse_table_grad": (he._coarse_table_grad_cpu, he._coarse_table_grad_cuda, _table_grad_fake),
    "fused_mlp_forward": (
        fm._forward_cpu, fm._forward_cuda,
        lambda x, params, acts: x.new_empty((x.shape[0], params[-2].shape[1]))),
    "fused_mlp_backward": (fm._backward_cpu, fm._backward_cuda, _fake_fused_mlp_backward),
    "sine_layer_forward": (sl.sine_layer_reference, sl._forward_cuda, lambda z, b, w0: z.new_empty(z.shape)),
    "sine_layer_backward": (sl.sine_layer_backward_reference, sl._backward_cuda,
                            lambda g, z, b, w0: [z.new_empty(z.shape), b.new_empty(b.shape)]),
    "hash_mlp_grid_forward": (hg._forward_cpu, hg._forward_cuda, lambda *args: None),  # writes in place
}

_LIB = torch.library.Library(NAMESPACE, "DEF")  # kept alive: the registrations live as long as it
for _name, _schema in SCHEMAS.items():
    _LIB.define(_schema)
    _cpu, _cuda, _fake = _IMPLS[_name]
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
