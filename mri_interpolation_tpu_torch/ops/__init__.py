"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- hash_encode: multiresolution hash-encode forward and table gradient, of
  all levels and of the coarse dense levels alone (replaces the Pallas
  ``_forward_kernel`` / ``_backward_kernel`` and ``_onehot_forward_kernel`` /
  ``_onehot_backward_kernel`` of ``mri_interpolation_tpu/ops/pallas/hash_encode.py``);
- fused_mlp: the fused MLP stack's forward and backward (replaces the Pallas
  ``_forward_kernel`` / ``_backward_kernel`` of
  ``mri_interpolation_tpu/ops/pallas/fused_mlp.py``);
- sine_layer: one SIREN sine layer's bias, w0 scale and sine after its
  cuBLAS product, forward and backward (replaces no Pallas kernel: the JAX
  package leaves the chain to XLA; the PSF SIREN's forward);
- probe: y = 2 * x, the build check (replaces the Pallas probe ``trivial`` of
  ``scripts/bench_pallas_exec.py``);
- hash_mlp_grid: one chunk of a hash-MLP's dense grid as one op call,
  kernel 1's grid variant (the coordinates made from the flat voxel index)
  then kernel 5 (``infer/grid.py``'s ``fused_grid`` route).

Sources live in ``csrc/`` and are built by ``build.py`` at first use.
Kernels 1-6 and the sine-layer pair are reached through the dispatcher
ops ``torch.ops.mri_torch.*`` (``library.py``, registered when this
package is imported): a CUDA impl
that launches the kernel, a CPU impl that runs the plain version, and a
fake impl for tracing.
"""

from .hash_encode import (
    LAUNCHES,
    HashEncode,
    HashEncodeCoarse,
    coarse_onehot_levels,
    hash_encode_coarse,
    hash_encode_forward,
    hash_encode_reference,
    hash_encode_table_grad,
    hash_encode_table_grad_reference,
    reset_launches,
)
from . import library  # noqa: F401  (registers the ops)

__all__ = [
    "LAUNCHES",
    "HashEncode",
    "HashEncodeCoarse",
    "coarse_onehot_levels",
    "hash_encode_coarse",
    "hash_encode_forward",
    "hash_encode_reference",
    "hash_encode_table_grad",
    "hash_encode_table_grad_reference",
    "reset_launches",
]
