"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- hash_encode: multiresolution hash-encode forward and table gradient
  (replaces the Pallas ``_forward_kernel`` / ``_backward_kernel`` of
  ``mri_interpolation_tpu/ops/pallas/hash_encode.py``);
- fused_mlp: the fused MLP stack's forward and backward (replaces the Pallas
  ``_forward_kernel`` / ``_backward_kernel`` of
  ``mri_interpolation_tpu/ops/pallas/fused_mlp.py``);
- probe: y = 2 * x, the build check (replaces the Pallas probe ``trivial`` of
  ``scripts/bench_pallas_exec.py``).

Sources live in ``csrc/`` and are built by ``build.py`` at first use.
"""

from .hash_encode import (
    LAUNCHES,
    HashEncode,
    hash_encode_forward,
    hash_encode_reference,
    hash_encode_table_grad,
    hash_encode_table_grad_reference,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "HashEncode",
    "hash_encode_forward",
    "hash_encode_reference",
    "hash_encode_table_grad",
    "hash_encode_table_grad_reference",
    "reset_launches",
]
