"""mri_interpolation_tpu_torch — the PyTorch and CUDA port of
``mri_interpolation_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: every module here keeps its
counterpart's name and semantics, and the tests feed both the same inputs.
This package imports ``torch`` and numpy only, never ``jax`` and nothing of
the JAX package.

Entry points (``python -m mri_interpolation_tpu_torch.launcher``,
``launcher.main``, ``launcher.run``, ``train.Trainer.fit``,
``infer.evaluate_grid``, ``models.make_hash_mlp``, ``models.make_siren``)
run on ``cuda`` unless the caller passes ``device="cpu"`` (``--device cpu``);
with no card they raise. The hand-written
CUDA kernels (``ops/csrc``) are built with ``nvcc`` at first use; on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from . import io
from .device import resolve_device

__all__ = ["io", "resolve_device", "__version__"]
