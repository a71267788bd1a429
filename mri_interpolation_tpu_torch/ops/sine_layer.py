"""One SIREN sine layer's elementwise chain: ``a = sin(w0 * (z + b))`` for
the layer's product ``z = x @ W``, forward and backward, as CUDA kernels and
their plain versions.

Replaces no Pallas kernel: the JAX package leaves the chain to XLA. The
kernels are in ``csrc/sine_layer.cu`` (built by ``ops/build.py``, bound with
ctypes): the forward in one pass (read z, write a), the backward in one
(read g and z, write ``dz = (g * cos(w0 * (z + b))) * w0``, with the bias
gradient ``db = sum over rows of dz`` summed on the way and finished by a
second, small kernel), where autograd ran six kernels and 14 passes. The
products stay with cuBLAS.

Dispatch: :func:`sine_layer_forward` and :func:`sine_layer_backward` call the
ops ``torch.ops.mri_torch.sine_layer_forward`` / ``sine_layer_backward``
(``ops/library.py``). Their CPU impls are the plain PyTorch versions
(:func:`sine_layer_reference`, :func:`sine_layer_backward_reference`), in
autograd's order of operations (``w0 * (z + b)``, then ``(g * cos(u)) *
w0``), so that a and dz equal the chain of ``models.siren.siren_layer_apply``
bit for bit and only the order of db's sum differs on the card. Their CUDA
impls launch the kernels or raise: z and g (n, width) float32, contiguous,
16-byte aligned, width a multiple of 4, b (width,) float32 on the same
card. They add one to their entry of :data:`LAUNCHES` per call that
launches, and nowhere else. :class:`SineLayer` is the autograd function;
it saves z and b.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..tracing import span
from . import build

__all__ = ["LAUNCHES", "reset_launches", "sine_layer_reference", "sine_layer_backward_reference",
           "sine_layer_forward", "sine_layer_backward", "SineLayer"]

LAUNCHES = {"sine_layer_forward": 0, "sine_layer_backward": 0}

# blocks of 256 threads an SM holds at most (2,048 threads): the backward's partial rows of db, one a block
_MAX_BLOCKS_PER_SM = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side yardstick)


def sine_layer_reference(z: torch.Tensor, b: torch.Tensor, w0: float) -> torch.Tensor:
    return torch.sin(w0 * (z + b))


def sine_layer_backward_reference(g: torch.Tensor, z: torch.Tensor, b: torch.Tensor, w0: float
                                  ) -> List[torch.Tensor]:
    """[dz, db] for upstream g: dz = (g * cos(w0 * (z + b))) * w0, db = dz
    summed over rows."""
    dz = (g * torch.cos(w0 * (z + b))) * w0
    return [dz, dz.sum(dim=0)]


# ---------------------------------------------------------------------------
# kernel wrappers


def _library() -> ctypes.CDLL:
    lib = build.load("sine_layer")
    if lib.sine_layer_forward.argtypes is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        lib.sine_layer_forward.argtypes = [p, p, p, i64, i32, f32, i32, p]
        lib.sine_layer_backward.argtypes = [p, p, p, p, p, i64, p, i64, i32, f32, i32, p]
        for fn in (lib.sine_layer_forward, lib.sine_layer_backward):
            fn.restype = ctypes.c_int
        lib.sine_layer_error_string.argtypes = [ctypes.c_int]
        lib.sine_layer_error_string.restype = ctypes.c_char_p
    return lib


def _check(z: torch.Tensor, b: torch.Tensor, g: Optional[torch.Tensor] = None) -> None:
    """What the kernels take; raises ValueError or TypeError otherwise."""
    if z.dim() != 2:
        raise ValueError(f"z must be (n, width), got shape {tuple(z.shape)}")
    n, width = z.shape
    if width % 4 != 0:
        raise ValueError(f"the kernels read rows as float4: width {width} is not a multiple of 4")
    tensors = [("z", z, (n, width)), ("b", b, (width,))] + ([("g", g, (n, width))] if g is not None else [])
    for name, t, shape in tensors:
        build.check_tensor(name, t, shape, z.device)
    for name, t, _ in tensors:
        if name != "b" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernels read it as float4)")
    if z.device.type != "cuda":
        raise ValueError(f"the sine-layer kernels run on a CUDA device, not {z.device}")


def _raise_on(lib: ctypes.CDLL, fn_name: str, err: int) -> None:
    if err != 0:
        msg = lib.sine_layer_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (cudaError {err})")


def _forward_cuda(z: torch.Tensor, b: torch.Tensor, w0: float) -> torch.Tensor:
    _check(z, b)
    a = torch.empty_like(z)
    n, width = z.shape
    if n == 0:
        return a
    lib = _library()
    with span("mri.op.launch"), torch.cuda.device(z.device):
        err = lib.sine_layer_forward(z.data_ptr(), b.data_ptr(), a.data_ptr(), n, width, w0,
                                     build.sm_count(z.device.index), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "sine_layer_forward", err)
    LAUNCHES["sine_layer_forward"] += 1
    return a


def _backward_cuda(g: torch.Tensor, z: torch.Tensor, b: torch.Tensor, w0: float) -> List[torch.Tensor]:
    _check(z, b, g)
    n, width = z.shape
    if n == 0:
        return [torch.empty_like(z), torch.zeros_like(b)]
    dz, db = torch.empty_like(z), torch.empty_like(b)
    sms = build.sm_count(z.device.index)
    partial = torch.empty((sms * _MAX_BLOCKS_PER_SM, width), dtype=torch.float32, device=z.device)
    lib = _library()
    with span("mri.op.launch"), torch.cuda.device(z.device):
        err = lib.sine_layer_backward(g.data_ptr(), z.data_ptr(), b.data_ptr(), dz.data_ptr(), partial.data_ptr(),
                                      partial.shape[0], db.data_ptr(), n, width, w0, sms,
                                      torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "sine_layer_backward", err)
    LAUNCHES["sine_layer_backward"] += 1
    return [dz, db]


def sine_layer_forward(z: torch.Tensor, b: torch.Tensor, w0: float) -> torch.Tensor:
    """sin(w0 * (z + b)) through the op ``sine_layer_forward``: CUDA tensors
    launch the forward kernel; CPU tensors take the plain version."""
    return torch.ops.mri_torch.sine_layer_forward.default(z, b, float(w0))


def sine_layer_backward(g: torch.Tensor, z: torch.Tensor, b: torch.Tensor, w0: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dz, db) through the op ``sine_layer_backward``: CUDA tensors launch
    the backward kernels; CPU tensors take the plain version."""
    dz, db = torch.ops.mri_torch.sine_layer_backward.default(g, z, b, float(w0))
    return dz, db


class SineLayer(torch.autograd.Function):
    """Differentiable ``SineLayer.apply(z, b, w0) = sin(w0 * (z + b))``, z
    the layer's product (n, width), b its bias (width,). Saves z and b; the
    backward recomputes the sine's argument."""

    @staticmethod
    def forward(ctx, z: torch.Tensor, b: torch.Tensor, w0: float) -> torch.Tensor:
        ctx.w0 = float(w0)
        ctx.save_for_backward(z, b)
        return sine_layer_forward(z, b, ctx.w0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        z, b = ctx.saved_tensors
        dz, db = sine_layer_backward(g.contiguous(), z, b, ctx.w0)
        return dz, db, None
