"""Toolchain probe: y = 2 * x, a CUDA kernel and its plain version.

Port of the Pallas probe ``trivial`` of ``scripts/bench_pallas_exec.py``.
:func:`check_build` is the port's build check: it builds the kernels at
first use and holds the probe kernel on a (256, 128) fp32 array exactly to
``2 * x``; ``launcher.run`` calls it once before a run.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel (``csrc/probe.cu``) or the wrapper raises. :data:`LAUNCHES` counts
kernel launches only. :func:`launch_empty` launches a kernel that does
nothing (card only, not counted): its time is a launch's, the floor under
the probe's.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import DeviceLike, resolve_device
from . import build

__all__ = ["LAUNCHES", "PROBE_SHAPE", "reset_launches", "probe_reference", "probe", "launch_empty", "check_build"]

LAUNCHES = {"probe": 0}
PROBE_SHAPE = (256, 128)


def reset_launches() -> None:
    LAUNCHES["probe"] = 0


def _library() -> ctypes.CDLL:
    lib = build.load("probe")
    if lib.probe_double.argtypes is None:
        lib.probe_double.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.probe_double.restype = ctypes.c_int
        lib.probe_error_string.argtypes = [ctypes.c_int]
        lib.probe_error_string.restype = ctypes.c_char_p
        lib.probe_empty.argtypes = [ctypes.c_void_p]
        lib.probe_empty.restype = ctypes.c_int
    return lib


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    return 2 * x


def probe(x: torch.Tensor) -> torch.Tensor:
    """2 * x. CUDA tensors launch the probe kernel; CPU tensors take the plain version."""
    if not x.is_cuda:
        return probe_reference(x)
    build.check_tensor("x", x, tuple(x.shape), x.device)
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.probe_double(x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe launch failed: {lib.probe_error_string(err).decode()} (cudaError {err})")
    if x.numel() > 0:
        LAUNCHES["probe"] += 1
    return y


def launch_empty(device: torch.device) -> None:
    """Launch the empty kernel once on ``device``'s current stream (a CUDA
    device: there is nothing to run elsewhere)."""
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on a CUDA device, not {device}")
    lib = _library()
    with torch.cuda.device(device):
        err = lib.probe_empty(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_empty launch failed: {lib.probe_error_string(err).decode()} (cudaError {err})")


def check_build(device: DeviceLike = None) -> None:
    """Build the kernels if they are not built yet and hold the probe on a
    (256, 128) array exactly to 2 * x; raises RuntimeError otherwise."""
    dev = resolve_device(device)
    x = (torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32) / 7 - 1000).reshape(PROBE_SHAPE)
    x = x.to(dev)
    if not torch.equal(probe(x), probe_reference(x)):
        raise RuntimeError(f"the probe kernel on {dev} does not return 2 * x")
