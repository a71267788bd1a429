"""Utilities: the undersampling mask, the PSF and the viewers
(``imaging``); timing, tracing and NaN debugging (here).

The JAX package's ``setup_compilation_cache`` and
``device_count_nonblocking`` work around its TPU environment (a persistent
XLA cache, a device enumeration that can block); the port has neither
(ROADMAP.md, "Out of scope")."""

from __future__ import annotations

import os
import time

import torch

from .imaging import apply_psf, create_rn_mask, psf_kernel, show, show_slices, tensor_visualisation

__all__ = ["create_rn_mask", "psf_kernel", "apply_psf", "show_slices", "show", "tensor_visualisation",
           "time_fn", "capture_trace", "enable_nan_debugging"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 10, **kwargs) -> float:
    """Milliseconds a call of ``fn(*args, **kwargs)``: the best of ``iters``
    timed calls after one untimed one, each ended by
    ``torch.cuda.synchronize()`` where CUDA is in use (so the time is the
    host's dispatch and the device's work together)."""
    fn(*args, **kwargs)
    _sync()
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def capture_trace(fn, outdir: str, *args, iters: int = 3, **kwargs):
    """Run ``fn(*args, **kwargs)`` ``iters`` times under ``torch.profiler``
    (the CPU, and CUDA where it is available), synchronising after each
    call, and write the trace as ``outdir/trace.json`` (Chrome trace
    format: Perfetto or chrome://tracing). Returns fn's last result."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = None
    with profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(*args, **kwargs)
            _sync()
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    return out


def enable_nan_debugging(enabled: bool = True) -> None:
    """``torch.autograd.set_detect_anomaly``: a backward function that
    returns NaN raises, with the traceback of the forward operation that
    made it. It checks the backward only, where the JAX package's
    ``jax_debug_nans`` checks the output of every jitted computation,
    forwards included."""
    torch.autograd.set_detect_anomaly(enabled)
