"""The port's host spans in a traced window, for the per-layer readers.

The port opens its spans (``mri_interpolation_tpu_torch/tracing.py``)
through ``torch.profiler.record_function``, so they reach the trace as
host events beside torch's own, on the device's clock. A mean over spans
counts only those that lie whole inside the window: the fit's window opens
and closes inside a step, and a span open when the profiler stops has no
end that belongs to the window. A total over the window clips its events
to the window instead, as the device's operations are clipped. Nothing is
read where no such event ran (a tree or a cell without it): the readers
then return None, never 0.
"""

from __future__ import annotations

from typing import Optional

from .trace import TraceWindow


def _matches(name: str, key: str, prefix: bool) -> bool:
    return name.startswith(key) if prefix else name == key


def mean_wall_s(window: TraceWindow, name: str, prefix: bool = False) -> Optional[float]:
    """Mean seconds of the host events named ``name`` (with ``prefix``:
    whose name starts with it) that lie whole inside the window; None if
    there are none."""
    lo, hi = window.start_s, window.start_s + window.window_s
    walls = [d for n, s, d in window.host if _matches(n, name, prefix) and lo <= s and s + d <= hi]
    return sum(walls) / len(walls) if walls else None


def total_wall_s(window: TraceWindow, name: str, prefix: bool = False) -> Optional[float]:
    """Seconds of the window covered by the host events named ``name``
    (with ``prefix``: whose name starts with it), each clipped to the
    window, the union of their intervals so that a nested event is counted
    once; None if none falls inside it."""
    lo, hi = window.start_s, window.start_s + window.window_s
    spans = sorted((max(s, lo), min(s + d, hi)) for n, s, d in window.host
                   if _matches(n, name, prefix) and s < hi and s + d > lo)
    if not spans:
        return None
    total, end = 0.0, lo
    for a, b in spans:
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total
