"""The traced sub-window of a ``--trace 1`` run, read from torch.profiler.

:class:`Tracer` starts the profiler (CPU and CUDA activities) and marks
the window with a user annotation, so that the window's bounds and the
device's work share the trace's clock. After the run it exports the chrome
trace into ``TMPDIR``, reads it, and deletes the file. :class:`TraceWindow`
holds what the per-layer metrics read:

- the device operations (kernels, copies, fills) that ran inside the
  window, each with its name, start and duration;
- ``busy_s``: the union of their intervals; ``window_s``: the window;
- the seconds of each kind of work (``kernels/<family>.json``: the work
  its kernels do, such as ``hash_forward``, and their name patterns, matched
  as regular expressions; the first file in name order that matches wins),
  so a kernel added later for work already counted joins it by a new file;
- the breakdown: the device operations that took most time, and the
  longest idle gaps, each named by the innermost host event around it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
WINDOW = "benchmark.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_NAME_CHARS = 120


def kernel_families(root: Path = KERNELS_DIR) -> Dict[str, Tuple[str, List[re.Pattern]]]:
    """{family: (work, [compiled patterns])} from every ``<family>.json`` there."""
    families = {}
    for p in sorted(root.glob("*.json")):
        spec = json.loads(p.read_text())
        families[p.stem] = (spec["work"], [re.compile(s) for s in spec["patterns"]])
    return families


@dataclass
class TraceWindow:
    window_s: float
    ops: List[Tuple[str, float, float]]  # (name, start s, duration s), device, inside the window
    host: List[Tuple[str, float, float]]  # (name, start s, duration s), host events
    start_s: float = 0.0
    families: Dict[str, Tuple[str, List[re.Pattern]]] = field(default_factory=kernel_families)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged())

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def work_of(self, name: str) -> Optional[str]:
        """The work that a device operation of this name does, or None."""
        for work, patterns in self.families.values():
            if any(p.search(name) for p in patterns):
                return work
        return None

    def work_s(self, works: Sequence[str]) -> float:
        """Seconds of the device operations that do these kinds of work."""
        return sum(dur for name, _, dur in self.ops if self.work_of(name) in works)

    def _merged(self) -> List[Tuple[float, float]]:
        spans = sorted((s, s + d) for _, s, d in self.ops)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def breakdown(self, top: int = 10, labelled: int = 500) -> Dict[str, List]:
        """``device_ops``: seconds by operation name; ``idle_gaps``: seconds
        of the ``labelled`` longest gaps (and of the window's edges) by the
        innermost host event at each gap's middle; the ``top`` of each."""
        by_op: Dict[str, float] = {}
        for name, _, dur in self.ops:
            key = name[:_NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + dur
        merged = self._merged()
        edges = [self.start_s] + [x for ab in merged for x in ab] + [self.start_s + self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:labelled]
        by_gap: Dict[str, float] = {}
        if self.host:
            names = [h[0] for h in self.host]
            starts = np.array([h[1] for h in self.host])
            ends = starts + np.array([h[2] for h in self.host])
            durs = ends - starts
            for a, b in gaps:
                mid = 0.5 * (a + b)
                inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
                label = names[inside[np.argmin(durs[inside])]][:_NAME_CHARS] if len(inside) else "(no host event)"
                by_gap[label] = by_gap.get(label, 0.0) + (b - a)
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_gap.items()), key=lambda kv: -kv[1])[:top]}


def read_chrome_trace(path: str) -> TraceWindow:
    """The window marked ``WINDOW`` in a chrome trace, with the device
    operations and host events that fall inside it (times in seconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window marks, not 1")
    w0, w1 = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur < w0 or ts > w1:
            continue
        if e.get("cat") in _DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            ops.append((e["name"], a * 1e-6, (b - a) * 1e-6))
        elif e.get("cat") in _HOST_CATS and e.get("name") != WINDOW:
            host.append((e["name"], ts * 1e-6, dur * 1e-6))
    return TraceWindow(window_s=(w1 - w0) * 1e-6, ops=ops, host=host, start_s=w0 * 1e-6)


class Tracer:
    """torch.profiler over one window: :meth:`start` and :meth:`stop` may be
    called from different frames (a hook of the timed call); :meth:`read`
    after the run."""

    def __init__(self):
        import torch

        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = None
        self.done = False

    def warm(self) -> None:
        """Initialise the profiler once in set-up, so that the window's start
        pays no first-use cost."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self.prof.start()
        self.mark = self.torch.profiler.record_function(WINDOW)
        self.mark.__enter__()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def read(self) -> TraceWindow:
        if not self.done:
            raise RuntimeError("the traced window never closed")
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return read_chrome_trace(path)
        finally:
            os.unlink(path)
