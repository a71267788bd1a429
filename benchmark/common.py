"""What the entries share: the outcome of a run and a few device helpers."""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .trace import TraceWindow


@dataclass
class Outcome:
    metrics: Dict[str, float]  # end-to-end values by name (the harness keeps the cell's own)
    checks: Dict[str, Tuple[float, float]]  # each number compared: (reading, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: List[str] = field(default_factory=list)  # lines for standard error
    trace: Optional[TraceWindow] = None  # --trace 1: the traced sub-window
    units: int = 0  # steps or requests inside it
    work: Dict = field(default_factory=dict)  # least seconds a unit, by part (roofline.py)

    @property
    def correct(self) -> bool:
        """Every number within its limit, and no attempt of the window failed."""
        return self.failed == 0 and all(v == v and v <= limit for v, limit in self.checks.values())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def strict_fp32():
    """float32 products in full precision (no TF32) for the reference,
    whatever the process had set; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class HostMeter:
    """This process's CPU time over a window's wall, for standard error: near
    one core where the host's dispatch paces the window."""

    def __init__(self):
        self.t0, self.cpu0 = time.perf_counter(), _process_cpu()

    def note(self) -> str:
        wall = time.perf_counter() - self.t0
        return f"host over the window: this process {(_process_cpu() - self.cpu0) / wall:.3f} of a core"


def _process_cpu() -> float:
    t = os.times()
    return t.user + t.system


def set_up_note(t_start: float, marks: List[Tuple[str, float]]) -> str:
    """Set-up's seconds by phase: before the entry (imports, the card's
    context), then between each of ``marks`` (name, host clock)."""
    parts = [f"{marks[0][0]} {marks[0][1] - t_start:.3f} s"]
    parts += [f"{name} {t - prev:.3f} s" for (_, prev), (name, t) in zip(marks, marks[1:])]
    return "set-up: " + ", ".join(parts)
