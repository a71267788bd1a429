"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from a profiled sub-window of the same window. Each number that
decides ``correct`` is printed beside its limit, as the last lines of
standard error and under ``checks``, the last key of the result. The last
line of standard output is the result, one JSON object.

The run refuses (exit 2, no result) without as many CUDA devices as the
cell asks for, and (exit 3, no result) if JAX or the JAX package was
loaded by the time the window closed. Build and kernel caches go to fixed
directories inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mri_interpolation_tpu")
CACHE_DIR = spec.ROOT / ".bench_cache"


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at a fixed path
    (the port builds its own kernels into ``mri_interpolation_tpu_torch/ops/_build/``).
    Python's bytecode goes there too, written even where the environment
    turns bytecode caches off: otherwise every process compiles torch's
    sources again (about 3 s of a flagship.interp set-up of 10 s on an
    H100 host whose environment sets PYTHONDONTWRITEBYTECODE); from the
    second run on they are read."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.pycache_prefix = str(CACHE_DIR / "pycache")
    sys.dont_write_bytecode = False


def require_chips(n: int):
    """The first CUDA device, or exit 2 when there are fewer than ``n``."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {n} CUDA device(s), found {found}", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip() or None


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    cell = spec.load_cell(args.workload)
    dev = require_chips(cell.chips)
    import torch

    torch.set_num_threads(1)
    out = spec.entry(cell).run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)

    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed}
    if args.trace:
        if out.trace is None:
            raise RuntimeError("--trace 1 but the entry traced nothing")
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        metrics = {}
        for m in cell.per_layer:
            reader = spec.metric_reader(m["name"])
            value = reader(out) if reader is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result.update(metrics=metrics, device=device, breakdown=out.trace.breakdown())
    else:
        result.update(metrics={m["name"]: {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=device)
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": limit}
                        for name, (v, limit) in out.checks.items()}
    for line in out.notes:
        print(line, file=sys.stderr)
    for name, (v, limit) in out.checks.items():
        print(f"check {name} {v!r} limit {limit!r} {'ok' if v <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
