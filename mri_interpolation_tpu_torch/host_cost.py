"""Host time per call of the kernel wrappers, on the card.

Each wrapper is called back to back on a batch of one row, where its
kernels take a few microseconds of device time, so the rate is that of the
host's path through the wrapper (checks, plan, scratch allocation, ctypes
call, launches). Timed: the fused-MLP forward (kernel 5) at path B's
decoder (32 -> 128 -> 1, relu), multi_hash_mlp's decoder (20 -> 64 -> 1,
relu) and path A's SIREN (3 -> 128 x 6 -> 1); and, as controls whose host
path a change to kernel 5 leaves alone, the fused-MLP backward (kernel 6)
at path B's decoder and the hash-encode forward (kernel 1) on the flagship
encoder. It uses only the wrappers' public calls, so the same file times
another checkout of the package. Run on a machine with a card:

    python -m mri_interpolation_tpu_torch.host_cost [--calls N] [--repeats R]

It prints one line per wrapper and, last, one JSON object {name: {"median_us",
"runs_us"}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .device import resolve_device
from .encodings import HashGridEncoding
from .ops import fused_mlp as fm
from .ops import hash_encode as he

__all__ = ["calls_to_time", "run", "main"]


def _stack(gen: torch.Generator, dims: Sequence[int], dev: torch.device):
    ws = [((torch.rand((k, n), generator=gen) * 2 - 1) / k ** 0.5).to(dev) for k, n in zip(dims[:-1], dims[1:])]
    bs = [((torch.rand((n,), generator=gen) * 2 - 1) / 10).to(dev) for n in dims[1:]]
    return ws, bs, (torch.rand((1, dims[0]), generator=gen) * 2 - 1).to(dev)


def calls_to_time(dev: torch.device) -> Dict[str, Callable[[], object]]:
    """{name: a call of one wrapper on one row}."""
    gen = torch.Generator().manual_seed(0)
    relu = fm.mlp_acts(1, "relu")
    b_ws, b_bs, b_x = _stack(gen, [32, 128, 1], dev)
    b_g = torch.ones((1, 1), device=dev)
    mh_ws, mh_bs, mh_x = _stack(gen, [20, 64, 1], dev)
    a_ws, a_bs, a_x = _stack(gen, [3] + [128] * 6 + [1], dev)
    siren = fm.siren_acts(6, 30.0, 30.0)
    enc = HashGridEncoding(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                           base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
    table = (torch.rand((enc.total_size, 1), generator=gen) * 2 - 1).to(dev)
    x3 = torch.rand((1, 3), generator=gen).to(dev)
    return {
        "kernel 5, B decoder 32-128-1": lambda: fm.mlp_forward(b_ws, b_bs, b_x, relu),
        "kernel 5, multi_hash decoder 20-64-1": lambda: fm.mlp_forward(mh_ws, mh_bs, mh_x, relu),
        "kernel 5, A SIREN 3-128x6-1": lambda: fm.mlp_forward(a_ws, a_bs, a_x, siren),
        "kernel 6 (control), B decoder": lambda: fm.mlp_backward(b_ws, b_bs, b_x, b_g, relu, True),
        "kernel 1 (control), flagship encoder": lambda: he.hash_encode_forward(enc, table, x3),
    }


def run(calls: int = 2000, repeats: int = 5, device: Optional[str] = None) -> Dict[str, dict]:
    """Host microseconds per call of each wrapper: ``repeats`` runs of
    ``calls`` back-to-back calls each, after a warm-up. Needs a card."""
    dev = resolve_device(device)
    out = {}
    with torch.no_grad():
        for name, fn in calls_to_time(dev).items():
            for _ in range(50):
                fn()
            runs: List[float] = []
            for _ in range(repeats):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize(dev)
                runs.append((time.perf_counter() - t0) / calls * 1e6)
            out[name] = {"median_us": statistics.median(runs), "runs_us": runs}
            print(f"{name:40s} median {out[name]['median_us']:.2f} us a call "
                  f"(runs {', '.join(f'{r:.2f}' for r in runs)})", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.calls, args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
