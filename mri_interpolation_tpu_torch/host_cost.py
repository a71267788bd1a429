"""Host time per call of the kernel wrappers, on the card.

Each wrapper is called back to back on a batch of one row, where its
kernels take a few microseconds of device time, so the rate is that of the
host's path through the wrapper (checks, plan, scratch allocation, ctypes
call, launches). Timed: the fused-MLP forward (kernel 5) at path B's
decoder (32 -> 128 -> 1, relu), multi_hash_mlp's decoder (20 -> 64 -> 1,
relu) and path A's SIREN (3 -> 128 x 6 -> 1); the fused-MLP backward
(kernel 6) at path B's decoder; the hash-encode forward (kernel 1) and
table gradient (kernel 2) on the flagship encoder. Kernel 5's rows were
timed against kernels 6 and 1 as controls when only kernel 5's host path
changed; a change to the binding of every kernel (the dispatcher ops of
``ops/library.py``) moves every row. It uses only the wrappers' public
calls, so the same file times another checkout of the package. Run on a
machine with a card:

    python -m mri_interpolation_tpu_torch.host_cost [--calls N] [--repeats R]

It prints one line per wrapper and, last, one JSON object {name: {"median_us",
"runs_us"}}. With ``--against DIR`` it times this package and the one in
another checkout ``DIR`` (e.g. a ``git archive`` of the parent commit) in
ONE process, in alternating blocks of ``--calls`` calls (``--repeats``
pairs, the first of each pair taking turns), so that the host's drift
between processes does not enter the difference: per wrapper both medians,
the median of the paired differences (this minus the other) and the share
of pairs where this one was faster. The other checkout is imported under
another package name (its imports are relative) and builds its own
kernels; one whose ``ops/library.py`` registers the same ``torch.library``
namespace cannot sit beside this one (compare such checkouts in separate
processes). ``--layers`` times, in the same alternating blocks, the layers
of three wrappers' paths (kernel 5 and kernel 6 at path B's decoder, kernel
1 on the flagship encoder): the ctypes launch alone, the op's CUDA impl,
the dispatcher op, the public wrapper, and with ``--against`` the other
checkout's wrapper.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .device import resolve_device
from .encodings import HashGridEncoding
from .ops import fused_mlp as fm
from .ops import hash_encode as he

__all__ = ["calls_to_time", "layer_calls", "run", "import_checkout", "run_paired", "run_layers", "main"]


def _stack(gen: torch.Generator, dims: Sequence[int], dev: torch.device):
    ws = [((torch.rand((k, n), generator=gen) * 2 - 1) / k ** 0.5).to(dev) for k, n in zip(dims[:-1], dims[1:])]
    bs = [((torch.rand((n,), generator=gen) * 2 - 1) / 10).to(dev) for n in dims[1:]]
    return ws, bs, (torch.rand((1, dims[0]), generator=gen) * 2 - 1).to(dev)


def calls_to_time(dev: torch.device, package=None) -> Dict[str, Callable[[], object]]:
    """{name: a call of one wrapper on one row}, of this package or of
    ``package`` (another checkout's, :func:`import_checkout`)."""
    if package is None:
        grid, fm_, he_ = HashGridEncoding, fm, he
    else:
        grid = importlib.import_module(package.__name__ + ".encodings").HashGridEncoding
        fm_ = importlib.import_module(package.__name__ + ".ops.fused_mlp")
        he_ = importlib.import_module(package.__name__ + ".ops.hash_encode")
    return _calls(dev, grid, fm_, he_)


def _calls(dev: torch.device, HashGridEncoding, fm, he) -> Dict[str, Callable[[], object]]:
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
    g4 = torch.ones((1, 4), device=dev)
    return {
        "kernel 5, B decoder 32-128-1": lambda: fm.mlp_forward(b_ws, b_bs, b_x, relu),
        "kernel 5, multi_hash decoder 20-64-1": lambda: fm.mlp_forward(mh_ws, mh_bs, mh_x, relu),
        "kernel 5, A SIREN 3-128x6-1": lambda: fm.mlp_forward(a_ws, a_bs, a_x, siren),
        "kernel 6 (control), B decoder": lambda: fm.mlp_backward(b_ws, b_bs, b_x, b_g, relu, True),
        "kernel 1 (control), flagship encoder": lambda: he.hash_encode_forward(enc, table, x3),
        "kernel 2, flagship encoder": lambda: he.hash_encode_table_grad(enc, x3, g4),
    }


def run(calls: int = 2000, repeats: int = 5, device: Optional[str] = None) -> Dict[str, dict]:
    """Host microseconds per call of each wrapper: ``repeats`` rounds of
    ``calls`` back-to-back calls of each, after a warm-up. Needs a card."""
    dev = resolve_device(device)
    out = {}
    for name, runs in _interleaved(calls_to_time(dev), calls, repeats, dev).items():
        out[name] = {"median_us": statistics.median(runs), "runs_us": runs}
        print(f"{name:40s} median {out[name]['median_us']:.2f} us a call "
              f"(runs {', '.join(f'{r:.2f}' for r in runs)})", flush=True)
    return out


def import_checkout(root: str, name: str = "other_checkout"):
    """The ``mri_interpolation_tpu_torch`` package of the checkout at ``root``,
    imported as ``name``."""
    init = Path(root).resolve() / "mri_interpolation_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules[name] = package
    spec.loader.exec_module(package)
    return package


def _block_us(fn, calls: int, dev: torch.device) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / calls * 1e6


def _interleaved(fns: Dict[str, Callable[[], object]], calls: int, repeats: int,
                 dev: torch.device) -> Dict[str, List[float]]:
    """``repeats`` rounds of one block of ``calls`` calls of each function,
    the order rotated by one each round: {name: microseconds a call, a round}."""
    names = list(fns)
    runs: Dict[str, List[float]] = {name: [] for name in names}
    with torch.no_grad():
        for fn in fns.values():
            for _ in range(50):
                fn()
        for r in range(repeats):
            k = r % len(names)
            for name in names[k:] + names[:k]:
                runs[name].append(_block_us(fns[name], calls, dev))
    return runs


def run_paired(other: str, calls: int = 2000, repeats: int = 9, device: Optional[str] = None) -> Dict[str, dict]:
    """Host microseconds per call of each wrapper here and in the checkout
    ``other``, in ``repeats`` pairs of alternating blocks in this process.
    Needs a card."""
    dev = resolve_device(device)
    theirs = calls_to_time(dev, import_checkout(other))
    out = {}
    for name, fn in calls_to_time(dev).items():
        runs = _interleaved({"this": fn, "other": theirs[name]}, calls, repeats, dev)
        mine, them = runs["this"], runs["other"]
        diffs = [a - b for a, b in zip(mine, them)]
        out[name] = {"median_us": statistics.median(mine), "other_median_us": statistics.median(them),
                         "median_diff_us": statistics.median(diffs),
                     "faster_share": sum(d < 0 for d in diffs) / len(diffs), "runs_us": mine, "other_runs_us": them}
        print(f"{name:40s} this {out[name]['median_us']:.2f} us, other {out[name]['other_median_us']:.2f} us a "
                  f"call; paired difference median {out[name]['median_diff_us']:+.2f} us, this faster in "
                  f"{out[name]['faster_share']:.0%} of {repeats} pairs", flush=True)
    return out


def layer_calls(dev: torch.device) -> Dict[str, Callable[[], object]]:
    """The layers of three wrappers' paths on one row: the ctypes launch, the
    op's CUDA impl, the dispatcher op and the public wrapper."""
    gen = torch.Generator().manual_seed(0)
    relu = fm.mlp_acts(1, "relu")
    ws, bs, x = _stack(gen, [32, 128, 1], dev)
    g = torch.ones((1, 1), device=dev)
    params, words = [t for pair in zip(ws, bs) for t in pair], fm.act_words(relu)
    enc = HashGridEncoding(dim=3, n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                           base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
    table = (torch.rand((enc.total_size, 1), generator=gen) * 2 - 1).to(dev)
    x3 = torch.rand((1, 3), generator=gen).to(dev)
    key, ops = list(enc.geometry_key()), torch.ops.mri_torch
    return {
        "k5 B: ctypes launch": lambda: fm._forward_kernel(ws, bs, x, relu),
        "k5 B: CUDA impl": lambda: fm._forward_cuda(x, params, words),
        "k5 B: op": lambda: ops.fused_mlp_forward.default(x, params, words),
        "k5 B: wrapper": lambda: fm.mlp_forward(ws, bs, x, relu),
        "k6 B: ctypes launches": lambda: fm._backward_kernel(ws, bs, x, g, relu, True),
        "k6 B: CUDA impl": lambda: fm._backward_cuda(x, g, params, words, True),
        "k6 B: op": lambda: ops.fused_mlp_backward.default(x, g, params, words, True),
        "k6 B: wrapper": lambda: fm.mlp_backward(ws, bs, x, g, relu, True),
        "k1 flagship: CUDA impl": lambda: he._forward_cuda(table, x3, key),
        "k1 flagship: op": lambda: ops.hash_encode_forward.default(table, x3, key),
        "k1 flagship: wrapper": lambda: he.hash_encode_forward(enc, table, x3),
    }


def run_layers(calls: int = 2000, repeats: int = 9, other: Optional[str] = None,
               device: Optional[str] = None) -> Dict[str, dict]:
    """Host microseconds per call of each of :func:`layer_calls` (and, with
    ``other``, that checkout's three wrappers) in rotating blocks in this
    process. Needs a card."""
    dev = resolve_device(device)
    fns = layer_calls(dev)
    if other is not None:
        theirs = calls_to_time(dev, import_checkout(other))
        fns.update({"k5 B: other's wrapper": theirs["kernel 5, B decoder 32-128-1"],
                    "k6 B: other's wrapper": theirs["kernel 6 (control), B decoder"],
                    "k1 flagship: other's wrapper": theirs["kernel 1 (control), flagship encoder"]})
    out = {}
    for name, runs in _interleaved(fns, calls, repeats, dev).items():
        out[name] = {"median_us": statistics.median(runs), "runs_us": runs}
        print(f"{name:32s} median {out[name]['median_us']:.2f} us a call", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--against", default=None, help="another checkout's root, timed in the same process")
    parser.add_argument("--layers", action="store_true", help="time the layers of three wrappers' paths")
    args = parser.parse_args(argv)
    if args.layers:
        print(json.dumps(run_layers(args.calls, args.repeats, args.against)))
    elif args.against:
        print(json.dumps(run_paired(args.against, args.calls, args.repeats)))
    else:
        print(json.dumps(run(args.calls, args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
