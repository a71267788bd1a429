"""Where the fused-MLP backward's time goes, on the card.

Builds copies of ``ops/csrc/fused_mlp.cu`` with one part of the backward cut
out each, and times both of its kernels (the tile pass and the weight
gradient) through ``ops.fused_mlp.mlp_backward`` at the multi-frame SIREN's
encoder (2 -> 128 x 4 -> 128, one 352 x 352 frame) and at path A (SIREN
3 -> 128 x 6 -> 1, 4,096 rows). A cut copy computes wrong values: only its
times mean anything, as the time the cut part took (the uncut build's time
minus the cut one's). Run on a machine with a card:

    python -m mri_interpolation_tpu_torch.ablate [--out PATH]

It prints one line per (cut, stack) and, with ``--out``, writes the records
as JSON. A cut whose text no longer matches the source raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .device import resolve_device
from .models import make_multi_siren, make_siren
from .ops import build
from .ops import fused_mlp as fm

__all__ = ["CUTS", "cut_source", "run", "main"]

# cut -> (old text, new text) replacements on fused_mlp.cu
CUTS: Dict[str, List[Tuple[str, str]]] = {
    "none": [],
    # every mma.sync (the accumulator still takes one cheap dependent operation)
    "mma": [("  asm(\n      \"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
             "  c[0] += __uint_as_float(a[0] ^ b[0] ^ a[3]);\n  if (false) asm(\n"
             "      \"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32")],
    # the sine layers' sincosf in pass 1's forward epilogue
    "trig": [("      sincosf(w0 * z, &sn, &cs);", "      sn = w0 * z;\n      cs = z;")],
    # pass 1's stores of act'(z), h and dz to the scratch
    "scratch_stores": [
        ("        dact[(row0 + r) * ztot + zoff + c] = d;\n",
         "        if (d == 12345.f) dact[(row0 + r) * ztot + zoff + c] = d;\n"),
        ("          hact[(row0 + r) * htot + hoff + c] = h;\n",
         "          if (h == 12345.f) hact[(row0 + r) * htot + hoff + c] = h;\n"),
        ("            dzs[(row0 + r) * ztot + pzoff + c] = v;\n",
         "            if (v == 12345.f) dzs[(row0 + r) * ztot + pzoff + c] = v;\n")],
    # pass 1's whole per-element epilogue (loads, activations, stores)
    "epilogue": [("      for (int i = 0; i < MT; ++i) {\n        float aux[NT][4];",
                  "      for (int i = 0; i < MT * (threadIdx.x > 100000); ++i) {\n        float aux[NT][4];")],
}


def cut_source(source: str, cut: str) -> str:
    """``source`` with the replacements of ``cut``; raises ValueError when
    one of them no longer matches exactly once."""
    for old, new in CUTS[cut]:
        if source.count(old) != 1:
            raise ValueError(f"cut {cut!r}: {old[:50]!r} matches {source.count(old)} times in fused_mlp.cu")
        source = source.replace(old, new)
    return source


def _build(cuts: Sequence[str]) -> Dict[str, Path]:
    source = build.SOURCES["fused_mlp"].read_text()
    work = build.BUILD_DIR / "ablate"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the cut copies")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = {}, {}
    for cut in cuts:
        src = work / f"fused_mlp_{cut}.cu"
        src.write_text(cut_source(source, cut))
        libs[cut] = work / f"libfused_mlp_{cut}.so"
        procs[cut] = subprocess.Popen([nvcc, *flags, "-o", str(libs[cut]), str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    for cut, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {cut!r} copy:\n{output}")
    return libs


def _stacks(dev: torch.device):
    gen = torch.Generator().manual_seed(0)
    out = []
    multi = make_multi_siren(dim_in=2, dim_hidden=128, n_layers=4, n_frames=1, device=dev, seed=0)
    enc = multi.encoders.params(0)
    siren = make_siren(3, dim_hidden=128, n_layers=6, device=dev, seed=0).params
    for name, params, n_layers, n, width in (("multi_siren encoder", enc, 4, 352 * 352, 2),
                                             ("path A", siren, 6, 4096, 3)):
        layers = params["layers"] + [params["last"]]
        ws, bs = [l["w"].detach() for l in layers], [l["b"].detach() for l in layers]
        x = (torch.rand((n, width), generator=gen) * 2 - 1).to(dev)
        g = torch.randn((n, ws[-1].shape[1]), generator=gen).to(dev)
        out.append((name, ws, bs, x, g, fm.siren_acts(n_layers, 30.0, 30.0)))
    return out


def _device_us(fn, iters: int) -> Dict[str, float]:
    """Device microseconds per call of ``fn`` by fused-MLP kernel (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times: Dict[str, float] = {}
    for evt in prof.key_averages():
        found = re.findall(r"fused_mlp_\w+", evt.key)
        if found and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            times[found[0]] = times.get(found[0], 0.0) + evt.self_device_time_total / iters
    return times


def run(cuts: Optional[Sequence[str]] = None, iters: int = 10) -> List[dict]:
    """Build every cut copy, then time each on each stack; one record per
    (cut, stack). Needs a card."""
    dev = resolve_device("cuda")
    cuts = list(CUTS) if cuts is None else list(cuts)
    libs = _build(cuts)
    stacks = _stacks(dev)
    original = build._loaded.get("fused_mlp")
    records = []
    try:
        for cut in cuts:
            build._loaded["fused_mlp"] = ctypes.CDLL(str(libs[cut]))
            for name, ws, bs, x, g, acts in stacks:
                times = _device_us(lambda: fm.mlp_backward(ws, bs, x, g, acts, False), iters)
                records.append({"cut": cut, "stack": name, "rows": x.shape[0], "device_us": times,
                                "device": torch.cuda.get_device_name(dev)})
                print(f"{cut:15s} {name:20s} " + "  ".join(f"{k} {v:.1f} us" for k, v in sorted(times.items())),
                      flush=True)
    finally:
        if original is None:
            build._loaded.pop("fused_mlp", None)
        else:
            build._loaded["fused_mlp"] = original
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the records as JSON here")
    args = parser.parse_args(argv)
    records = run()
    if args.out:
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
