"""Where the fused-MLP kernels' time goes, on the card.

Builds copies of ``ops/csrc/fused_mlp.cu`` with one part cut out each. The
backward's cuts (kernel 6) are timed through ``ops.fused_mlp.mlp_backward``
(its tile pass and its weight-gradient kernel) at the multi-frame SIREN's
encoder (2 -> 128 x 4 -> 128, one 352 x 352 frame) and at path A's step
(SIREN 3 -> 128 x 6 -> 1, 4,096 rows); the forward's cuts (kernel 5: its
MMAs, its sine, its fragment loads, its epilogue, the weight-split
prologue, the weight staging) through ``ops.fused_mlp.mlp_forward`` (the
split kernel and the forward kernel) at the encoder and at path A's grid
chunk (131,072 rows). The uncut
build is timed in both. A cut copy computes wrong values: only its times
mean anything, as the time the cut part took (the uncut build's time minus
the cut one's). The forward's variants (``VARIANTS``: other block shapes)
compute the same function: each is timed on the forward's stacks, and its
largest difference from the uncut build's output is recorded. Run on a
machine with a card:

    python -m mri_interpolation_tpu_torch.ablate [--out PATH]

It prints one line per (cut or variant, stack) and, with ``--out``, writes
the records as JSON. A cut or variant whose text no longer matches the
source raises.
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

__all__ = ["CUTS", "FORWARD_CUTS", "VARIANTS", "cut_source", "run", "main"]

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
    # the forward's three MMAs of each product (route 1); the operands are still loaded
    "fwd_mma": [(f"                if (j0 + jj < live) mma_tf32(acc[j0 + jj], {a}, {b}[jj]);",
                 f"                if (j0 + jj < live) acc[j0 + jj][0] += __uint_as_float({a}[0] ^ {b}[jj][0]);")
                for a, b in (("al", "bh"), ("ah", "bl"), ("ah", "bh"))],
    # the forward's sine (route 1's sin_reduced; a sine layer's output becomes w0 * z / 2)
    "fwd_sine": [("      for (int i = 0; i < V; ++i) v[i] = sin_reduced(v[i]);",
                  "      for (int i = 0; i < V; ++i) v[i] = v[i] * 0.5f;")],
    # route 1's fragment loads: A (with its split) and B from shared memory, lane constants in their place
    "fwd_fragments": [
        ("          load_a(hin + rb * lda + (kFwdSteps * kc + kk) * 8, lda, g, t, ah, al);",
         "          for (int u = 0; u < 4; ++u) { ah[u] = lane * 7 + u + kk; al[u] = lane + u; }"),
        ("                const uint4 v = j0 + jj < live ? bs[(kk * nb + jb + j0 + jj) * 32 + lane] : make_uint4(0, 0, 0, 0);",
         "                const uint4 v = make_uint4(lane, jj, kk, j0);")],
    # route 1's epilogue: the activations and their stores
    "fwd_epilogue": [("          act_group(L.act, L.w0, h);", "          if (threadIdx.x > 100000) act_group(L.act, L.w0, h);"),
                     ("              if (j0 + jj < live)\n                store(",
                      "              if (j0 + jj < live && threadIdx.x > 100000)\n                store(")],
    # the prologue that splits W into TF32 hi/lo fragments
    "fwd_split": [("    fused_mlp_split_weights_kernel<<<", "    if (blocks < 0) fused_mlp_split_weights_kernel<<<")],
    # route 1's cp.async copies of the split weight chunks
    "fwd_staging": [("      cp_async16(reinterpret_cast<float*>(dst + e), reinterpret_cast<const float*>(src + e), 16);",
                     "      if (e < 0) cp_async16(reinterpret_cast<float*>(dst + e), reinterpret_cast<const float*>(src + e), 16);")],
}
FORWARD_CUTS = ("fwd_mma", "fwd_sine", "fwd_fragments", "fwd_epilogue", "fwd_split", "fwd_staging")

# variant -> replacements: the forward's block shape, other than the kernel's
# 8 warps over 64 (or 32) rows, each warp a 16-row band and half (or a
# quarter) of a 128-column pass; the host plan is unchanged, the kernel
# derives the shared memory from the rows
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # 8 warps over 128 (or 64) rows, each warp a band's whole pass: every
    # activation split once, 64 accumulators a thread
    "fwd_128_rows": [("constexpr int fwd_warp_cols(int c) { return c == 0 ? 2 : 4; }",
                      "constexpr int fwd_warp_cols(int c) { return c == 0 ? 1 : 2; }")],
    # 16 warps over 128 (or 64) rows, one block an SM: half the weight
    # traffic a row of the 64-row block
    "fwd_16_warps": [("constexpr int kFwdThreads = 256;", "constexpr int kFwdThreads = 512;"),
                     ("return 16 * (8 / fwd_warp_cols(c));", "return 16 * (16 / fwd_warp_cols(c));"),
                     ("__launch_bounds__(kFwdThreads, 2)\nfused_mlp_forward_kernel",
                      "__launch_bounds__(kFwdThreads, 1)\nfused_mlp_forward_kernel")],
}


def cut_source(source: str, cut: str) -> str:
    """``source`` with the replacements of ``cut`` (a cut or a variant);
    raises ValueError when one of them no longer matches exactly once."""
    for old, new in {**CUTS, **VARIANTS}[cut]:
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
    """(name, weights, biases, x, g, acts, pass) of each timed call."""
    gen = torch.Generator().manual_seed(0)
    out = []
    multi = make_multi_siren(dim_in=2, dim_hidden=128, n_layers=4, n_frames=1, device=dev, seed=0)
    enc = multi.encoders.params(0)
    siren = make_siren(3, dim_hidden=128, n_layers=6, device=dev, seed=0).params
    for name, params, n_layers, n, width, which in (("multi_siren encoder", enc, 4, 352 * 352, 2, "backward"),
                                                    ("path A", siren, 6, 4096, 3, "backward"),
                                                    ("multi_siren encoder", enc, 4, 352 * 352, 2, "forward"),
                                                    ("path A grid chunk", siren, 6, 1 << 17, 3, "forward")):
        layers = params["layers"] + [params["last"]]
        ws, bs = [l["w"].detach() for l in layers], [l["b"].detach() for l in layers]
        x = (torch.rand((n, width), generator=gen) * 2 - 1).to(dev)
        g = torch.randn((n, ws[-1].shape[1]), generator=gen).to(dev)
        out.append((name, ws, bs, x, g, fm.siren_acts(n_layers, 30.0, 30.0), which))
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
    """Build every cut and variant copy, then time each on each stack of
    its pass; one record per (cut or variant, stack). Needs a card."""
    dev = resolve_device("cuda")
    cuts = ["none", *(c for c in [*CUTS, *VARIANTS] if c != "none")] if cuts is None else list(cuts)
    libs = _build(cuts)
    stacks = _stacks(dev)
    original = build._loaded.get("fused_mlp")
    records, uncut = [], {}
    try:
        for cut in cuts:
            build._loaded["fused_mlp"] = ctypes.CDLL(str(libs[cut]))
            for i, (name, ws, bs, x, g, acts, which) in enumerate(stacks):
                if cut != "none" and (which == "forward") != (cut in FORWARD_CUTS or cut in VARIANTS):
                    continue  # a cut is timed in the pass it cuts
                if which == "forward":
                    call = lambda: fm.mlp_forward(ws, bs, x, acts)  # noqa: E731
                else:
                    call = lambda: fm.mlp_backward(ws, bs, x, g, acts, False)  # noqa: E731
                times = _device_us(call, iters)
                record = {"cut": cut, "stack": name, "pass": which, "rows": x.shape[0], "device_us": times,
                          "device": torch.cuda.get_device_name(dev)}
                if which == "forward" and cut == "none":
                    uncut[i] = call()
                elif cut in VARIANTS:
                    record["max_abs_diff"] = float((call() - uncut[i]).abs().max()) if i in uncut else None
                records.append(record)
                print(f"{cut:15s} {which:8s} {name:20s} "
                      + "  ".join(f"{k} {v:.1f} us" for k, v in sorted(times.items()))
                      + (f"  max abs diff from uncut {record['max_abs_diff']}" if cut in VARIANTS else ""),
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
