"""Where the hand-written kernels' time goes, on the card.

Builds copies of a kernel source with one part cut out each, swaps each copy
into ``ops.build._loaded`` and times the wrappers that launch it.

``ops/csrc/fused_mlp.cu`` (``CUTS``, ``FORWARD_CUTS``, ``VARIANTS``): the
backward's cuts (kernel 6) are timed through ``ops.fused_mlp.mlp_backward``
(its tile pass and its weight-gradient kernel) at the multi-frame SIREN's
encoder (2 -> 128 x 4 -> 128, one 352 x 352 frame) and at path A's step
(SIREN 3 -> 128 x 6 -> 1, 4,096 rows); the forward's cuts (kernel 5: its
MMAs, its sine, its fragment loads, its epilogue, the weight-split
prologue, the weight staging) through ``ops.fused_mlp.mlp_forward`` (the
split kernel and the forward kernel) at the encoder and at path A's grid
chunk (131,072 rows). The forward's variants (``VARIANTS``: other block
shapes) compute the same function: each is timed on the forward's stacks,
and its largest difference from the uncut build's output is recorded.

``ops/csrc/hash_encode.cu`` (``COARSE_CUTS``, ``COARSE_VARIANTS``,
``PLAN_VARIANTS``): the coarse-level pair, kernel 3 through
``hash_encode_coarse_forward`` and kernel 4 through
``hash_encode_coarse_table_grad``, on the multi-frame HashMLP's levels 0-3
at one 352 x 352 frame (123,904 points, x uniform, and the frame in raster
order) and on the kernel bench's geometry (65,536 points); kernel 3 at
other block sizes, and kernel 4 on other grids, cluster sizes and
accumulator copies than its plan gives (the same function, with its
largest difference from the uncut build's output). ``ablate_staged`` times
the staging kernels that kernels 3-4 were before, on the same shapes.

The uncut build of each source is timed on all its shapes. A cut copy
computes wrong values: only its times mean anything, as the time the cut
part took (the uncut build's time minus the cut one's). Run on a machine
with a card:

    python -m mri_interpolation_tpu_torch.ablate [--out PATH] [--cuts NAME ...]

``--cuts`` times only the named cuts and variants, in the order given (a
name may repeat). It prints one line per (cut or variant, shape) and, with
``--out``, writes the records as JSON. A cut or variant whose text no
longer matches the source raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .bench_kernels import bench_geometry
from .device import resolve_device
from .encodings.hashgrid import HashGridEncoding
from .models import make_multi_siren, make_siren
from .ops import build
from .ops import fused_mlp as fm
from .ops import hash_encode as he

__all__ = ["CUTS", "FORWARD_CUTS", "VARIANTS", "COARSE_CUTS", "COARSE_FORWARD_CUTS", "COARSE_VARIANTS",
           "PLAN_VARIANTS", "SOURCE_OF", "replace_once", "cut_source", "compile_copies", "coarse_calls", "device_us",
           "time_record", "print_record", "run", "main"]

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


# cut -> replacements on hash_encode.cu: the coarse-level pair
COARSE_CUTS: Dict[str, List[Tuple[str, str]]] = {
    "coarse_none": [],
    # kernel 3: the stores of the outputs (16-byte and scalar)
    "k3_stores": [("          *reinterpret_cast<float4*>(o + j * F + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);",
                   "          if (v[q] == 12345.f)\n"
                   "            *reinterpret_cast<float4*>(o + j * F + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);"),
                  ("      for (int q = 0; q < F; ++q) o[j * F + q] = v[q];",
                   "      for (int q = 0; q < F; ++q) if (v[q] == 12345.f) o[j * F + q] = v[q];")],
    # kernel 4: the warp sums (the match of each (point, level) and the trees); every lane adds its own terms
    "k4_no_warp_sums": [("        const WarpGroups wg = warp_groups(live ? rows[0] : -1 - lane, lane);", ""),
                        ("          if (warp_tree_sum<VF>(wg, v) && live) {", "          if (live) {")],
    # kernel 4: the updates of the accumulators by the warp sums (shared atomics, or plain adds to a warp's copy)
    "k4_updates": [("                if (q < nf) a[q] = __fadd_rn(a[q], v[q]);",
                    "                if (q < nf && v[q] == 12345.f) a[q] = __fadd_rn(a[q], v[q]);"),
                   ("                if (q < nf) atomicAdd(a + q, v[q]);",
                    "                if (q < nf && v[q] == 12345.f) atomicAdd(a + q, v[q]);")],
    # kernel 4: the cluster's flush (the reads of distributed shared memory and the global atomics)
    "k4_flush": [("      for (int k = s0 + threadIdx.x * VW; k < s1; k += kThreads * VW) {",
                  "      for (int k = s0 + threadIdx.x * VW; k < s1 * 0; k += kThreads * VW) {")],
    # kernel 4: the zeroing of each block's accumulator
    "k4_zeroing": [("    for (int k = threadIdx.x; k < used * plan.copies; k += kThreads) acc_s[k] = 0.f;",
                    "    for (int k = threadIdx.x; k < used * 0; k += kThreads) acc_s[k] = 0.f;")],
}
COARSE_FORWARD_CUTS = ("k3_stores",)
# variant -> replacements: kernel 3 at other block sizes (the same output)
COARSE_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    f"k3_block_{t}": [("constexpr int kCoarseForwardThreads = 256;", f"constexpr int kCoarseForwardThreads = {t};")]
    for t in (64, 128)}
# plan variant -> kernel 4's plan (he.coarse_grad_plan) made otherwise: the
# uncut build on other grids and cluster sizes (the same function, summed in
# another order)
PLAN_VARIANTS: Dict[str, Callable[[he.CoarseGradPlan], he.CoarseGradPlan]] = {
    **{f"k4_cluster_{c}": (lambda p, c=c: p._replace(cluster=min(c, p.grid))) for c in (1, 2, 4)},
    # one accumulator a block (shared atomics) where the plan gives one a warp
    "k4_one_copy": lambda p: p._replace(copies=1, shared_bytes=p.shared_bytes // p.copies),
    "k4_half_grid": lambda p: p._replace(grid=max(p.cluster, p.grid // 2 // p.cluster * p.cluster)),
    "k4_grid_x1.25": lambda p: p._replace(grid=-(-p.grid * 5 // (4 * p.cluster)) * p.cluster),
    "k4_double_grid": lambda p: p._replace(grid=2 * p.grid),
}
# the source file (ops.build.SOURCES) each cut or variant edits
SOURCE_OF = {**{c: "fused_mlp" for c in [*CUTS, *VARIANTS]},
             **{c: "hash_encode" for c in [*COARSE_CUTS, *COARSE_VARIANTS, *PLAN_VARIANTS]}}


# every name's replacements (a plan variant's source is the uncut one)
_REPLACEMENTS = {**CUTS, **VARIANTS, **COARSE_CUTS, **COARSE_VARIANTS, **{v: [] for v in PLAN_VARIANTS}}


def replace_once(source: str, replacements: Sequence[Tuple[str, str]], where: str) -> str:
    """``source`` with each (old, new) of ``replacements`` made; raises
    ValueError when an old text does not match exactly once."""
    for old, new in replacements:
        if source.count(old) != 1:
            raise ValueError(f"{old[:50]!r} matches {source.count(old)} times in {where}")
        source = source.replace(old, new)
    return source


def cut_source(source: str, cut: str) -> str:
    """``source`` with the replacements of ``cut`` (a cut or a variant);
    raises ValueError when one of them no longer matches exactly once."""
    return replace_once(source, _REPLACEMENTS[cut], f"{SOURCE_OF[cut]}.cu (cut {cut!r})")


def _build(cuts: Sequence[str]) -> Dict[str, Path]:
    """Compile a copy of each cut's source with the cut made."""
    return compile_copies({cut: (SOURCE_OF[cut], cut_source(build.SOURCES[SOURCE_OF[cut]].read_text(), cut))
                           for cut in cuts})


def compile_copies(copies: Dict[str, Tuple[str, str]]) -> Dict[str, Path]:
    """Compile each named copy, (source name, text), into a library under
    the build directory, all at once (one per distinct text)."""
    work = build.BUILD_DIR / "ablate"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the cut copies")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs, built = {}, {}, {}
    for cut, (name, text) in copies.items():
        if text in built:
            libs[cut] = built[text]
            continue
        src = work / f"{name}_{cut}.cu"
        src.write_text(text)
        libs[cut] = built[text] = work / f"lib{name}_{cut}.so"
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


def _coarse_shapes(dev: torch.device):
    """(name, encoder, table, x, g) of each coarse-level shape: the
    multi-frame HashMLP's levels 0-3 at one 352 x 352 frame, x uniform and in
    raster order, and the kernel bench's geometry at its largest batch."""
    gen = torch.Generator().manual_seed(0)
    multi = HashGridEncoding(dim=2, n_levels=10, n_features_per_level=2, log2_hashmap_size=17, base_resolution=16,
                             finest_resolution=None, per_level_scale=1.4)
    xs = torch.linspace(0, 1, 352)
    raster = torch.stack(torch.meshgrid(xs, xs, indexing="ij"), dim=-1).reshape(-1, 2)
    out = []
    for name, enc, x in (("multi_frame levels 0-3", multi, torch.rand((352 * 352, 2), generator=gen)),
                         ("multi_frame levels 0-3 raster", multi, raster),
                         ("bench", bench_geometry(), torch.rand((65536, 3), generator=gen))):
        cols = len(he.coarse_onehot_levels(enc)) * enc.n_features_per_level
        table = (torch.rand((enc.total_size, enc.n_features_per_level), generator=gen) * 2 - 1).to(dev)
        g = torch.randn((x.shape[0], cols), generator=gen).to(dev)
        out.append((name, enc, table, x.to(dev), g))
    return out


def _calls(dev: torch.device):
    """(source, shape name, pass, rows, call) of every timed call."""
    out = []
    for name, ws, bs, x, g, acts, which in _stacks(dev):
        if which == "forward":
            call = lambda ws=ws, bs=bs, x=x, acts=acts: fm.mlp_forward(ws, bs, x, acts)  # noqa: E731
        else:
            call = lambda ws=ws, bs=bs, x=x, g=g, acts=acts: fm.mlp_backward(ws, bs, x, g, acts, False)  # noqa: E731
        out.append(("fused_mlp", name, which, x.shape[0], call))
    return out + coarse_calls(dev)


def coarse_calls(dev: torch.device):
    """(source, shape name, pass, rows, call) of the coarse pair's timed
    calls: kernel 3, then kernel 4, on each of ``_coarse_shapes``."""
    out = []
    for name, enc, table, x, g in _coarse_shapes(dev):
        out.append(("hash_encode", name, "forward", x.shape[0],
                    lambda enc=enc, table=table, x=x: he.hash_encode_coarse_forward(enc, table, x)))
        out.append(("hash_encode", name, "backward", x.shape[0],
                    lambda enc=enc, x=x, g=g: he.hash_encode_coarse_table_grad(enc, x, g)))
    return out


# the kernels of each source whose device time a record holds
_KERNEL_NAMES = {"fused_mlp": r"fused_mlp_\w+", "hash_encode": r"hash_encode_coarse_\w+"}


def device_us(fn, iters: int, pattern: str) -> Dict[str, float]:
    """Device microseconds per call of ``fn`` by kernel whose name matches
    ``pattern`` (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times: Dict[str, float] = {}
    for evt in prof.key_averages():
        found = re.findall(pattern, evt.key)
        if found and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            times[found[0]] = times.get(found[0], 0.0) + evt.self_device_time_total / iters
    return times


_UNCUT = ("none", "coarse_none")
_FORWARD = (*FORWARD_CUTS, *VARIANTS, *COARSE_FORWARD_CUTS, *COARSE_VARIANTS)
_SAME_OUTPUT = (*VARIANTS, *COARSE_VARIANTS, *PLAN_VARIANTS)  # variants: their difference from the uncut output


def run(cuts: Optional[Sequence[str]] = None, iters: int = 10) -> List[dict]:
    """Build every cut and variant copy, then time each on each shape of its
    source and pass; one record per (cut or variant, shape). Needs a card."""
    dev = resolve_device("cuda")
    if cuts is None:
        cuts = ["none", "coarse_none",
                *(c for c in [*CUTS, *VARIANTS, *COARSE_CUTS, *COARSE_VARIANTS, *PLAN_VARIANTS] if c not in _UNCUT)]
    cuts = list(cuts)
    libs = _build(cuts)
    calls = _calls(dev)
    original = {name: build._loaded.get(name) for name in _KERNEL_NAMES}
    card_plan = he._card_coarse_grad_plan
    records, uncut = [], {}
    try:
        for cut in cuts:
            source = SOURCE_OF[cut]
            build._loaded[source] = ctypes.CDLL(str(libs[cut]))
            he._card_coarse_grad_plan = card_plan
            if cut in PLAN_VARIANTS:
                he._card_coarse_grad_plan = lambda *a, cut=cut: PLAN_VARIANTS[cut](card_plan(*a))
            for i, (src, name, which, rows, call) in enumerate(calls):
                if src != source or (cut not in _UNCUT and (which == "forward") != (cut in _FORWARD)):
                    continue  # a cut is timed on its source's shapes, in the pass it cuts
                record = time_record(cut, src, name, which, rows, call, iters)
                if cut in _UNCUT:
                    uncut[i] = call()
                elif cut in _SAME_OUTPUT:
                    record["max_abs_diff"] = float((call() - uncut[i]).abs().max()) if i in uncut else None
                records.append(record)
                print_record(record)
    finally:
        he._card_coarse_grad_plan = card_plan
        for name, lib in original.items():
            if lib is None:
                build._loaded.pop(name, None)
            else:
                build._loaded[name] = lib
    return records


def time_record(cut: str, source: str, name: str, which: str, rows: int, call, iters: int) -> dict:
    """The record of ``call`` (a wrapper of ``source``'s kernels) timed with
    the build of ``cut`` loaded: device µs per call by kernel."""
    return {"cut": cut, "source": source, "shape": name, "pass": which, "rows": rows,
            "device_us": device_us(call, iters, _KERNEL_NAMES[source]),
            "device": torch.cuda.get_device_name()}


def print_record(record: dict) -> None:
    print(f"{record['cut']:15s} {record['pass']:8s} {record['shape']:30s} "
          + "  ".join(f"{k} {v:.2f} us" for k, v in sorted(record["device_us"].items()))
          + (f"  max abs diff from uncut {record['max_abs_diff']}" if "max_abs_diff" in record else ""),
          flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the records as JSON here")
    parser.add_argument("--cuts", nargs="+", default=None, help="time only these cuts and variants")
    args = parser.parse_args(argv)
    records = run(args.cuts)
    if args.out:
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
