"""Where the staging coarse kernels' time went, on the card.

Before kernels 3-4 (the coarse-level encode and its table gradient) were
redesigned, at commit 51de4ca, each of their blocks copied every coarse row
into shared memory and waited on a barrier before it touched a point;
kernel 3 wrote a point's outputs as scalars at a stride of L*F floats, and
kernel 4 added its points' terms with shared atomics and flushed its
accumulator with one global atomic per nonzero entry. ``STAGED_CUTS`` cut
those parts one at a time, and each cut copy is timed on ``ablate``'s
coarse shapes (the multi-frame HashMLP's levels 0-3 at one 352 x 352 frame,
x uniform and in raster order, and the kernel bench's geometry). The cuts
match that version of ``ops/csrc/hash_encode.cu`` only, so this file and
``ablate.py`` are copied into a checkout of it and run there, on a machine
with a card:

    mkdir -p parent_tree && git archive 51de4ca | tar -x -C parent_tree
    cp mri_interpolation_tpu_torch/ablate.py mri_interpolation_tpu_torch/ablate_staged.py \\
        parent_tree/mri_interpolation_tpu_torch/
    cd parent_tree && python -m mri_interpolation_tpu_torch.ablate_staged [--out PATH] [--cuts NAME ...]

``--cuts`` times only the named cuts, in the order given (a name may
repeat). A cut copy computes wrong values: only its times mean anything, as
the time the cut part took (the uncut build's time minus the cut one's).
It prints one line per (cut, shape) and, with ``--out``, writes the records
as JSON. A cut whose text does not match the source raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import ablate
from .device import resolve_device
from .ops import build

__all__ = ["STAGED_CUTS", "STAGED_FORWARD_CUTS", "run", "main"]

# cut -> (old text, new text) replacements on the staging hash_encode.cu
STAGED_CUTS: Dict[str, List[Tuple[str, str]]] = {
    "staged_none": [],
    # kernel 3: every block's copy of the coarse rows into shared memory
    "staged_k3_staging": [
        ("      for (int k = threadIdx.x; k < (int)lv.size * n_features; k += blockDim.x) dst[k] = __ldg(src + k);",
         "      for (int k = threadIdx.x; k < 0; k += blockDim.x) dst[k] = __ldg(src + k);")],
    # kernel 3: the strided scalar stores of the outputs
    "staged_k3_stores": [("          o[f] = acc;", "          if (acc == 12345.f) o[f] = acc;")],
    # kernel 4: the shared atomics of the points' terms
    "staged_k4_atomics": [
        ("            atomicAdd(acc_s + (rows[c] - base) * n_features + f, __fmul_rn(gf, w[c]));",
         "            if (gf == 12345.f) atomicAdd(acc_s + (rows[c] - base) * n_features + f, __fmul_rn(gf, w[c]));")],
    # kernel 4: the flush, one global atomic per block and nonzero entry
    "staged_k4_flush": [("        if (v != 0.f) atomicAdd(dst + k, v);", "        if (v == 12345.f) atomicAdd(dst + k, v);")],
    # kernel 4: the zeroing of each block's accumulator
    "staged_k4_zeroing": [
        ("    const int used = (levels.lv[j1 - 1].offset + (int)levels.lv[j1 - 1].size - base) * n_features;\n"
         "    for (int k = threadIdx.x; k < used; k += blockDim.x) acc_s[k] = 0.f;",
         "    const int used = (levels.lv[j1 - 1].offset + (int)levels.lv[j1 - 1].size - base) * n_features;\n"
         "    for (int k = threadIdx.x; k < used * 0; k += blockDim.x) acc_s[k] = 0.f;")],
}
STAGED_FORWARD_CUTS = ("staged_k3_staging", "staged_k3_stores")


def run(cuts: Optional[Sequence[str]] = None, iters: int = 10) -> List[dict]:
    """Build every cut copy of this checkout's ``hash_encode.cu``, then time
    each on each coarse shape, in the pass it cuts (the uncut build in
    both); one record per (cut, shape). Needs a card."""
    dev = resolve_device("cuda")
    cuts = list(STAGED_CUTS if cuts is None else cuts)
    source = build.SOURCES["hash_encode"].read_text()
    libs = ablate.compile_copies({cut: ("hash_encode", ablate.replace_once(
        source, STAGED_CUTS[cut], f"hash_encode.cu (cut {cut!r})")) for cut in cuts})
    calls = ablate.coarse_calls(dev)
    original = build._loaded.get("hash_encode")
    records = []
    try:
        for cut in cuts:
            build._loaded["hash_encode"] = ctypes.CDLL(str(libs[cut]))
            for src, name, which, rows, call in calls:
                if cut != "staged_none" and (which == "forward") != (cut in STAGED_FORWARD_CUTS):
                    continue
                records.append(ablate.time_record(cut, src, name, which, rows, call, iters))
                ablate.print_record(records[-1])
    finally:
        if original is None:
            build._loaded.pop("hash_encode", None)
        else:
            build._loaded["hash_encode"] = original
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write the records as JSON here")
    parser.add_argument("--cuts", nargs="+", default=None, help="time only these cuts")
    args = parser.parse_args(argv)
    records = run(args.cuts)
    if args.out:
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
