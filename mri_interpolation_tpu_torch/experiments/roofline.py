"""``--roofline``: measured batch-scaling throughput of the HashMLP train
step against the card's floors (port of ``scripts/experiments.py:773-905``:
``_gather_ns_microbench``, ``_scatter_ns_microbench``, ``run_roofline``).

The microbenches time the device's random gather (``table[ids]``) and
scatter-add (``index_add_``) at the JAX script's sizes: they price the card's
memory system for ``plan.step_roofline``'s transaction floor, so library
calls are what they measure. Every point is placed by
``plan.step_roofline(chip="h100_sxm")``, and the peaks recorded beside the
points are ``plan.CHIPS["h100_sxm"]``'s.
"""

from __future__ import annotations

import json
import time

import torch

from ..device import DeviceLike, resolve_device
from ..models import make_hash_mlp
from ..plan import CHIPS, step_roofline
from ..train import TrainConfig, Trainer
from . import common

__all__ = ["ROOFLINE_CONFIGS", "BATCHES", "CHIP", "gather_ns_microbench", "scatter_ns_microbench", "layout_label",
           "run_roofline"]

CHIP = "h100_sxm"
BATCHES = (10_000, 40_000, 160_000, 640_000)
ROOFLINE_CONFIGS = {
    "flagship": dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                     base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                     dim_hidden=64, n_layers=2, decoder="norm", optimizer="adam", lr=5e-3),
    "ngp_f2": dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=23,
                   base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15), growth="paper",
                   dim_hidden=64, n_layers=2, decoder="relu_plain", optimizer="adam_tcnn", lr=1e-2),
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ns_per_id(fn, n_ids: int, dev: torch.device, n: int) -> float:
    """Wall nanoseconds per id of ``fn()`` over ``n`` back-to-back calls
    after a warm-up call, the device synchronised before and after."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n / n_ids * 1e9


def gather_ns_microbench(rows: int = 1 << 23, n_ids: int = 5_120_000, device: DeviceLike = None) -> float:
    """Nanoseconds per 4-byte random gather: ``table[ids]`` of ``n_ids``
    uniform ids from a ``rows``-row float32 table, many ids a call so that
    the launch is amortised."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    table = torch.zeros(rows, device=dev)
    ids = torch.randint(0, rows, (n_ids,), generator=gen).to(dev)
    return _ns_per_id(lambda: table[ids], n_ids, dev, 10)


def scatter_ns_microbench(n_ids: int = 2_621_440, narrow_rows: int = 1 << 23, below_rows: int = 1 << 16,
                          device: DeviceLike = None) -> dict:
    """Nanoseconds per id of a scatter-add (``index_add_`` into a zeroed
    table, the zero fill included as in the JAX script's ``.at[].add``) in
    the regimes that ``plan.step_roofline``'s ``measured_scatter`` reads:
    narrow 4-byte elements into ``narrow_rows`` rows, and 2-wide rows into a
    small (``below_rows``) and a large (``narrow_rows``) table. Unrounded:
    the card's are hundredths of a nanosecond, where the JAX script rounds
    its TPU's to two decimals."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def bench(rows: int, F: int) -> float:
        ids = torch.randint(0, rows, (n_ids,), generator=gen).to(dev)
        vals = torch.ones((n_ids,) if F == 1 else (n_ids, F), device=dev)
        shape = (rows,) if F == 1 else (rows, F)
        return _ns_per_id(lambda: torch.zeros(shape, device=dev).index_add_(0, ids, vals), n_ids, dev, 6)

    return {"narrow_ns": bench(narrow_rows, 1), "wide_below_ns": bench(below_rows, 2),
            "wide_above_ns": bench(narrow_rows, 2)}


def layout_label(layout: dict) -> str:
    """``step_roofline``'s kernel-2 route as one table cell: the levels
    summed in shared memory, those added by global atomics, the corner
    split."""
    def levels(ls):
        return ",".join(str(l) for l in ls) or "none"

    return (f"private {levels(layout['private_levels'])}; global {levels(layout['global_levels'])}; "
            f"split {layout['corner_split']}")


def run_roofline(out: dict, k: float, image_path: str = common.SAMPLE, device: DeviceLike = None) -> None:
    """Fit each config at each batch size (``int(10 * k) or 2`` epochs) and
    place its steady steps/s on the two floors of ``plan.step_roofline``:
    the card's sequential bytes and fp32 operations, and the transaction
    floor priced by the microbenches."""
    dev = resolve_device(device)
    gather_ns = gather_ns_microbench(device=dev)
    scatter = scatter_ns_microbench(device=dev)
    print(json.dumps({"gather_ns_per_element": gather_ns, "scatter": scatter}), flush=True)
    ds01 = common.load_volume(image_path, slice_axes=common.SLICE)
    epochs = int(10 * k) or 2
    res = {"gather_ns_per_element": gather_ns, "scatter_ns": scatter}
    for cfg_name, mc in ROOFLINE_CONFIGS.items():
        mc = dict(mc)
        opt = mc.pop("optimizer")
        lr = mc.pop("lr")
        points = []
        for B in BATCHES:
            model = make_hash_mlp(dim_in=3, **mc, device=dev)
            tc = TrainConfig(batch_size=B, epochs=epochs, lr=lr, seed=1337, optimizer=opt)
            sps = Trainer(tc).fit(model, ds01.coords, ds01.values, device=dev).steady_steps_per_sec
            rl = step_roofline(dim_in=3, batch_size=B, optimizer=opt, chip=CHIP, measured_steps_per_sec=sps,
                               measured_gather_ns=gather_ns, measured_scatter=scatter, **mc)
            pt = {
                "batch": B,
                "steady_steps_per_sec": round(float(sps), 1),
                "voxel_evals_per_sec": round(float(sps * B), 0),
                "bytes_per_step": rl["bytes_per_step"]["total"],
                "random_accesses_per_step": rl["random_accesses_per_step"],
                "binding": rl["floor_s"]["binding"],
                "predicted_step_us": round(rl["floor_s"]["predicted_step_s"] * 1e6, 1),
                "transaction_floor_us": round(rl["floor_s"]["transaction"] * 1e6, 1),
                "measured_step_us": round(1e6 / sps, 1),
                "fraction_of_roofline": round(rl["measured"]["fraction_of_roofline"], 4),
                "fraction_of_transaction_roofline": round(rl["measured"]["fraction_of_transaction_roofline"], 3),
                "scatter_layout": layout_label(rl["scatter_pricing"]["layout"]),
            }
            points.append(pt)
            print(json.dumps({cfg_name: pt}), flush=True)
        res[cfg_name] = points
    peaks = CHIPS[CHIP]
    res["chip_peaks"] = {"chip": CHIP, "hbm_gb_per_s": peaks["hbm_bytes_per_s"] / 1e9,
                         "f32_tflops": peaks["f32_flops"] / 1e12}
    out["roofline"] = res
