"""Capacity planner (port of ``mri_interpolation_tpu/plan.py``): where will a
HashMLP run's memory go on one NVIDIA H100, and which scaling path does it
need? Nothing is allocated and no device is touched: every number comes
from the encoder geometry that ``HashGridEncoding`` derives statically.

Feed it the launcher's flags and it prints per-level table sizes, the
training step's residency, the sharding layout ``plan_table_sharding`` would
choose (``--n_devices`` > 1), and a recommendation per constraint:

    python -m mri_interpolation_tpu_torch.plan --dim_in 4 --n_levels 5 \\
        --n_features_per_level 4 --growth paper --decoder relu_plain \\
        --base_resolution 64,64,2,3 --finest_resolution 352,352,6,15 \\
        --volume_shape 352,352,6,15 --batch_size 50000 --optimizer adam_tcnn \\
        --roofline --measured_steps_per_sec 300

The byte and FLOP counts are the JAX package's, unchanged: ``table``,
``decoder_params`` and ``optimizer_state`` are the model's parameters and
Adam's two moment buffers exactly, ``dataset`` the device-resident (coords,
values) of ``Trainer.fit``; activations and gradients are estimates, and the
caching allocator adds its own slack on top.

What differs from the JAX package, by name:

- ``CHIPS`` holds the H100 SXM5's spec-sheet peaks (``"h100_sxm"``, the
  default ``chip``) in place of the TPU's;
- the compute floor ``floor_s["mxu_f32"]`` is ``floor_s["fp32_cores"]``
  (the flops over the fp32 rate of the CUDA cores), and ``binding`` reads
  ``"fp32_cores"`` where it read ``"mxu"``;
- the HBM budget defaults to 80 GB (``hbm_bytes``, ``--hbm_gb``), the card's;
- ``scatter_pricing["layout"]`` names the port's own table-gradient route
  for the batch (``ops/hash_encode.py:table_grad_plan``: the levels summed
  in shared memory, the levels summed with global atomics, the corner
  split), and every packed scatter is priced at the narrow per-element
  rate, since that route has no wide-row layout.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Union

import numpy as np

from .encodings.hashgrid import HashGridEncoding

__all__ = ["CHIPS", "plan_run", "step_roofline", "main"]

# NVIDIA H100 SXM5 data sheet peaks (dense, without sparsity): HBM3
# 3.35 TB/s, fp32 67 TFLOP/s on the CUDA cores, TF32 494.7 and bf16 989.4
# TFLOP/s on the tensor cores. The floors divide by the fp32 rate (the
# training step runs in fp32).
CHIPS = {
    "h100_sxm": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12, "tf32_flops": 494.7e12,
                 "bf16_flops": 989.4e12},
}


def _encoding(dim_in, n_levels, n_features_per_level, log2_hashmap_size, base_resolution, finest_resolution,
              per_level_scale, growth, storage) -> HashGridEncoding:
    return HashGridEncoding(dim=dim_in, n_levels=n_levels, n_features_per_level=n_features_per_level,
                            log2_hashmap_size=log2_hashmap_size, base_resolution=base_resolution,
                            finest_resolution=finest_resolution, per_level_scale=per_level_scale, growth=growth,
                            storage=storage)


def _decoder_param_count(enc_out: int, dim_hidden: int, n_layers: int, dim_out: int, decoder: str) -> int:
    widths = [enc_out] + [dim_hidden] * (n_layers - 1) + [dim_out]
    n = sum((widths[i] + 1) * widths[i + 1] for i in range(n_layers))
    if decoder == "norm":
        n += 2 * sum(widths[1:])            # scale+bias on every block
    elif decoder == "norm_proper":
        n += 2 * sum(widths[1:-1])          # hidden blocks only
    return n


def plan_run(
    dim_in: int,
    n_levels: int = 4,
    n_features_per_level: int = 1,
    log2_hashmap_size: int = 23,
    base_resolution: Union[int, Sequence[int]] = (64, 64, 5),
    finest_resolution: Union[int, Sequence[int], None] = (352, 352, 15),
    per_level_scale: Optional[float] = None,
    growth: str = "reference",
    storage: str = "auto",
    dim_hidden: int = 64,
    n_layers: int = 2,
    dim_out: int = 1,
    decoder: str = "norm",
    batch_size: int = 10000,
    volume_shape: Optional[Sequence[int]] = None,
    row_fraction: float = 1.0,   # fraction of voxels kept (--undersample_pct)
    n_devices: int = 1,
    optimizer: str = "adam",
    remat: bool = False,
    hbm_bytes: float = 80e9,
) -> dict:
    """Estimate the memory layout of a HashMLP run and pick scaling paths.

    Returns a dict with ``levels`` (per-level rows/bytes/storage),
    ``bytes`` (table, decoder, optimizer, dataset, activations, step totals),
    ``sharding`` (per-device table bytes under ``plan_table_sharding`` when
    ``n_devices > 1``), ``serving`` (artifact sizes), and
    ``recommendations`` (constraint -> launcher flag)."""
    enc = _encoding(dim_in, n_levels, n_features_per_level, log2_hashmap_size, base_resolution, finest_resolution,
                    per_level_scale, growth, storage)
    F = n_features_per_level
    levels = []
    for l in range(n_levels):
        rows = int(enc.level_sizes[l])
        levels.append({
            "level": l,
            "resolution": [int(r) for r in enc.level_resolutions[l]],
            "storage": "dense" if bool(enc.level_dense[l]) else "hashed",
            "rows": rows,
            "bytes": rows * F * 4,
        })
    table_bytes = enc.total_size * F * 4
    dec_params = _decoder_param_count(enc.output_dim, dim_hidden, n_layers, dim_out, decoder)
    params_bytes = table_bytes + dec_params * 4
    opt_mult = 2 if optimizer.startswith("adam") else 0
    opt_bytes = opt_mult * params_bytes
    grad_bytes = params_bytes                 # transient, but peak-relevant

    # Per-step activations (forward residency the backward keeps alive), the
    # JAX package's estimate: per (voxel, level, corner) int32 ids + F f32
    # features + interp weights; decoder: every hidden width once. remat
    # drops the decoder/encoder intermediates to ~the largest single layer.
    corners = 2 ** dim_in
    enc_act = batch_size * n_levels * corners * (4 + F * 4 + 4)
    widths = [enc.output_dim] + [dim_hidden] * (n_layers - 1) + [dim_out]
    dec_act = batch_size * sum(widths) * 4
    act_bytes = (max(enc_act, dec_act) if remat else enc_act + dec_act)

    dataset_bytes = None
    if volume_shape is not None:
        n_vox = int(np.prod(volume_shape) * row_fraction)
        # device-resident (coords f32 dim_in, values f32): Trainer.fit's layout
        dataset_bytes = n_vox * (len(volume_shape) + 1) * 4

    step_bytes = params_bytes + opt_bytes + grad_bytes + act_bytes
    total_bytes = step_bytes + (dataset_bytes or 0)

    sharding = None
    if n_devices > 1:
        from .parallel.sharded_table import plan_table_sharding

        plan = plan_table_sharding(enc, n_devices)
        per_dev_rows = [int(sum(ln for (_, _, ln) in slot)) for slot in plan.slots]
        sharding = {
            "n_devices": n_devices,
            "per_device_table_bytes": [r * F * 4 for r in per_dev_rows],
            "max_device_table_bytes": max(per_dev_rows) * F * 4,
            "split_levels": sorted({l for slot in plan.slots for (l, s, ln) in slot
                                    if ln > 0 and ln < int(enc.level_sizes[l])}),
        }

    serving = {
        # the serving artifact: tables at f32 vs bf16, decoder always f32
        "artifact_f32_bytes": params_bytes,
        "artifact_bf16_table_bytes": enc.total_size * F * 2 + dec_params * 4,
    }

    recommendations = []
    if total_bytes > hbm_bytes and dataset_bytes and dataset_bytes > 0.25 * hbm_bytes:
        shard = int(batch_size * max(4, n_devices))
        recommendations.append({
            "constraint": f"dataset residency {dataset_bytes/1e9:.2f} GB",
            "path": f"--stream_shard_voxels {shard} (out-of-core shard rotation; "
                    "io.nifti.load_memmap if host RAM is also short)"})
    table_budget = hbm_bytes - act_bytes - (dataset_bytes or 0)
    if (1 + opt_mult + 1) * params_bytes > table_budget:
        recommendations.append({
            "constraint": f"table+optimizer {((1+opt_mult+1)*params_bytes)/1e9:.2f} GB",
            "path": "--shard_tables (dense levels row-range-split; "
                    "see 'sharding' for the per-device bytes)"})
    if act_bytes > 0.25 * hbm_bytes and not remat:
        recommendations.append({
            "constraint": f"activations {act_bytes/1e9:.2f} GB/step",
            "path": "--remat (recompute forward in backward) or smaller --batch_size"})
    if not recommendations:
        recommendations.append({"constraint": "none",
                                "path": "fits a single chip as configured"})

    return {
        "levels": levels,
        "bytes": {
            "table": table_bytes,
            "decoder_params": dec_params * 4,
            "optimizer_state": opt_bytes,
            "gradients": grad_bytes,
            "activations_per_step": act_bytes,
            "dataset": dataset_bytes,
            "step_total": step_bytes,
            "total": total_bytes,
            "hbm_budget": hbm_bytes,
        },
        "sharding": sharding,
        "serving": serving,
        "recommendations": recommendations,
    }


def step_roofline(
    dim_in: int,
    n_levels: int = 4,
    n_features_per_level: int = 1,
    log2_hashmap_size: int = 23,
    base_resolution: Union[int, Sequence[int]] = (64, 64, 5),
    finest_resolution: Union[int, Sequence[int], None] = (352, 352, 15),
    per_level_scale: Optional[float] = None,
    growth: str = "reference",
    storage: str = "auto",
    dim_hidden: int = 64,
    n_layers: int = 2,
    dim_out: int = 1,
    decoder: str = "norm",
    batch_size: int = 10000,
    optimizer: str = "adam",
    chip: str = "h100_sxm",
    measured_steps_per_sec: Optional[float] = None,
    measured_gather_ns: Optional[float] = None,
    measured_scatter: Optional[dict] = None,
) -> dict:
    """Roofline model of ONE optimizer step of the HashMLP trainer.

    Counts the HBM bytes moved and the FLOPs issued per training step from
    the same static encoder metadata ``plan_run`` uses, divides by the
    card's peaks (``CHIPS``), and reports the two time floors: the step can
    be no faster than max(bytes/BW, flops/peak). With
    ``measured_steps_per_sec``, also the achieved fraction of the binding
    floor and the time the floors leave unexplained.

    Byte accounting (f32 training throughout):
      encode fwd: 2^d corner gathers per (voxel, level) of F features +
        the batch coordinates once;
      encode bwd: scatter-add of the same feature bytes (read+write);
      decoder: weight reads fwd + 2x bwd, activation write fwd / read bwd;
      optimizer: dense Adam over every parameter, 3 reads (p, m, v) +
        3 writes.

    FLOP accounting: decoder matmuls fwd + 2x bwd (dL/dx and dL/dW);
    multilinear interpolation weight products; ~10 FLOPs/param for Adam.

    ``measured_gather_ns`` (a random gather's cost) adds a transaction
    floor; ``measured_scatter`` (``{"narrow_ns": ..., "wide_below_ns":
    ...}``) prices the backward's scatters with it (``scatter_pricing``).
    """
    enc = _encoding(dim_in, n_levels, n_features_per_level, log2_hashmap_size, base_resolution, finest_resolution,
                    per_level_scale, growth, storage)
    F = n_features_per_level
    B = batch_size
    d = dim_in
    corners = 2 ** d
    table_rows = int(enc.total_size)
    dec_params = _decoder_param_count(enc.output_dim, dim_hidden, n_layers, dim_out, decoder)
    n_params = table_rows * F + dec_params

    # ---- bytes -----------------------------------------------------------
    gather_bytes = B * n_levels * corners * F * 4          # fwd feature reads
    scatter_bytes = 2 * gather_bytes                       # bwd read+write
    coord_bytes = B * (d + 1) * 4                          # batch (x, y)
    widths = [enc.output_dim] + [dim_hidden] * (n_layers - 1) + [dim_out]
    act_bytes = 2 * B * sum(widths) * 4                    # write fwd + read bwd
    weight_bytes = 3 * dec_params * 4                      # fwd + 2 bwd passes
    opt_mult = 6 if optimizer.startswith("adam") else 2    # r/w p (+ m, v)
    opt_bytes = opt_mult * n_params * 4
    bytes_total = (gather_bytes + scatter_bytes + coord_bytes + act_bytes
                   + weight_bytes + opt_bytes)

    # ---- flops -----------------------------------------------------------
    mm = sum(widths[i] * widths[i + 1] for i in range(n_layers))
    dec_flops = 3 * 2 * B * mm                             # fwd + 2 bwd matmuls
    interp_flops = 2 * B * n_levels * corners * (d + 2 * F)
    opt_flops = 10 * n_params
    flops_total = dec_flops + interp_flops + opt_flops

    peaks = CHIPS[chip]
    t_bw = bytes_total / peaks["hbm_bytes_per_s"]
    t_fp32 = flops_total / peaks["f32_flops"]
    t_floor = max(t_bw, t_fp32)

    # Random accesses per step: per (voxel, level) the cell-view levels do
    # one row-gather, the packed levels 2^d element-gathers; the backward
    # scatter-adds into the same locations.
    n_cv = int(np.sum(enc.level_cellview))
    n_packed = n_levels - n_cv
    fwd_accesses = B * (n_cv + n_packed * corners)
    packed_ids = B * n_packed * corners
    random_accesses = 2 * fwd_accesses

    out = {
        "chip": chip,
        "bytes_per_step": {
            "encode_gather": gather_bytes,
            "encode_scatter": scatter_bytes,
            "decoder_weights": weight_bytes,
            "activations": act_bytes,
            "optimizer": opt_bytes,
            "coords": coord_bytes,
            "total": bytes_total,
        },
        "flops_per_step": {
            "decoder": dec_flops,
            "interp": interp_flops,
            "optimizer": opt_flops,
            "total": flops_total,
        },
        "random_accesses_per_step": random_accesses,
        "floor_s": {
            "hbm": t_bw,
            "fp32_cores": t_fp32,
            "binding": "hbm" if t_bw >= t_fp32 else "fp32_cores",
            "predicted_step_s": t_floor,
            "predicted_steps_per_sec": 1.0 / t_floor,
        },
    }
    if measured_gather_ns is not None:
        seq_bytes = bytes_total - gather_bytes - scatter_bytes
        if measured_scatter is not None:
            from .ops.hash_encode import table_grad_plan

            s = measured_scatter
            narrow = float(s["narrow_ns"])
            # kernel 2 adds every (id, feature) with its own atomic (in shared
            # memory on its private levels, in global memory on the others)
            t_packed = packed_ids * F * narrow * 1e-9
            route = table_grad_plan(enc, B)
            cv_ns = float(s.get("wide_below_ns", narrow)) if F * corners > 1 else narrow
            t_cv_bwd = B * n_cv * cv_ns * 1e-9
            cv_view_bytes = 2 * sum(
                int(np.prod(enc.level_resolutions[l])) * corners * F * 4
                for l in range(n_levels) if enc.level_cellview[l])
            t_tx = (fwd_accesses * measured_gather_ns * 1e-9
                    + t_packed + t_cv_bwd
                    + (seq_bytes + cv_view_bytes) / peaks["hbm_bytes_per_s"])
            out["scatter_pricing"] = {
                "layout": {"private_levels": list(route.private_levels), "global_levels": list(route.global_levels),
                           "corner_split": route.corner_split},
                "packed_ids": packed_ids,
                "packed_scatter_s": t_packed,
                "cellview_bwd_s": t_cv_bwd,
                "narrow_ns": narrow,
            }
        else:
            t_tx = (random_accesses * measured_gather_ns * 1e-9
                    + seq_bytes / peaks["hbm_bytes_per_s"])
        t_tx = max(t_tx, t_fp32)
        out["floor_s"]["transaction"] = t_tx
        out["floor_s"]["measured_gather_ns"] = measured_gather_ns
    if measured_steps_per_sec:
        t_meas = 1.0 / measured_steps_per_sec
        out["measured"] = {
            "steps_per_sec": measured_steps_per_sec,
            "step_s": t_meas,
            "fraction_of_roofline": t_floor / t_meas,
            # what the floors leave out: host dispatch and launch latency,
            # the allocator, kernels below their bounds
            "overhead_s": t_meas - t_floor,
        }
        if measured_gather_ns is not None:
            out["measured"]["fraction_of_transaction_roofline"] = (
                out["floor_s"]["transaction"] / t_meas)
    return out


def _tuple_arg(s: str):
    s = s.strip()
    if not s:
        return None
    parts = [p for p in s.replace("(", "").replace(")", "").split(",") if p.strip()]
    vals = tuple(int(p) for p in parts)
    return vals[0] if len(vals) == 1 else vals


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """CLI: the plan (and with ``--roofline`` the step roofline) as JSON on
    standard output; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim_in", type=int, default=3)
    ap.add_argument("--n_levels", type=int, default=4)
    ap.add_argument("--n_features_per_level", type=int, default=1)
    ap.add_argument("--log2_hashmap_size", type=int, default=23)
    ap.add_argument("--base_resolution", type=_tuple_arg, default=(64, 64, 5))
    ap.add_argument("--finest_resolution", type=_tuple_arg, default=(352, 352, 15))
    ap.add_argument("--per_level_scale", type=float, default=None)
    ap.add_argument("--growth", default="reference")
    ap.add_argument("--storage", default="auto")
    ap.add_argument("--dim_hidden", type=int, default=64)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--dim_out", type=int, default=1)
    ap.add_argument("--decoder", default="norm")
    ap.add_argument("--batch_size", type=int, default=10000)
    ap.add_argument("--volume_shape", type=_tuple_arg, default=None)
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--hbm_gb", type=float, default=80.0, help="per-card HBM budget (H100: 80)")
    ap.add_argument("--roofline", action="store_true",
                    help="also print the per-step roofline model (bytes, FLOPs, time floors vs the card's peaks)")
    ap.add_argument("--measured_steps_per_sec", type=float, default=None,
                    help="with --roofline: the predicted step time beside this measured rate")
    ap.add_argument("--measured_gather_ns", type=float, default=None,
                    help="with --roofline: a random gather's cost in ns; enables the transaction floor")
    ap.add_argument("--measured_scatter_json", default=None,
                    help='with --measured_gather_ns: scatter pricing as JSON, e.g. \'{"narrow_ns": 2.0}\'')
    args = ap.parse_args(argv)
    kw = vars(args).copy()
    kw["hbm_bytes"] = kw.pop("hbm_gb") * 1e9
    roofline = kw.pop("roofline")
    measured = kw.pop("measured_steps_per_sec")
    gather_ns = kw.pop("measured_gather_ns")
    scatter_json = kw.pop("measured_scatter_json")
    out = plan_run(**kw)
    if roofline or measured:
        rl_kw = {k: kw[k] for k in (
            "dim_in", "n_levels", "n_features_per_level", "log2_hashmap_size",
            "base_resolution", "finest_resolution", "per_level_scale",
            "growth", "storage", "dim_hidden", "n_layers", "dim_out",
            "decoder", "batch_size", "optimizer")}
        out["roofline"] = step_roofline(measured_steps_per_sec=measured, measured_gather_ns=gather_ns,
                                        measured_scatter=json.loads(scatter_json) if scatter_json else None, **rl_kw)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
