"""The results document as a pure function of the results dict (port of
``scripts/experiments.py:912-1406``, ``write_results_md``).

Every table is rendered as the JAX script renders it, and sections whose data
is absent are left out. The header names the device from ``out["device"]``
and the roofline's prose takes its peaks from ``out["roofline"]["chip_peaks"]``;
the JAX script's prose lines that state facts of its TPU as measured truth
(its header, the scatter-wall note, the roofline's peaks and reading, the
traces' note) state here only what the dict holds.
"""

from __future__ import annotations

import os

from . import common

__all__ = ["render_results_md", "write_results_md"]


def render_results_md(out: dict) -> str:
    """The results document of ``out`` (a ``results.json``-shaped dict)."""
    rows = out.get("rows", [])
    protocol = out.get("protocol", [])
    lines = [
        f"# RESULTS — measured quality & throughput ({out.get('device', 'device not recorded')})",
        "",
        f"Workload: (352,352,15) (x,y,t) slice of `sample_ankle_dyn_mri.nii.gz` "
        f"(the reference's canonical 2D+t experiment). Full-volume reconstruction "
        f"quality after training; throughput is steady-state (compile excluded).",
        "",
        "| model | params | epochs | steps/s | voxel-evals/s | PSNR (dB) | SSIM |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['params']:,} | {r['epochs']} | {r['steady_steps_per_sec']} "
            f"| {int(r['voxel_evals_per_sec']):,} | {r['psnr']} | {r['ssim']} |"
        )
    if protocol:
        lines += [
            "",
            "## Temporal interpolation protocol (train even frames, evaluate odd)",
            "",
            "| method | held-out odd-frame PSNR | SSIM |",
            "|---|---|---|",
        ]
        for p in protocol:
            lines.append(f"| {p['name']} | {p['odd_psnr']} | {p['odd_ssim']} |")
        st = out.get("stacked")
        if st:
            lines.append(f"| {st['row']['name']} | {st['row']['odd_psnr']} "
                         f"| {st['row']['odd_ssim']} |")
            for skey in sorted(k for k in out
                               if k.startswith("stacked_s") or k == "stacked_z4d"):
                srow = out[skey]["row"]
                lines.append(f"| {srow['name']} | {srow['odd_psnr']} "
                             f"| {srow['odd_ssim']} |")
            w = ", ".join(f"{n} {v:.2f}" for n, v in st["weights"].items())
            lines += [
                "",
                "The stacked row fuses the families per held-out position with",
                "simplex weights selected by leave-one-even-frame-out validation",
                "(`train/stacking.py` — no odd-frame ground truth enters weight",
                f"selection). Global LOO weights: {w}.",
            ]
            sp = st.get("spatial")
            if sp is not None:
                pick = ("kept a per-voxel weight field "
                        f"(sigma {sp['sigma']:g}, temp {sp['temp']:g}, shrink "
                        f"{sp['spatial_shrink']:g})" if sp["sigma"] > 0 else
                        "rejected the per-voxel weight field (temporal-only "
                        "weights won)")
                lines += [
                    "",
                    "Per-voxel spatial weighting (`spatial=\"nested\"`): the",
                    f"nested leave-one-fold-out selection {pick}.",
                ]
            rb = st.get("robust")
            if rb is not None:
                pick_r = (f"kept lam = {rb['lam']:g}" if rb["lam"] > 0 else
                          "rejected the blend (lam = 0; the solved weights "
                          "won)")
                lines += [
                    "",
                    "Median-shrink robust fusion (`robust=\"median_nested\"`):",
                    f"the nested selection {pick_r}.",
                ]
            z = out.get("stacked_z4d")
            if z:
                wz = ", ".join(f"{n} {v:.2f}" for n, v in z["weights"].items()
                               if v > 0.004)
                spz = z.get("spatial") or {}
                lines += [
                    "",
                    "**Through-plane (z4d) stack — the headline row.** The",
                    "occlusion analysis below concluded that through-plane",
                    "content change is invisible from a single 2D slice BY",
                    "CONSTRUCTION; the z4d families feed exactly that missing",
                    "information into the stack: the 4D protocol's motion",
                    "families (trained on the even frames of ALL z-slices,",
                    "reusing the committed 4D fits) deployed at the z=3 slice",
                    "(`stacking.slice4d_families`; even-frame-only, so LOO",
                    "honesty holds end to end). The default roster is 9",
                    "families (round-5 subset search — see CHANGES.md):",
                    f"non-zero weights: {wz}. This run is also the first where",
                    "the nested selection KEPT a per-voxel spatial field",
                    f"(sigma {spz.get('sigma', 0):g}, temp",
                    f"{spz.get('temp', 0):g}, shrink",
                    f"{spz.get('spatial_shrink', 0):g}) — through-plane",
                    "competence is spatially localized, exactly where a",
                    "per-voxel schedule can help.",
                    "",
                    "**2D+t quality-axis closure (round 5).** Gains by round:",
                    "26.23 (r2) -> 26.28 (r3) -> 26.29 (r4) -> the z4d stack's",
                    f"{z['row']['odd_psnr']} (r5). The through-plane context was",
                    "the last decorrelated information source this protocol",
                    "admits; the two z4d transfer refinements (residual drift,",
                    "residual+cubic) measured at ZERO LOO weight (negative",
                    "result, entries pruned), and the remaining gap to the",
                    "per-time oracle is weight-schedule estimation error that",
                    "no honest schedule can close further (three rounds of",
                    "teacher/blend variants bought +0.02 dB total). The axis is",
                    "CLOSED: further gains require a different information",
                    "source (more z slices, complementary pulse sequences),",
                    "not better fusion or better teachers.",
                ]
            orc = out.get("fusion_oracles", {}).get("2dt")
            if orc:
                best_row = max(
                    [st] + ([z] if z else []),
                    key=lambda e: e["row"]["odd_psnr"])["row"]["odd_psnr"]
                gap = round(orc["per_time_simplex"] - best_row, 2)
                lines += [
                    "",
                    "**Fusion ceiling (oracle analysis).** Cheating upper bounds",
                    "for linear fusion of the SAME family predictions, fit on the",
                    "held-out odd frames themselves (`stacking.fusion_oracles`):",
                    f"global simplex {orc['global_simplex']} dB, per-time simplex",
                    f"{orc['per_time_simplex']} dB, per-time unconstrained",
                    f"{orc['per_time_unconstrained']} dB, per-voxel best-family",
                    f"{orc['per_voxel_best_family']} dB. The honest stacked row",
                    f"sits within ~{gap} dB of the per-time oracle:",
                    "weight-schedule fusion of this family set is SATURATED, and",
                    "the per-voxel oracle's headroom is not honestly estimable",
                    "(the nested-LOO spatial field above is the honest attempt).",
                    "Further held-out gains require better base families, not",
                    "better fusion.",
                ]
            pf = st.get("per_family")
            if pf:
                lines += [
                    "",
                    "Individual family deployments (same fits the fusion uses):",
                    "",
                    "| family | held-out odd-frame PSNR | SSIM |",
                    "|---|---|---|",
                ]
                for name, s in sorted(pf.items(), key=lambda kv: -kv[1]["odd_psnr"]):
                    lines.append(f"| {name} | {s['odd_psnr']} | {s['odd_ssim']} |")
            unc = st.get("uncertainty")
            if unc:
                cal = unc["calibration"]
                rc = cal["risk_coverage"]
                full_rmse = rc["rmse"][-1]
                half_rmse = rc["rmse"][len(rc["rmse"]) // 2 - 1]
                lines += [
                    "",
                    "**Confidence maps.** The fusion's per-voxel family-disagreement",
                    "sigma (`stacking.fusion_uncertainty` — computed WITHOUT ground",
                    "truth) tracks the true held-out error: Pearson r ="
                    f" {cal['pearson_r']:.3f}, Spearman rho = {cal['spearman_rho']:.3f}.",
                    f"Risk-coverage: keeping the lowest-sigma 50% of voxels cuts RMSE",
                    f"from {full_rmse:.4f} to {half_rmse:.4f}. Deployment surface:",
                    "`stacked_temporal_upsample(..., return_uncertainty=True)` /",
                    "`python -m mri_interpolation_tpu_torch.train.stacking --uncertainty_out`.",
                ]

    def _row(frag):
        for r in rows:
            if frag in r["name"]:
                return r
        return None

    lines += [
        "",
        "Notes:",
        "",
        "- **The NGP-class rows.** They keep every level at full resolution and",
        "  DENSE (collision-free direct indexing within the 2^23 budget, paper",
        "  growth, relu_plain decoder, tcnn Adam + cosine), where the literal tcnn",
        "  row hashes 11 of its 16 levels (11 x 8 corners x batch scatter-ids a",
        "  step).",
    ]
    tcnn, f2, f4 = _row("tcnn config"), _row("NGP: 3L F2"), _row("NGP: 3L F4")
    if tcnn and f2 and f4:
        lines.append(
            f"  Measured: the F4 variant runs at {f4['steady_steps_per_sec']} steps/s and the F2 variant\n"
            f"  {f2['psnr']} dB at {f2['steady_steps_per_sec']} steps/s — "
            f"{f4['steady_steps_per_sec'] / tcnn['steady_steps_per_sec']:.1f}-"
            f"{f2['steady_steps_per_sec'] / tcnn['steady_steps_per_sec']:.1f}x the literal\n"
            f"  tcnn row ({tcnn['steady_steps_per_sec']} steps/s at {tcnn['psnr']} dB)."
        )
    ceiling = out.get("f8_ceiling")
    if ceiling:
        items = sorted(ceiling.items(), key=lambda kv: int(kv[0].split("_")[1][:-2]))
        desc = ", ".join(f"{v} dB at {k.split('_')[1]}" for k, v in items)
        lines.append(
            f"  F8 quality-ceiling probe (`--ceiling`): {desc} — the long budgets\n"
            f"  measure within noise of each other: capacity-limited, not\n"
            f"  optimization-limited."
        )
    lines += [
        "- **Full model-zoo coverage**: every reference family has a measured",
        "  row. psf_siren's step rate reflects the 125x PSF coordinate expansion",
        "  (a 4096-voxel batch is 512K network evaluations per step); the",
        "  multi-frame models step on whole 124K-voxel frames",
        "  (MriFramesDataModule semantics). hash_siren is the reference's dead",
        "  code made to run; its modulation architecture is simply weak on this",
        "  workload.",
    ]
    norm, proper, plain = _row("dense, F=4"), _row("decoder=norm_proper"), _row("decoder=relu_plain")
    if norm and proper and plain:
        lines.append(
            "- **Decoder ablation** (the three 'dense F=4' rows, equal budget): the\n"
            "  reference's 'norm' decoder BatchNorms + GELUs the OUTPUT block too\n"
            f"  (reference models.py:712-739) and it costs ~{proper['psnr'] - norm['psnr']:.1f} dB — "
            f"{norm['psnr']} dB vs {proper['psnr']}\n"
            f"  for norm_proper (hidden blocks only) and {plain['psnr']} for the tcnn-style plain\n"
            "  ReLU decoder. The quirk is reproduced for parity; norm_proper is the\n"
            "  recommended variant when norm layers are wanted."
        )
    two_phase = out.get("aux", {}).get("two_phase")
    if two_phase:
        lines += [
            "- **Two-phase hash training** (the reference's legacy protocol,",
            "  hash_experimentation.py:330-384, `train.protocols.two_phase_hash_fit`):",
            f"  pretraining the flagship on key frames {{3,7,13}} reaches",
            f"  {two_phase['phase1_psnr']} dB full-volume; phase 2 (decoder FROZEN, only hash",
            f"  tables train on the full data) completes it to {two_phase['phase2_psnr']} dB /",
            f"  {two_phase['phase2_ssim']} SSIM — the decoder generalizes across frames, the",
            "  tables carry the content.",
        ]
    if protocol:
        lines += [
            "- **Temporal interpolation**: direct INRs and classical linear",
            "  interpolation are both temporal smoothers — their held-out errors are",
            "  highly correlated (a 50/50 blend gains nothing, measured) and they",
            "  saturate together. The motion-compensated `warp_inr` decomposes the",
            "  sequence into canonical anatomy + a temporally smooth deformation field",
            "  and reconstructs held-out frames by MOTION interpolation, beating the",
            "  classical baseline on both metrics.",
        ]

    warp_sweep = out.get("warp_sweep")
    if warp_sweep:
        lines += [
            "",
            "## Warp-INR sweep (held-out even-frame protocol)",
            "",
            "Sweep of the motion-compensated model's levers (`experiments.warp_sweep`;",
            "target was >= +2.5 dB over linear). The temporal-ACCELERATION prior on",
            "the deformation (favoring near-linear motion between trained frames) is",
            "the best single lever; seeds decorrelate, so a 4-seed ensemble adds",
            "another ~+0.2 dB. Capacity increases (F8 canonical, wider warp) and",
            "longer schedules HURT held-out quality — the protocol punishes",
            "trained-frame memorization. Seed-to-seed noise is ~±0.1 dB (see the",
            "noise-floor row).",
            "",
            "| config | epochs | held-out odd PSNR | SSIM | trained-frame PSNR |",
            "|---|---|---|---|---|",
        ]
        for w in warp_sweep:
            fp = w.get("full_psnr")
            lines.append(f"| {w['name']} | {w['epochs']} | {w['odd_psnr']} | {w['odd_ssim']} "
                         f"| {fp if fp is not None else '—'} |")
        rs = out.get("warp_sweep_random")
        if rs:
            b = rs["best"]
            bp = b["params"]
            lines += [
                "",
                "**Random-search harness on the same objective** "
                "(`python -m mri_interpolation_tpu_torch.train.sweep --model_class",
                "warp_inr --objective odd_frames --ens_seeds 4`, committed log",
                f"`{rs['log']}`): {rs['n_trials']} deterministic trials over",
                "(lr, warp_accel, level_anneal_steps, residual_scale); the",
                f"best trial scores **{b['score']:.2f} dB** held-out",
                f"(lr {bp['lr']:.4f}, accel {bp['warp_accel']:.2f}, anneal",
                f"{bp['level_anneal_steps']}, residual",
                f"{bp['residual_scale']:.3f}) — beating the hand-tuned warp",
                f"row ({rs['hand_tuned_reference_psnr']} dB): the harness",
                "tunes the number the framework competes on, not a proxy.",
            ]

    undersample = out.get("aux", {}).get("undersample")
    if undersample:
        lines += [
            "",
            "## Sparse-acquisition protocol (random undersampling)",
            "",
            "Fit from a random subset of voxels (`create_rn_mask`, parity:",
            "reference utils.py:91-104), reconstruct the FULL grid. Zero-filled =",
            "kept voxels as-is, missing at background.",
            "",
            "| model | kept % | PSNR (dB) | SSIM | zero-filled PSNR |",
            "|---|---|---|---|---|",
        ]
        for u in undersample:
            lines.append(f"| {u['name']} | {u['kept_pct']:.0f} | {u['psnr']} | {u['ssim']} "
                         f"| {u['zero_filled_psnr']} |")

    full4d = out.get("full4d")
    if full4d and full4d.get("fits"):
        lines += [
            "",
            "## Full 4D volume (x, y, z, t)",
            "",
            "Launcher CLI end-to-end on the complete (352,352,6,15) volume (11.2M",
            "voxels, hash resolutions auto-derived from the volume shape, batch",
            f"{full4d['batch']}; measured by `python -m mri_interpolation_tpu_torch.experiments --full4d`):",
            "",
            "| recipe | PSNR (dB) | SSIM | steps/s | wall (s) |",
            "|---|---|---|---|---|",
        ]
        for f in full4d["fits"]:
            lines.append(f"| {f['name']} | {f['psnr']} | {f['ssim']} "
                         f"| {f['steady_steps_per_sec']} | {f['wall_s']} |")
        lines += [
            "",
            "The 30-epoch recipe also writes the 2x temporal super-resolution grid",
            "(`interpolation(352, 352, 6, 30).nii.gz`, rank-adapted) in the same run. CLI:",
            "",
            "```",
            "python -m mri_interpolation_tpu_torch.launcher \\",
            "    --image_path sample_ankle_dyn_mri.nii.gz \\",
            "    --model_class hash_mlp --epochs 30 --batch_size 50000 \\",
            "    --n_levels 5 --n_features_per_level 4 --growth paper --decoder relu_plain \\",
            "    --optimizer adam_tcnn --lr 1e-2 --lr_schedule cosine --cosine_t_max 30",
            "```",
            "",
            f"4D even-frame protocol (train data[..., ::2], evaluate held-out odd",
            f"frames; {full4d['epochs']} epochs, batch {full4d['batch']}):",
            "",
            "| method | held-out odd-frame PSNR | SSIM |",
            "|---|---|---|",
        ]
        for p in full4d["protocol"]:
            lines.append(f"| {p['name']} | {p['odd_psnr']} | {p['odd_ssim']} |")
        for st4_key in ("stacked", "stacked_classical"):
            st4 = full4d.get(st4_key)
            if not st4:
                continue
            lines.append(f"| {st4['row']['name']} | {st4['row']['odd_psnr']} "
                         f"| {st4['row']['odd_ssim']} |")
            w = ", ".join(f"{n} {v:.2f}" for n, v in st4["weights"].items())
            lines += ["", f"(4D stacked-fusion LOO global weights: {w}.)"]
            sp4 = st4.get("spatial")
            if sp4 is not None and sp4["sigma"] > 0:
                lines += ["", "(Per-voxel spatial weighting: nested-LOO kept a "
                              f"field with sigma {sp4['sigma']:g}, temp "
                              f"{sp4['temp']:g}, shrink {sp4['spatial_shrink']:g}.)"]
            rb4 = st4.get("robust")
            if rb4 is not None:
                lines += ["", "(Median-shrink robust fusion: nested-LOO "
                              + (f"kept lam = {rb4['lam']:g}." if rb4["lam"] > 0
                                 else "rejected the blend, lam = 0.") + ")"]
            orc4 = out.get("fusion_oracles", {}).get("4d")
            if orc4 and st4_key == "stacked":
                lines += ["", "(4D fusion oracles — cheating upper bounds: global "
                              f"simplex {orc4['global_simplex']} dB, per-time simplex "
                              f"{orc4['per_time_simplex']} dB, per-time unconstrained "
                              f"{orc4['per_time_unconstrained']} dB, per-voxel "
                              f"best-family {orc4['per_voxel_best_family']} dB.)"]
            pf4 = st4.get("per_family")
            if pf4:
                lines += [
                    "",
                    "Individual 4D family deployments (same fits the fusion uses):",
                    "",
                    "| family | held-out odd-frame PSNR | SSIM |",
                    "|---|---|---|",
                ]
                for name, s in sorted(pf4.items(), key=lambda kv: -kv[1]["odd_psnr"]):
                    lines.append(f"| {name} | {s['odd_psnr']} | {s['odd_ssim']} |")
            unc4 = st4.get("uncertainty")
            if unc4:
                cal = unc4["calibration"]
                lines += ["", "(4D confidence-map calibration: Pearson r ="
                          f" {cal['pearson_r']:.3f}, Spearman rho ="
                          f" {cal['spearman_rho']:.3f}.)"]

    occ = out.get("occlusion_probe")
    if occ:
        lines += [
            "",
            "## Occlusion-aware transfer: a measured negative result",
            "",
            f"One serious attempt at a new base family (round-3 verdict #2):"
            f" per-voxel side selection between the motion-transfer family's"
            f" two bracketing resamples. The per-voxel best-side ORACLE sits"
            f" at {occ.get('oracle_best_side')} dB"
            f" ({occ.get('oracle_per_voxel_tau')} dB with a continuous"
            f" per-voxel blend) against the transfer baseline's"
            f" {occ.get('transfer_baseline')} dB — but that headroom is"
            " mostly noise mirage (the min of two noisy estimates of the"
            " same value scores better by construction). Every honest,"
            " ground-truth-free selection signal tested lands AT or BELOW"
            " the baseline: fixed-point inversion residual"
            f" {occ.get('pick_by_fp_residual')} dB, seed disagreement"
            f" {occ.get('pick_by_seed_sigma')} dB, warp-INR arbiter"
            f" {occ.get('pick_by_inr_arbiter')} dB, smoothed photometric"
            f" gap-crossing maps {occ.get('photometric_soft')} dB, best soft"
            f" INR-projection blend {occ.get('inr_projection_blend_075')} dB."
            " Conclusion: the aligned resamples differ by noise, not by"
            " detectable occlusion; through-plane content change (the real"
            " failure mode) is invisible from a single 2D slice by"
            " construction. Reproduce: `python -m"
            " mri_interpolation_tpu_torch.experiments.occlusion_probe`.",
        ]

    roofline = out.get("roofline")
    if roofline:
        peaks = roofline.get("chip_peaks", {})
        gns = roofline.get("gather_ns_per_element")
        lines += [
            "",
            "## Roofline: measured step time vs the chip's limits",
            "",
            f"Two floors per config (`plan.step_roofline`). The CLASSIC floor"
            f" divides per-step HBM bytes and FLOPs (table gathers +"
            f" scatter-add, decoder matmuls fwd+bwd, dense-Adam parameter"
            f" traffic) by the {peaks.get('chip')} peaks recorded with the"
            f" points ({peaks.get('hbm_gb_per_s')} GB/s HBM,"
            f" {peaks.get('f32_tflops', peaks.get('mxu_f32_tflops'))} TFLOP/s"
            " f32). The TRANSACTION floor prices every random table access at"
            f" the measured cost of an isolated gather ({gns} ns/element) and"
            " the backward's scatter-adds at the measured narrow-element rate"
            f" ({(roofline.get('scatter_ns') or {}).get('narrow_ns')}"
            " ns/element), plus the sequential bytes at the HBM rate; the"
            " measured wide-row (F = 2) scatter costs"
            f" {(roofline.get('scatter_ns') or {}).get('wide_below_ns')} ->"
            f" {(roofline.get('scatter_ns') or {}).get('wide_above_ns')} ns/id"
            " below -> above the large table. The per-point `scatter` column"
            " names the layout the step's backward is priced at.",
            "",
            "| config | batch | steps/s | voxel-evals/s | HBM floor (us) "
            "| tx floor (us) | measured (us) | % of HBM roofline "
            "| % of tx roofline | scatter |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for cfg_name in ("flagship", "ngp_f2"):
            for pt in roofline.get(cfg_name, []):
                lines.append(
                    f"| {cfg_name} | {pt['batch']:,} "
                    f"| {pt['steady_steps_per_sec']} "
                    f"| {int(pt['voxel_evals_per_sec']):,} "
                    f"| {pt['predicted_step_us']} "
                    f"| {pt['transaction_floor_us']} "
                    f"| {pt['measured_step_us']} "
                    f"| {100*pt['fraction_of_roofline']:.1f}% "
                    f"| {100*pt['fraction_of_transaction_roofline']:.0f}% "
                    f"| {pt.get('scatter_layout', 'n/a')} |")
        reading = []
        for cfg_name in ("flagship", "ngp_f2"):
            pts = roofline.get(cfg_name, [])
            if pts:
                ns = [1e3 * pt["measured_step_us"] / pt["batch"] for pt in pts]
                hbm = [100 * pt["fraction_of_roofline"] for pt in pts]
                tx = [100 * pt["fraction_of_transaction_roofline"] for pt in pts]
                reading.append(
                    f"{cfg_name}: {ns[0]:.1f} -> {ns[-1]:.1f} ns a voxel from batch"
                    f" {pts[0]['batch']:,} to {pts[-1]['batch']:,}, {min(hbm):.1f}-{max(hbm):.1f}%"
                    f" of the HBM roofline, {min(tx):.0f}-{max(tx):.0f}% of the transaction"
                    " roofline")
        if reading:
            lines += ["", "Measured step time a voxel, smallest to largest batch: "
                      + "; ".join(reading) + "."]

    lines += [
        "",
        "Profiler traces (torch.profiler) of a training step of the flagship and the",
        "NGP F8 configs and of the grid evaluation are written to `<out_dir>/traces/`",
        "by the default subcommand (`utils.capture_trace`).",
        "",
        "Reproduce: `python -m mri_interpolation_tpu_torch.experiments && python -m",
        "mri_interpolation_tpu_torch.experiments --full4d && python -m",
        "mri_interpolation_tpu_torch.experiments --aux` (add `--fast` for smoke",
        "runs; `--ceiling` for the long-budget F8 probe; `--stacked` for the",
        "LOO-stacked fusion row; `--render-only` re-renders this file from",
        "results.json).",
    ]
    return "\n".join(lines) + "\n"


def write_results_md(out: dict, out_dir: str = common.OUT_DIR) -> str:
    """Write :func:`render_results_md` of ``out`` to ``out_dir/RESULTS.md``;
    returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, common.RESULTS_MD)
    with open(path, "w") as f:
        f.write(render_results_md(out))
    return path
