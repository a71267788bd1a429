"""Offline analysis of the LOO-stacked fusion weights, driven by a prediction
cache (port of ``scripts/stacking_analysis.py``).

The stacked protocol's weight-selection signal, LOO folds over interior kept
frames, lives in a WIDER-gap regime than deployment: holding out even frame k
leaves a 4-original-step gap bridged at its midpoint, while deployment bridges
2-step gaps. Family error magnitudes (and with few folds, the lstsq-optimal
combination) do not transfer perfectly between the regimes.

This module selects the solver's regularization honestly, by nested LOO over
the folds themselves (hold out each fold, solve weights on the rest, score the
held fold; no odd-frame ground truth anywhere in selection):

  * ridge strength lam on the simplex-constrained lstsq Gram (lam -> inf
    degenerates to weights proportional to per-family fold correlation),
  * shrink between the global solve and per-position solves.

    python -m mri_interpolation_tpu_torch.experiments.stacking_analysis [--cache_dir D] [--gated | --uncertainty]
        [--lams 0,0.1 --shrinks 0,1] [--image_path P] [--out_dir D] [--device cpu]

It prints the nested-score table, the nested-selected configuration, and
(only as the final diagnostic) each configuration's deployment score against
the odd frames. The solvers and the selection are numpy, as in the JAX
script; the SSIM of the selected row is computed on the device (``cuda``
unless ``--device cpu``). ``--uncertainty`` draws its panel to
``<out_dir>/figures/uncertainty_panel.png``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from ..device import DeviceLike, resolve_device
from ..io import even_frame_split, png
from ..metrics import evaluate_reconstruction
from . import common

__all__ = ["simplex_lstsq_ridge", "affine_lstsq_ridge", "load_folds", "solve_weights", "nested_score",
           "motion_feature", "gated_solve", "gated_fuse", "run_gated", "run_uncertainty", "write_panel", "main"]


def simplex_lstsq_ridge(preds: np.ndarray, target: np.ndarray, lam: float,
                        iters: int = 500, lr: float = 0.5) -> np.ndarray:
    """simplex_lstsq with a ridge on the Gram: (G + lam*tr(G)/F I) w = b.
    lam=0 is the production solver; large lam shrinks toward the simplex
    projection of the per-family correlation vector b (robust to the Gram's
    ill-conditioning when the families are highly correlated and folds few)."""
    F = preds.shape[0]
    G = preds @ preds.T / preds.shape[1]
    b = preds @ target / preds.shape[1]
    G = G + lam * (np.trace(G) / F) * np.eye(F)
    w = np.full((F,), 1.0 / F)
    scale = max(np.trace(G) / F, 1e-12)
    for _ in range(iters):
        grad = (G @ w - b) / scale
        w = w - lr * grad
        u = np.sort(w)[::-1]
        css = np.cumsum(u) - 1.0
        rho = np.nonzero(u - css / (np.arange(F) + 1) > 0)[0][-1]
        w = np.maximum(w - css[rho] / (rho + 1.0), 0.0)
    return w


def affine_lstsq_ridge(preds: np.ndarray, target: np.ndarray, lam: float) -> np.ndarray:
    """Sum-to-one but SIGNED weights (affine combination): closed-form
    equality-constrained ridge. Signed weights can cancel correlated family
    errors — and can also overfit 6 folds; nested selection adjudicates."""
    F = preds.shape[0]
    G = preds @ preds.T / preds.shape[1]
    b = preds @ target / preds.shape[1]
    G = G + lam * (np.trace(G) / F) * np.eye(F)
    Gi = np.linalg.inv(G)
    one = np.ones(F)
    w = Gi @ b
    mu = (1.0 - one @ w) / (one @ Gi @ one)
    return w + mu * (Gi @ one)


def load_folds(cache_dir: str, img: np.ndarray):
    """(names, folds, deploy, t_odd): folds = [(t_held, preds (F,S), target (S))]."""
    train_img, _ = even_frame_split(img)
    t_full = img.shape[-1]
    n = train_img.shape[-1]
    t_keep = np.asarray([2 * j / (t_full - 1) for j in range(n)])
    t_odd = np.asarray([(2 * j + 1) / (t_full - 1) for j in range((t_full) // 2)])
    from ..train.stacking import cached_family_names, has_cached_prediction, load_cached_prediction

    # shared cache layer (reads both the legacy .npy and the fp16 .npz
    # layouts; filters crash leftovers)
    names = cached_family_names(cache_dir)
    if not names:
        raise SystemExit(f"no deploy predictions under {cache_dir!r} — pass "
                         "--cache_dir (e.g. runs/stacked_cache_ep100_anneal)")
    folds = []
    for k in range(1, n - 1):
        if not all(has_cached_prediction(cache_dir, f"fold{k}_{f}")
                   for f in names):
            continue
        preds = np.stack([load_cached_prediction(cache_dir, f"fold{k}_{f}")
                          for f in names])
        folds.append((t_keep[k], preds, train_img[..., k]))
    deploy = np.stack([load_cached_prediction(cache_dir, f"deploy_{f}")
                       for f in names])
    return names, folds, deploy, t_odd


def solve_weights(folds, names, t_new, lam: float, shrink: float,
                  solver=simplex_lstsq_ridge, clip: bool = True):
    """Global + per-position ridge solve -> (len(t_new), F) weights."""
    F = len(names)
    all_p = np.concatenate([p.reshape(F, -1) for _, p, _ in folds], axis=1)
    all_t = np.concatenate([t.reshape(-1) for _, _, t in folds])
    w_global = solver(all_p, all_t, lam)
    pos = np.asarray([t for t, _, _ in folds])
    w_pos = np.stack([
        shrink * w_global + (1.0 - shrink)
        * solver(p.reshape(F, -1), t.reshape(-1), lam)
        for _, p, t in folds
    ])
    w_new = np.stack([np.interp(t_new, pos, w_pos[:, f]) for f in range(F)], axis=-1)
    if clip:
        w_new = np.maximum(w_new, 0.0)
    w_new /= w_new.sum(axis=-1, keepdims=True)
    return w_new, w_global


def nested_score(folds, names, lam: float, shrink: float,
                 solver=simplex_lstsq_ridge, clip: bool = True) -> float:
    """Hold out each fold; solve on the rest; MSE on the held fold."""
    errs = []
    for j in range(len(folds)):
        rest = folds[:j] + folds[j + 1:]
        t_held, preds, target = folds[j]
        w, _ = solve_weights(rest, names, np.asarray([t_held]), lam, shrink,
                             solver=solver, clip=clip)
        fused = np.einsum("f...,f->...", preds, w[0])
        errs.append(float(np.mean((fused - target) ** 2)))
    return float(np.mean(errs))


def _box_blur(img: np.ndarray, rad: int) -> np.ndarray:
    """Separable box blur over the spatial axes (pure numpy, edge-clamped)."""
    out = img.astype(np.float32)
    for ax in range(img.ndim):
        if img.shape[ax] < 2 * rad + 1:
            continue
        pad = [(0, 0)] * img.ndim
        pad[ax] = (rad, rad)
        p = np.pad(out, pad, mode="edge")
        c = np.cumsum(p, axis=ax)
        lead = [slice(None)] * img.ndim
        lag = [slice(None)] * img.ndim
        lead[ax] = slice(2 * rad + 1, None)
        lag[ax] = slice(None, -(2 * rad + 1))
        first = [slice(None)] * img.ndim
        first[ax] = slice(2 * rad, 2 * rad + 1)
        head = c[tuple(first)]
        out = np.concatenate([head, c[tuple(lead)] - c[tuple(lag)]], axis=ax) / (2 * rad + 1)
    return out


def motion_feature(frame_lo: np.ndarray, frame_hi: np.ndarray, rad: int = 4) -> np.ndarray:
    """Target-free local motion magnitude between the two BRACKETING kept
    frames (available identically at fold positions and at deployment)."""
    return _box_blur(np.abs(frame_hi - frame_lo), rad)


def gated_solve(folds_feats, names, n_bins: int, lam: float):
    """Per-motion-bin global simplex weights. ``folds_feats``: list of
    (preds (F, S), target (S), feat (S)). Returns (thresholds, (B, F) weights):
    thresholds are pooled-fold quantiles, so deployment bins the same way."""
    F = len(names)
    all_feat = np.concatenate([f.reshape(-1) for _, _, f in folds_feats])
    qs = np.quantile(all_feat, [i / n_bins for i in range(1, n_bins)])
    W = np.zeros((n_bins, F))
    for b in range(n_bins):
        masks = []
        for _, _, feat in folds_feats:
            m = np.digitize(feat.reshape(-1), qs) == b
            masks.append(m)
        p = np.concatenate([pr.reshape(F, -1)[:, m]
                            for (pr, _, _), m in zip(folds_feats, masks)], axis=1)
        t = np.concatenate([tg.reshape(-1)[m]
                            for (_, tg, _), m in zip(folds_feats, masks)])
        W[b] = simplex_lstsq_ridge(p, t, lam) if t.size else 1.0 / F
    return qs, W


def gated_fuse(preds: np.ndarray, feat: np.ndarray, qs: np.ndarray,
               W: np.ndarray) -> np.ndarray:
    bins = np.digitize(feat.reshape(-1), qs)
    w_px = W[bins]                                  # (N, F)
    return np.einsum("fn,nf->n", preds.reshape(preds.shape[0], -1),
                     w_px).reshape(preds.shape[1:])


def run_gated(img, names, folds, deploy, t_odd, odd_img, device: DeviceLike = None):
    """Motion-gated stacking prototype: nested-LOO selection over
    (n_bins, lam), then the deployment diagnostic (the selected row's SSIM
    on ``device``)."""
    train_img, _ = even_frame_split(img)
    t_full = img.shape[-1]
    n = train_img.shape[-1]
    t_keep = np.asarray([2 * j / (t_full - 1) for j in range(n)])
    # fold features: bracketing KEPT frames around held position k are k-1, k+1
    pos_to_idx = {t_keep[k]: k for k in range(n)}
    folds_feats = []
    for t_held, preds, target in folds:
        k = pos_to_idx[t_held]
        feat = motion_feature(train_img[..., k - 1], train_img[..., k + 1])
        folds_feats.append((preds, target, feat))
    # deployment features: odd position 2j+1 sits between kept frames j, j+1
    # (clamped for even-length series, whose final odd frame has no right
    # neighbor — its feature degrades to zero motion)
    T = train_img.shape[-1]
    dep_feats = np.stack([
        motion_feature(train_img[..., min(j, T - 1)],
                       train_img[..., min(j + 1, T - 1)])
        for j in range(len(t_odd))
    ], axis=-1)

    rows = []
    for n_bins in (1, 2, 3, 5):
        for lam in (0.0, 0.1, 0.3, 1.0):
            errs = []
            for j in range(len(folds_feats)):
                rest = folds_feats[:j] + folds_feats[j + 1:]
                qs, W = gated_solve(rest, names, n_bins, lam)
                preds, target, feat = folds_feats[j]
                fused = gated_fuse(preds, feat, qs, W)
                errs.append(float(np.mean((fused - target) ** 2)))
            rows.append({"bins": n_bins, "lam": lam,
                         "nested_mse": float(np.mean(errs))})
            print(json.dumps(rows[-1]), flush=True)
    rows.sort(key=lambda r: r["nested_mse"])
    best = rows[0]
    print("gated nested-selected:", json.dumps(best), flush=True)

    print("\n# gated deployment scores (diagnostic)", flush=True)
    for r in rows:
        qs, W = gated_solve(folds_feats, names, r["bins"], r["lam"])
        fused = np.stack([
            gated_fuse(deploy[:, ..., i], dep_feats[..., i], qs, W)
            for i in range(deploy.shape[-1])
        ], axis=-1)
        mse = float(np.mean((fused - odd_img) ** 2))
        rec = {"bins": r["bins"], "lam": r["lam"],
               "odd_psnr": round(-10.0 * np.log10(mse), 3)}
        if r is best:
            q = evaluate_reconstruction(fused, odd_img, data_range=1.0, device=device)
            rec["odd_ssim"] = round(q.get("ssim", float("nan")), 4)
            rec["selected"] = True
            rec["bin_weights"] = {f"bin{b}": {n: round(float(x), 3)
                                              for n, x in zip(names, W[b])}
                                  for b in range(W.shape[0])}
        print(json.dumps(rec), flush=True)


def write_panel(path: str, fused: np.ndarray, sigma: np.ndarray, abs_err: np.ndarray, t_mid: int) -> str:
    """The three tiles of the uncertainty panel side by side as one RGB PNG
    (``io/png.py``; no matplotlib): the fused frame in gray, sigma and
    |error| in ``magma``, each min-max over its own tile, transposed with
    row 0 at the bottom (``imshow(panel.T, origin="lower")``), 4 pixels of
    white between the tiles. The titles and each tile's value range go into
    ``tEXt`` chunks."""
    panels = [(fused, f"fused held-out frame {t_mid}", png.GRAY),
              (sigma, "confidence map sigma (no ground truth)", png.MAGMA),
              (abs_err, "|true error|", png.MAGMA)]
    tiles = [png.colorize(np.asarray(a).T[::-1], table) for a, _, table in panels]
    gap = np.full((tiles[0].shape[0], 4, 3), 255, np.uint8)
    image = np.concatenate([tiles[0], gap, tiles[1], gap, tiles[2]], axis=1)
    text = {"Title": "uncertainty panel"}
    for i, (a, title, _) in enumerate(panels):
        text[f"panel {i}"] = f"{title} (range {float(np.min(a)):.6g} .. {float(np.max(a)):.6g})"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return png.write_png(path, image, text)


def run_uncertainty(names, folds, deploy, t_odd, odd_img,
                    out_png=os.path.join(common.OUT_DIR, "figures", "uncertainty_panel.png")):
    """Calibration of the fusion's confidence map against the true held-out
    error, for the shipped solver's weights and for the ablation variants
    (pure-weighted eps=0, uniform). Renders a panel artifact: fused frame,
    sigma map, |error| map side by side for the middle odd frame."""
    from ..train.stacking import fusion_uncertainty, uncertainty_calibration

    w_new, w_global = solve_weights(folds, names, t_odd, lam=0.0, shrink=0.5)
    fused = np.einsum("f...t,tf->...t", deploy, w_new)
    err = fused - odd_img
    report = {}
    for label, sigma in [
        ("shipped (eps=0.1)", fusion_uncertainty(deploy, w_new)),
        ("pure-weighted (eps=0)", fusion_uncertainty(deploy, w_new, eps=0.0)),
        ("uniform", fusion_uncertainty(
            deploy, np.full_like(w_new, 1.0 / len(names)))),
    ]:
        cal = uncertainty_calibration(sigma, err)
        rc = cal["risk_coverage"]["rmse"]
        report[label] = {"pearson_r": round(cal["pearson_r"], 3),
                         "spearman_rho": round(cal["spearman_rho"], 3),
                         "rmse_keep50_over_full": round(rc[4] / rc[-1], 4)}
        print(json.dumps({label: report[label]}), flush=True)

    sigma = fusion_uncertainty(deploy, w_new)
    t_mid = fused.shape[-1] // 2
    write_panel(out_png, fused[..., t_mid], sigma[..., t_mid], np.abs(err[..., t_mid]), t_mid)
    print(json.dumps({"panel": out_png}))
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments.stacking_analysis")
    ap.add_argument("--cache_dir", default="runs/stacked_cache_ep100_anneal")
    ap.add_argument("--lams", default="0,0.1,0.3,1,3,10")
    ap.add_argument("--shrinks", default="0,0.25,0.5,0.75,1")
    ap.add_argument("--gated", action="store_true",
                    help="motion-gated per-bin weights instead of the "
                         "(lam, shrink) sweep")
    ap.add_argument("--uncertainty", action="store_true",
                    help="calibrate the confidence map variants against the "
                         "true held-out error + render the panel artifact")
    ap.add_argument("--image_path", default=common.SAMPLE)
    ap.add_argument("--out_dir", default=common.OUT_DIR, help="where --uncertainty writes figures/")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu: the selected row's SSIM")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = common.load_volume(args.image_path, slice_axes=common.SLICE)
    img = ds.image()
    _, odd_img = even_frame_split(img)
    names, folds, deploy, t_odd = load_folds(args.cache_dir, img)
    print(f"families: {names}; folds with complete predictions: {len(folds)}")

    if args.gated:
        run_gated(img, names, folds, deploy, t_odd, odd_img, device=dev)
        return
    if args.uncertainty:
        run_uncertainty(names, folds, deploy, t_odd, odd_img,
                        out_png=os.path.join(args.out_dir, "figures", "uncertainty_panel.png"))
        return

    lams = [float(x) for x in args.lams.split(",")]
    shrinks = [float(x) for x in args.shrinks.split(",")]
    solvers = {"simplex": (simplex_lstsq_ridge, True),
               "affine": (affine_lstsq_ridge, False)}
    rows = []
    for solver_name, (solver, clip) in solvers.items():
        for lam in lams:
            for shrink in shrinks:
                ns = nested_score(folds, names, lam, shrink, solver, clip)
                rows.append({"solver": solver_name, "lam": lam,
                             "shrink": shrink, "nested_mse": ns})
                print(json.dumps(rows[-1]), flush=True)
    rows.sort(key=lambda r: r["nested_mse"])
    best = rows[0]
    print("nested-selected:", json.dumps(best))

    # deployment scores (diagnostic; selection above never saw these).
    # PSNR via plain numpy — cheap enough to sweep; full metrics (SSIM) only
    # for the nested-selected configuration.
    print("\n# deployment scores (diagnostic)")
    for r in rows:
        solver, clip = solvers[r["solver"]]
        w_new, w_global = solve_weights(folds, names, t_odd, r["lam"], r["shrink"],
                                        solver=solver, clip=clip)
        fused = np.einsum("f...t,tf->...t", deploy, w_new)
        mse = float(np.mean((fused - odd_img) ** 2))
        rec = {"solver": r["solver"], "lam": r["lam"], "shrink": r["shrink"],
               "odd_psnr": round(-10.0 * np.log10(mse), 3),
               "weights": {n: round(float(x), 3)
                           for n, x in zip(names, w_global)}}
        if r is best:
            q = evaluate_reconstruction(fused, odd_img, data_range=1.0, device=dev)
            rec["odd_ssim"] = round(q.get("ssim", float("nan")), 4)
            rec["selected"] = True
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
