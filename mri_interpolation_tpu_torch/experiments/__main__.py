"""The experiment matrix's CLI (port of ``scripts/experiments.py:1415-1497``,
``main``):

    python -m mri_interpolation_tpu_torch.experiments              # 2-D+t matrix + protocol + traces
    python -m mri_interpolation_tpu_torch.experiments --full4d     # full-4D fits + 4-D protocol
    python -m mri_interpolation_tpu_torch.experiments --aux        # two-phase, undersampling rows
    python -m mri_interpolation_tpu_torch.experiments --ceiling    # F8 quality-ceiling probe
    python -m mri_interpolation_tpu_torch.experiments --roofline   # batch scaling against the card's floors
    python -m mri_interpolation_tpu_torch.experiments --stacked    # LOO-stacked fusion row (slow)
    python -m mri_interpolation_tpu_torch.experiments --oracle     # fusion oracles from the caches (no fit)
    python -m mri_interpolation_tpu_torch.experiments --render-only

Each subcommand merges its section into ``<out_dir>/results.json`` and
re-renders ``<out_dir>/RESULTS.md`` from it. The fits run on the card unless
``--device cpu`` is given; ``--render-only`` and ``--oracle`` touch no device.
``out["device"]`` names the device of the measured rows (nvidia-smi's name
and power limit of the card) and is kept when the file already has one.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import common
from .aux import run_aux
from .ceiling import run_ceiling
from .full4d import run_full4d
from .matrix import run_2dt
from .render import write_results_md
from .roofline import run_roofline
from .stacked import run_oracle, run_stacked, run_stacked4d

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments")
    ap.add_argument("--fast", action="store_true", help="fewer epochs (smoke)")
    ap.add_argument("--full4d", action="store_true", help="full-4D fits + 4D protocol")
    ap.add_argument("--aux", action="store_true", help="two-phase + undersampling rows")
    ap.add_argument("--ceiling", action="store_true", help="F8 quality-ceiling probe")
    ap.add_argument("--stacked", action="store_true", help="LOO-stacked fusion protocol row (expensive)")
    ap.add_argument("--stacked4d", action="store_true", help="4D LOO-stacked fusion row (expensive)")
    ap.add_argument("--classical_only", action="store_true",
                    help="with --stacked4d: drop the warp families (the classical subset)")
    ap.add_argument("--anneal", action="store_true",
                    help="with --stacked/--stacked4d: level-anneal the warp families' canonical encoder "
                         "(fresh cache dir)")
    ap.add_argument("--ens_seeds", type=int, default=0,
                    help="with --stacked: warp ensemble width (N seeds, fresh cache dir, stored under stacked_sN)")
    ap.add_argument("--robust", default="off", choices=["off", "median_nested"],
                    help="shrink the fused estimate toward the per-voxel family median, weight selected by "
                         "nested LOO")
    ap.add_argument("--spatial", default="off", choices=["off", "nested"],
                    help="per-voxel spatial weighting for the stacked rows; 'off' is the committed rows' protocol")
    ap.add_argument("--z4d", action="store_true",
                    help="with --stacked: merge the through-plane families (the 4D protocol's motion families "
                         "sliced at z=3, served from the 4D cache)")
    ap.add_argument("--roofline", action="store_true",
                    help="measured batch-scaling throughput against the card's floors (flagship + NGP configs)")
    ap.add_argument("--oracle", action="store_true",
                    help="fusion-oracle ceilings from the committed family caches (seconds; no fits)")
    ap.add_argument("--render-only", action="store_true", help="re-render RESULTS.md")
    ap.add_argument("--image_path", default=common.SAMPLE,
                    help=f"the NIfTI volume (default: {common.SAMPLE}, the sample ankle volume)")
    ap.add_argument("--out_dir", default=common.OUT_DIR, help="where results.json, RESULTS.md and traces go")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    k = 0.2 if args.fast else 1.0
    out = common.load_results(args.out_dir)
    if args.render_only:
        path = write_results_md(out, args.out_dir)
        print(f"re-rendered {path} from results.json")
        return out
    if args.oracle:  # cache reads only: no device, and the device tag is left as it is
        run_oracle(out, image_path=args.image_path)
        common.save_results(out, args.out_dir)
        write_results_md(out, args.out_dir)
        print(f"wrote {args.out_dir}/RESULTS.md and results.json", flush=True)
        return out
    if "device" not in out:
        out["device"] = common.describe_device(args.device)
    where = dict(image_path=args.image_path, device=args.device)
    if args.full4d:
        run_full4d(out, k, out_dir=args.out_dir, **where)
    elif args.aux:
        run_aux(out, k, **where)
    elif args.ceiling:
        run_ceiling(out, k, **where)
    elif args.roofline:
        run_roofline(out, k, **where)
    elif args.stacked:
        run_stacked(out, k, anneal=args.anneal, ens_seeds=args.ens_seeds, spatial=args.spatial, robust=args.robust,
                    z4d=args.z4d, **where)
    elif args.stacked4d:
        run_stacked4d(out, k, classical_only=args.classical_only, anneal=args.anneal, spatial=args.spatial,
                      robust=args.robust, **where)
    else:
        run_2dt(out, k, out_dir=args.out_dir, **where)
    common.save_results(out, args.out_dir)
    write_results_md(out, args.out_dir)
    print(f"wrote {args.out_dir}/RESULTS.md and results.json", flush=True)
    return out


if __name__ == "__main__":
    main()
