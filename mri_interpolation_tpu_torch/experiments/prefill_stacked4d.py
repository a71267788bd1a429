"""Prefill the ``--stacked4d`` cache with the classical families (port of
``scripts/prefill_stacked4d.py``).

The 4-D LOO-stacked run needs 5 families x 7 positions of cached
predictions. The classical families (linear, cubic, the pairwise and group
registrations) fit no network; running them first leaves only the warp
fits for the full run. The cache keys (``fold{k}_{name}`` /
``deploy_{name}``) do not depend on the family set, so the full run reuses
these entries as they are.

    python -m mri_interpolation_tpu_torch.experiments.prefill_stacked4d [--image_path P] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..train import TrainConfig
from ..train.stacking import stacked_interp_eval
from . import common

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.experiments.prefill_stacked4d")
    ap.add_argument("--image_path", default=common.SAMPLE)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    img = common.load_volume(args.image_path).image()
    ep = 60
    cfg = TrainConfig(batch_size=50000, epochs=ep, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine",
                      cosine_t_max=ep, weight_decay=1e-5)
    _, q = stacked_interp_eval(img, cfg, seeds=(1337,),
                               include=("registration", "registration_group", "cubic", "linear"),
                               cache_dir=f"runs/stacked4d_cache_ep{ep}", device=args.device)
    print("classical-only fusion (no warp):", {k: round(v, 3) for k, v in q["odd"].items()}, flush=True)
    return q


if __name__ == "__main__":
    main()
