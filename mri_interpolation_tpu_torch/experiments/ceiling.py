"""``--ceiling``: the NGP F8 quality-ceiling probe at two long budgets (port
of ``scripts/experiments.py:754-766``, ``run_ceiling``)."""

from __future__ import annotations

import json

from ..device import DeviceLike, resolve_device
from ..models import make_hash_mlp
from ..train import TrainConfig
from . import common

__all__ = ["run_ceiling"]


def run_ceiling(out: dict, k: float, image_path: str = common.SAMPLE, device: DeviceLike = None) -> None:
    dev = resolve_device(device)
    ds01 = common.load_volume(image_path, slice_axes=common.SLICE)
    probe = {}
    for epochs in (int(100 * k) or 2, int(300 * k) or 3):
        model = make_hash_mlp(dim_in=3, n_levels=3, n_features_per_level=8, log2_hashmap_size=23,
                              base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15),
                              growth="paper", dim_hidden=64, n_layers=2, decoder="relu_plain", device=dev)
        cfg = TrainConfig(batch_size=10000, epochs=epochs, lr=1e-2, optimizer="adam_tcnn",
                          lr_schedule="cosine", cosine_t_max=epochs)
        row = common.fit_and_eval(f"NGP F8 ceiling {epochs}ep", model, cfg, ds01, device=dev)
        probe[f"psnr_{epochs}ep"] = row["psnr"]
    out["f8_ceiling"] = probe
    print(json.dumps({"f8_ceiling": probe}), flush=True)
