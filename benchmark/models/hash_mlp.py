"""The port's HashMLP for a ``"model": "hash_mlp"`` config, through its factory."""

from __future__ import annotations

from typing import Dict


def build(config: Dict, device):
    from mri_interpolation_tpu_torch.models import make_hash_mlp

    enc, dec = config["encoder"], config["decoder"]
    return make_hash_mlp(
        int(enc["dim"]), n_levels=int(enc["n_levels"]), n_features_per_level=int(enc["n_features_per_level"]),
        log2_hashmap_size=int(enc["log2_hashmap_size"]), base_resolution=tuple(enc["base_resolution"]),
        finest_resolution=tuple(enc["finest_resolution"]), growth=enc["growth"], dim_hidden=int(dec["dim_hidden"]),
        n_layers=int(dec["n_layers"]), dim_out=int(dec["dim_out"]), decoder=dec["kind"],
        activation=dec.get("activation", "gelu"), device=device)
