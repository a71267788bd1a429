"""The port's hash SIREN for a ``"model": "hash_siren"`` config, through its
factory: the hash grid that grows by ``per_level_scale``, the SIREN, and a
modulator as deep and as wide as the SIREN (the factory builds no other)."""

from __future__ import annotations

from typing import Dict


def build(config: Dict, device):
    from mri_interpolation_tpu_torch.models import make_hash_siren

    enc, s, mod = config["encoder"], config["siren"], config["modulator"]
    if (int(mod["n_layers"]), int(mod["dim_hidden"]), mod["activation"]) != (int(s["n_layers"]),
                                                                                int(s["dim_hidden"]), "relu"):
        raise ValueError("make_hash_siren builds one ReLU modulator layer a sine layer, as wide as the SIREN")
    return make_hash_siren(
        int(s["dim_in"]), dim_hidden=int(s["dim_hidden"]), dim_out=int(s["dim_out"]), n_layers=int(s["n_layers"]),
        w0=float(s["w0"]), w0_initial=float(s["w0_initial"]), sigma=float(s["sigma"]),
        lr=float(config["train"]["lr"]), n_levels=int(enc["n_levels"]),
        n_features_per_level=int(enc["n_features_per_level"]), log2_hashmap_size=int(enc["log2_hashmap_size"]),
        base_resolution=int(enc["base_resolution"]), per_level_scale=float(enc["per_level_scale"]), device=device)
