"""The port's models, the JAX package's whole zoo: the flagship HashMLP
(with the tcnn ``relu_plain`` decoder), the SIREN family (SIREN, modulated,
hash and PSF SIREN), BaseMLP, RffNet, GaborNet, FreqMLP, the warp INR, and
the multi-frame MultiSiren and MultiHashMLP."""

from .core import Model
from .freq_mlp import FreqMLP, make_freq_mlp
from .gabor import GaborNet, make_gabor_net
from .hash_mlp import HashMLP, make_hash_mlp
from .mlp import BaseMLP, RffNet, make_mlp, make_rff_net
from .multi import MultiHashMLP, MultiSiren, make_multi_hash_mlp, make_multi_siren
from .siren import (HashSiren, ModulatedSiren, PsfSiren, Siren, make_hash_siren, make_modulated_siren,
                    make_psf_siren, make_siren)
from .warp import WarpINR, make_warp_inr

# name -> factory, with the reference's class names (as the JAX REGISTRY)
REGISTRY = {
    "mlp": make_mlp,
    "BaseMLP": make_mlp,
    "siren": make_siren,
    "SirenNet": make_siren,
    "modulated_siren": make_modulated_siren,
    "ModulatedSirenNet": make_modulated_siren,
    "hash_siren": make_hash_siren,
    "HashSirenNet": make_hash_siren,
    "psf_siren": make_psf_siren,
    "PsfSirenNet": make_psf_siren,
    "rff_net": make_rff_net,
    "RffNet": make_rff_net,
    "hash_mlp": make_hash_mlp,
    "HashMLP": make_hash_mlp,
    "TcnnHashMLP": make_hash_mlp,  # tcnn-style config via per_level_scale + decoder="relu_plain"
    "gabor": make_gabor_net,
    "GaborNet": make_gabor_net,
    "freq_mlp": make_freq_mlp,
    "FreqMLP": make_freq_mlp,
    "multi_siren": make_multi_siren,
    "MultiSiren": make_multi_siren,
    "multi_hash_mlp": make_multi_hash_mlp,
    "MultiHashMLP": make_multi_hash_mlp,
    "warp_inr": make_warp_inr,
}


def get_model_factory(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["Model", "HashMLP", "make_hash_mlp", "Siren", "make_siren", "ModulatedSiren", "make_modulated_siren",
           "HashSiren", "make_hash_siren", "PsfSiren", "make_psf_siren", "MultiSiren", "make_multi_siren",
           "MultiHashMLP", "make_multi_hash_mlp", "BaseMLP", "make_mlp", "RffNet", "make_rff_net", "GaborNet",
           "make_gabor_net", "FreqMLP", "make_freq_mlp", "WarpINR", "make_warp_inr", "REGISTRY", "get_model_factory"]
