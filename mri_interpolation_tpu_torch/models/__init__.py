"""The port's models: the flagship HashMLP (with the tcnn ``relu_plain``
decoder), the SIREN family (SIREN, modulated, hash and PSF SIREN), and the
multi-frame MultiSiren and MultiHashMLP; the rest of the JAX package's zoo is
listed in ROADMAP.md."""

from .core import Model
from .hash_mlp import HashMLP, make_hash_mlp
from .multi import MultiHashMLP, MultiSiren, make_multi_hash_mlp, make_multi_siren
from .siren import (HashSiren, ModulatedSiren, PsfSiren, Siren, make_hash_siren, make_modulated_siren,
                    make_psf_siren, make_siren)

# name -> factory, with the reference's class names (as the JAX REGISTRY)
REGISTRY = {
    "siren": make_siren,
    "SirenNet": make_siren,
    "modulated_siren": make_modulated_siren,
    "ModulatedSirenNet": make_modulated_siren,
    "hash_siren": make_hash_siren,
    "HashSirenNet": make_hash_siren,
    "psf_siren": make_psf_siren,
    "PsfSirenNet": make_psf_siren,
    "hash_mlp": make_hash_mlp,
    "HashMLP": make_hash_mlp,
    "TcnnHashMLP": make_hash_mlp,  # tcnn-style config via per_level_scale + decoder="relu_plain"
    "multi_siren": make_multi_siren,
    "MultiSiren": make_multi_siren,
    "multi_hash_mlp": make_multi_hash_mlp,
    "MultiHashMLP": make_multi_hash_mlp,
}


def get_model_factory(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {sorted(REGISTRY)}); see ROADMAP.md, queue 1")
    return REGISTRY[name]


__all__ = ["Model", "HashMLP", "make_hash_mlp", "Siren", "make_siren", "ModulatedSiren", "make_modulated_siren",
           "HashSiren", "make_hash_siren", "PsfSiren", "make_psf_siren", "MultiSiren", "make_multi_siren",
           "MultiHashMLP", "make_multi_hash_mlp", "REGISTRY", "get_model_factory"]
