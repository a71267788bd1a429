"""The port's models: the flagship HashMLP (with the tcnn ``relu_plain``
decoder) and SIREN; the rest of the JAX package's zoo is listed in
ROADMAP.md."""

from .core import Model
from .hash_mlp import HashMLP, make_hash_mlp
from .siren import Siren, make_siren

# name -> factory, with the reference's class names (as the JAX REGISTRY)
REGISTRY = {
    "siren": make_siren,
    "SirenNet": make_siren,
    "hash_mlp": make_hash_mlp,
    "HashMLP": make_hash_mlp,
    "TcnnHashMLP": make_hash_mlp,  # tcnn-style config via per_level_scale + decoder="relu_plain"
}


def get_model_factory(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {sorted(REGISTRY)}); see ROADMAP.md, queue 1")
    return REGISTRY[name]


__all__ = ["Model", "HashMLP", "make_hash_mlp", "Siren", "make_siren", "REGISTRY", "get_model_factory"]
