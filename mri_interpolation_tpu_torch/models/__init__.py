"""The port's models. This slice holds the flagship HashMLP; the rest of
the JAX package's zoo is listed in ROADMAP.md."""

from .core import Model
from .hash_mlp import HashMLP, make_hash_mlp

REGISTRY = {"hash_mlp": make_hash_mlp, "HashMLP": make_hash_mlp}


def get_model_factory(name: str):
    if name not in REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {sorted(REGISTRY)}); see ROADMAP.md, queue 1")
    return REGISTRY[name]


__all__ = ["Model", "HashMLP", "make_hash_mlp", "REGISTRY", "get_model_factory"]
