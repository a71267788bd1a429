"""The port's WIRE for a ``"model": "wire"`` config, through its factory:
the complex GaborNet with WIRE's complex Linear last (``outermost_linear``),
``1 + hidden_layers`` Gabor layers before it."""

from __future__ import annotations

from typing import Dict


def build(config: Dict, device):
    from mri_interpolation_tpu_torch.models import make_gabor_net

    w = config["wire"]
    return make_gabor_net(
        int(w["dim_in"]), dim_hidden=int(w["dim_hidden"]), dim_out=int(w["dim_out"]),
        n_layers=int(w["hidden_layers"]) + 2, w0=float(w["w0"]), sigma=float(w["s0"]), lr=float(config["train"]["lr"]),
        kind="complex", outermost_linear=bool(w["outermost_linear"]), device=device)
