"""The port's PSF SIREN for a ``"model": "psf_siren"`` config, through its
factory, with the PSF's half-extents the launcher passes
(``0.5 / max(s - 1, 1)`` on the volume's first three axes)."""

from __future__ import annotations

from typing import Dict


def build(config: Dict, device):
    from mri_interpolation_tpu_torch.models import make_psf_siren

    s = config["siren"]
    spacing = tuple(0.5 / max(int(v) - 1, 1) for v in config["volume"][:3])
    return make_psf_siren(
        int(s["dim_in"]), dim_hidden=int(s["dim_hidden"]), dim_out=int(s["dim_out"]), n_layers=int(s["n_layers"]),
        w0=float(s["w0"]), w0_initial=float(s["w0_initial"]), sigma=float(s["sigma"]),
        lr=float(config["train"]["lr"]), coordinates_spacing=spacing, n_sample=int(config["psf"]["n_sample"]),
        device=device)
