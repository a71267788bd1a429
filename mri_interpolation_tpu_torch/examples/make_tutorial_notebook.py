"""Generate ``tutorial.ipynb`` beside this file, the interactive counterpart
of ``examples/tutorial.py`` (port of ``scripts/make_tutorial_notebook.py``).

The reference's de-facto documentation is a runnable notebook walking
MLP -> RFF -> SIREN -> modulated SIREN -> hash encodings. This script emits
the same progression as a clean-output .ipynb (no outputs, no execution
counts: the artifact policy), built from the cell list below, whose code
cells call the port. ``tests/test_torch_tutorial_notebook.py`` holds the
committed notebook equal to :func:`build` and runs its code cells top to
bottom on the CPU, so the notebook stays runnable.

    python -m mri_interpolation_tpu_torch.examples.make_tutorial_notebook [out.ipynb]
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

__all__ = ["CELLS", "NOTEBOOK", "build", "code_cells", "main"]

MD = "markdown"
PY = "code"
NOTEBOOK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tutorial.ipynb")

CELLS = [
    (MD, """\
# mri_interpolation_tpu_torch — tutorial

The model-family progression from the reference notebook
(`ReprésentationsImplicites.ipynb`), on the PyTorch/CUDA port:
**ReLU MLP → random Fourier features → SIREN → modulated SIREN →
multiresolution hash grid**, ending with dense-grid interpolation and the
even-frame evaluation protocol.

Runs on the card (`DEVICE = "cuda"`) in well under a minute on a small
synthetic volume; `DEVICE = "cpu"` runs it on the CPU in a few minutes.
Point `IMAGE_PATH` at a NIfTI file (e.g. the reference's
`sample_ankle_dyn_mri.nii.gz`) to use real data."""),
    (PY, """\
import numpy as np

from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import (dataset_from_array, load_volume,
                                            synthetic_volume)
from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction
from mri_interpolation_tpu_torch.models import (make_hash_mlp, make_mlp,
                                                make_modulated_siren,
                                                make_rff_net, make_siren)
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

DEVICE = "cuda"  # the card; "cpu" runs the demo volume on the CPU
IMAGE_PATH = None  # e.g. "sample_ankle_dyn_mri.nii.gz"
EPOCHS = 40"""),
    (MD, """\
## Data

A volume becomes a flat regression dataset: coordinates in `[0,1]^d` (or
`[-1,1]^d` for SIREN) against min-max-normalized intensities — the INR fits
`f(x, y, t) -> intensity`."""),
    (PY, """\
if IMAGE_PATH:
    ds01 = load_volume(IMAGE_PATH,
                       slice_axes=(slice(None), slice(None), 3, slice(None)))
    ds11 = load_volume(IMAGE_PATH, zero_centered=True,
                       slice_axes=(slice(None), slice(None), 3, slice(None)))
else:
    vol = synthetic_volume((24, 24, 12), seed=0)
    ds01 = dataset_from_array(vol)
    ds11 = dataset_from_array(vol, zero_centered=True)
shape = ds01.shape
print(f"{len(ds01):,} voxels of shape {shape}, coords in "
      f"[{ds01.coords.min():.0f}, {ds01.coords.max():.0f}]")"""),
    (PY, """\
def demo(name, model, ds, cfg, lo=0.0, data_range=1.0):
    result = Trainer(cfg).fit(model, ds.coords, ds.values, device=DEVICE)
    recon = evaluate_grid(model, ds.shape, lo=lo, device=DEVICE)
    q = evaluate_reconstruction(recon, ds.image(), data_range=data_range,
                                device=DEVICE)
    print(f"{name:>20}: loss {result.final_loss:.5f}  "
          f"PSNR {q['psnr']:.1f} dB")
    return q["psnr"], recon

cfg = TrainConfig(batch_size=2048, epochs=EPOCHS, lr=1e-3)"""),
    (MD, """\
## 1. Plain ReLU MLP

A coordinate MLP without any encoding struggles with high frequencies —
the *spectral bias* the rest of the progression addresses.
(Reference: `models.py` `BaseMLP`, `test_script.py`.)"""),
    (PY, """\
p_mlp, _ = demo("ReLU MLP", make_mlp(dim_in=3, dim_hidden=64, n_layers=4,
                                     device=DEVICE), ds01, cfg)"""),
    (MD, """\
## 2. Random Fourier features

Projecting coordinates through fixed Gaussian frequencies
(`γ(x) = [sin 2πBx, cos 2πBx]`) lifts the spectral bias.
(Reference: `RffNet`, the external `rff` package.)"""),
    (PY, """\
p_rff, _ = demo("RFF + MLP",
                make_rff_net(dim_in=3, dim_hidden=64, n_layers=3,
                             n_frequencies=64, device=DEVICE), ds01, cfg)"""),
    (MD, """\
## 3. SIREN

Periodic activations `sin(w0·x)` with the Sitzmann init; trained on
`[-1,1]` coordinates. (Reference: `SirenNet`, `models.py:160-233`.)
On the card its layers run in the port's fused-MLP kernels."""),
    (PY, """\
p_siren, _ = demo("SIREN", make_siren(dim_in=3, dim_hidden=64, n_layers=4,
                                      device=DEVICE),
                  ds11, TrainConfig(batch_size=2048, epochs=EPOCHS, lr=1e-3),
                  lo=-1.0, data_range=2.0)"""),
    (MD, """\
## 4. Modulated SIREN

A ReLU modulator network (fed the raw coordinates) gates each SIREN
layer's output elementwise — per-layer amplitude control.
(Reference: `ModulatedSirenNet`, Mehta et al. 2021.)"""),
    (PY, """\
p_mod, _ = demo("modulated SIREN",
                make_modulated_siren(dim_in=3, dim_hidden=64, n_layers=3,
                                     device=DEVICE),
                ds11, TrainConfig(batch_size=2048, epochs=EPOCHS, lr=1e-3),
                lo=-1.0, data_range=2.0)"""),
    (MD, """\
## 5. Multiresolution hash grid

Instant-NGP-style: learned feature tables at geometrically growing
resolutions, multilinearly interpolated and decoded by a small MLP — the
fastest convergence per step of the family, and the framework's flagship.
(Reference: `HashMLP` / `encoding.py`; the port's fused-table encoder in
`encodings/hashgrid.py`, whose forward and table gradient are CUDA kernels
on the card, as is the `relu_plain` decoder.)"""),
    (PY, """\
p_hash, recon = demo("hash MLP", make_hash_mlp(
    dim_in=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=15,
    base_resolution=tuple(max(2, s // 5) for s in shape),
    finest_resolution=shape, dim_hidden=32, n_layers=2,
    decoder="relu_plain", device=DEVICE),
    ds01, TrainConfig(batch_size=2048, epochs=2 * EPOCHS, lr=1e-2))
assert p_siren > 20 and p_hash > 20, "tutorial models should fit the volume"
"""),
    (MD, """\
## 6. Arbitrary-resolution interpolation

The fitted INR is continuous: evaluating it on a denser grid IS the
interpolation — here 2x along the last (time) axis.
(Reference: `launcher.py:191-222` `interp_shapes`.)"""),
    (PY, """\
up_shape = shape[:-1] + (2 * shape[-1],)
model = make_hash_mlp(
    dim_in=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=15,
    base_resolution=tuple(max(2, s // 5) for s in shape),
    finest_resolution=shape, dim_hidden=32, n_layers=2,
    decoder="relu_plain", device=DEVICE)
res = Trainer(TrainConfig(batch_size=2048, epochs=2 * EPOCHS,
                          lr=1e-2)).fit(model, ds01.coords, ds01.values,
                                        device=DEVICE)
upsampled = evaluate_grid(model, up_shape, device=DEVICE)
print("interpolated volume:", upsampled.shape)"""),
    (MD, """\
## 7. The honest evaluation protocol

Train on the EVEN frames only, score on the held-out odd frames — the
reference's actual interpolation-quality protocol
(`hash_experimentation.py:313-317`), available as one call."""),
    (PY, """\
from mri_interpolation_tpu_torch.train.protocols import even_frame_fit_eval

proto_model = make_hash_mlp(
    dim_in=3, n_levels=3, n_features_per_level=2, log2_hashmap_size=14,
    base_resolution=tuple(max(2, s // 5) for s in shape),
    finest_resolution=shape, dim_hidden=32, n_layers=2,
    decoder="relu_plain", device=DEVICE)
_, q = even_frame_fit_eval(proto_model, ds01.image(),
                           TrainConfig(batch_size=2048, epochs=2 * EPOCHS,
                                       lr=1e-2), device=DEVICE)
print(f"held-out odd-frame PSNR: {q['odd']['psnr']:.2f} dB "
      f"(full volume {q['full']['psnr']:.2f} dB)")"""),
    (MD, """\
## Where to go next

- `python -m mri_interpolation_tpu_torch.examples.tutorial` — this
  walkthrough as an asserted script
- `python -m mri_interpolation_tpu_torch.launcher --help` — the training CLI
  (the reference `launcher.py`'s flags and the port's extensions)
- `mri_interpolation_tpu_torch/train/stacking.py` — the LOO-stacked
  temporal-interpolation estimator (the framework's held-out headline)
- `python -m mri_interpolation_tpu_torch.experiments` — the results matrix,
  written to `runs/results_torch/RESULTS.md` with the card it ran on"""),
]


def build() -> dict:
    cells = []
    for kind, src in CELLS:
        lines = src.splitlines(keepends=True)
        cell = {"cell_type": kind, "metadata": {}, "source": lines}
        if kind == PY:
            cell.update({"execution_count": None, "outputs": []})
        cells.append(cell)
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def code_cells(notebook: dict) -> list:
    """The source of each code cell of a notebook dict, in order."""
    return ["".join(c["source"]) for c in notebook["cells"] if c["cell_type"] == PY]


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = sys.argv[1:] if argv is None else list(argv)
    out = args[0] if args else NOTEBOOK
    with open(out, "w") as f:
        json.dump(build(), f, indent=1)
    n_code = sum(1 for k, _ in CELLS if k == PY)
    print(f"{out}: {len(CELLS)} cells ({n_code} code)")
    return out


if __name__ == "__main__":
    main()
