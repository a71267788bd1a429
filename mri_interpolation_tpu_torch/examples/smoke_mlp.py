"""End-to-end smoke run: the ReLU-MLP fit of a volume's 2-D+t slice (port
of ``examples/smoke_mlp.py``).

The reference's ``test_script.py`` (8-layer ReLU MLP, dim_hidden 352, batch
20000, the (x, y, t) slice at z = 3, the prediction saved as NIfTI), with the
assertions the reference never had.

    python -m mri_interpolation_tpu_torch.examples.smoke_mlp [--image_path P] [--epochs 5] [--out pred_MLP.nii.gz] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..infer import evaluate_grid
from ..io import load_volume, nifti
from ..metrics import evaluate_reconstruction
from ..models import make_mlp
from ..experiments import common
from ..train import TrainConfig, Trainer

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.examples.smoke_mlp")
    ap.add_argument("--image_path", default=common.SAMPLE, help="the NIfTI volume (default: the sample volume's name)")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--out", default="pred_MLP.nii.gz")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_volume(args.image_path, slice_axes=(slice(None), slice(None), 3, slice(None)))
    model = make_mlp(dim_in=3, dim_hidden=352, n_layers=8, device=dev)
    result = Trainer(TrainConfig(batch_size=20000, epochs=args.epochs, lr=1e-4)).fit(
        model, ds.coords, ds.values, device=dev)
    recon = evaluate_grid(model, ds.shape, device=dev)
    q = evaluate_reconstruction(recon, ds.image(), device=dev)
    nifti.save(recon.astype(np.float32), args.out, pixdim=ds.pixdim)
    print(f"final loss {result.final_loss:.5f}, PSNR {q['psnr']:.2f} dB, saved {args.out}")
    assert np.isfinite(result.final_loss) and result.final_loss < 0.1
    return {"final_loss": result.final_loss, "psnr": q["psnr"], "out": args.out}


if __name__ == "__main__":
    main()
