"""Tutorial: the model-family progression of the reference notebook (port of
``examples/tutorial.py``).

The reference's de-facto documentation is a notebook walking MLP -> RFF ->
SIREN -> modulated SIREN -> hash encodings. This is the same progression as
a runnable, asserted demo on a small synthetic volume (pass ``--image_path``
for real data, whose z = 3 slice it fits).

    python -m mri_interpolation_tpu_torch.examples.tutorial [--epochs 60] [--image_path P] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..device import DeviceLike, resolve_device
from ..infer import evaluate_grid
from ..io import dataset_from_array, load_volume, synthetic_volume
from ..metrics import evaluate_reconstruction
from ..models import make_hash_mlp, make_mlp, make_modulated_siren, make_rff_net, make_siren
from ..train import TrainConfig, Trainer

__all__ = ["demo", "main"]

SLICE = (slice(None), slice(None), 3, slice(None))


def demo(name, model, ds, cfg, lo: float = 0.0, data_range: float = 1.0, device: DeviceLike = None) -> float:
    """Fit ``model`` on ``ds``, reconstruct the grid, print and return its
    PSNR."""
    dev = resolve_device(device)
    result = Trainer(cfg).fit(model, ds.coords, ds.values, device=dev)
    recon = evaluate_grid(model, ds.shape, lo=lo, device=dev)
    q = evaluate_reconstruction(recon, ds.image(), data_range=data_range, device=dev)
    print(f"{name:>20}: loss {result.final_loss:.5f}  PSNR {q['psnr']:.1f} dB")
    return q["psnr"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mri_interpolation_tpu_torch.examples.tutorial")
    ap.add_argument("--image_path", default=None, help="optional NIfTI volume")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.image_path:
        ds01 = load_volume(args.image_path, slice_axes=SLICE)
        ds11 = load_volume(args.image_path, zero_centered=True, slice_axes=SLICE)
    else:
        vol = synthetic_volume((24, 24, 12), seed=0)
        ds01 = dataset_from_array(vol)
        ds11 = dataset_from_array(vol, zero_centered=True)

    cfg = TrainConfig(batch_size=2048, epochs=args.epochs, lr=1e-3)
    shape = ds01.shape
    psnr = {}

    # 1. Plain ReLU MLP: struggles with high frequencies (spectral bias)
    psnr["ReLU MLP"] = demo("ReLU MLP", make_mlp(dim_in=3, dim_hidden=64, n_layers=4, device=dev), ds01, cfg,
                            device=dev)

    # 2. Random Fourier features lift the spectral bias
    psnr["RFF + MLP"] = demo("RFF + MLP", make_rff_net(dim_in=3, dim_hidden=64, n_layers=3, n_frequencies=64,
                                                       device=dev), ds01, cfg, device=dev)

    # 3. SIREN: periodic activations, trained on [-1,1] coords
    psnr["SIREN"] = demo("SIREN", make_siren(dim_in=3, dim_hidden=64, n_layers=4, device=dev), ds11,
                         TrainConfig(batch_size=2048, epochs=args.epochs, lr=1e-3), lo=-1.0, data_range=2.0,
                         device=dev)

    # 4. Modulated SIREN
    psnr["modulated SIREN"] = demo(
        "modulated SIREN", make_modulated_siren(dim_in=3, dim_hidden=64, n_layers=3, device=dev), ds11,
        TrainConfig(batch_size=2048, epochs=args.epochs, lr=1e-3), lo=-1.0, data_range=2.0, device=dev)

    # 5. Multiresolution hash grid: fastest convergence per step
    psnr["hash MLP"] = demo("hash MLP", make_hash_mlp(
        dim_in=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=15,
        base_resolution=tuple(max(2, s // 5) for s in shape), finest_resolution=shape,
        dim_hidden=32, n_layers=2, decoder="relu_plain", device=dev),
        ds01, TrainConfig(batch_size=2048, epochs=2 * args.epochs, lr=1e-2), device=dev)

    assert psnr["SIREN"] > 20 and psnr["hash MLP"] > 20, "tutorial models should fit the demo volume"
    return psnr


if __name__ == "__main__":
    main()
