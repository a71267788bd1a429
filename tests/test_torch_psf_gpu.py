"""The port's PSF SIREN at its published widths on the card against the
benchmark's plain reference (``benchmark/reference_psf.py``): SIREN 3-256x5-1
at w0 30, 5^3 PSF points, the half-extents of the (352, 352, 15) volume, on
512 voxel centres of the grid (64,000 SIREN rows), float32 with TF32 off;
the loss and every parameter's gradient. Every test here carries the
``gpu`` marker and skips without a CUDA device. The file imports no JAX
(the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_psf_gpu.py --noconftest -q -p no:cacheprovider

Tolerances, each with its reason: the port and the reference run the same
float32 products through cuBLAS at the same shapes (one block of 512
centres); they differ in the integration (an ``einsum`` against a matrix
product) and in how the squared errors are summed, a few float32 roundings
that the sines' w0 = 30 amplify. A relative 1e-6 on the loss and 2e-5 on a
leaf's gradient (its norm of the difference over its norm) leave room
above what the card reads (0 and 0 on an H100: cuBLAS takes the same
kernels for both); the same reference with TF32 products reads 3.4e-5 on
the loss and 4.7e-4 to 3.0e-3 on the gradients, and must miss the
gradients' tolerance by a factor of ten, so that it binds.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import data, reference_psf
from benchmark.common import strict_fp32
from benchmark.models import psf_siren

CONFIG = json.loads((Path(reference_psf.__file__).resolve().parent / "configs" / "psf_siren.json").read_text())
SEED = 3_000_000_077
LOSS_RTOL, GRAD_RTOL = 1e-6, 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PSF SIREN is held to the reference at its widths on the card")
    return torch.device("cuda")


def _slice(dev, n=512):
    """n voxel centres of the grid in [-1, 1], drawn from the seed, and
    their values in [-1, 1] of the seed's volume."""
    vol = data.make_volume(CONFIG["volume"], SEED, dev) * 2.0 - 1.0
    coords = data.training_set(vol)[0]
    rows = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)[:n]
    x = coords[rows]
    return x * 2.0 - 1.0, data.targets(vol, x)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


@pytest.mark.gpu
def test_psf_siren_256x5_loss_and_gradients_equal_the_reference(cuda_device):
    dev = cuda_device
    with strict_fp32():
        params = reference_psf.init_params(CONFIG, SEED, dev)
        model = psf_siren.build(CONFIG, dev)
        model.load_state_dict(params)
        x, y = _slice(dev)
        loss = model.psf_loss(x, y)
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        assert model.offsets.shape == (125, 3)

        def ref(precision):
            p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            offsets, weights = reference_psf.psf_points(reference_psf.half_extents(CONFIG), 5, dev)
            value, g = reference_psf.psf_loss_and_grads(CONFIG, p, sorted(p), x, y, offsets, weights, precision,
                                                        block=512)
            return value, dict(zip(sorted(p), g))

        ref_loss, ref_grads = ref("fp32")
        tf_loss, tf_grads = ref("tf32")
    gaps = {n: _rel(grads[n], ref_grads[n]) for n in names}
    tf_gaps = {n: _rel(tf_grads[n], ref_grads[n]) for n in names}
    loss_gap, tf_loss_gap = abs(float(loss.detach()) - ref_loss) / ref_loss, abs(tf_loss - ref_loss) / ref_loss
    print(f"loss gap {loss_gap:.3e} (TF32 {tf_loss_gap:.3e}); gradient gaps {gaps}; TF32 {tf_gaps}")
    assert loss_gap <= LOSS_RTOL
    assert max(gaps.values()) <= GRAD_RTOL, gaps
    assert max(tf_gaps.values()) > 10 * GRAD_RTOL, tf_gaps
