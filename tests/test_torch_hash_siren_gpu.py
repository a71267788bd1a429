"""The port's hash SIREN at its published widths on the card against the
benchmark's plain reference (``benchmark/reference_hash_siren.py``): the
16-level hash grid (6,140,528 rows x F = 2) feeding a ReLU modulator 32 /
288 -> 256 x 5 that gates a SIREN 3 -> 256 x 5 -> 1 at w0 30, on 16,384
rows of the (352, 352, 15) grid on [0, 1], float32 with TF32 off: the loss
and every leaf's gradient, the table's included, then one step of
``Trainer.fit`` on those rows held to the reference from the state the
fit reached (the cell ``hash_siren.fit``'s check), with its launches of the
sine-layer pair (one forward and one backward a sine layer) and its
``MODULATOR_ROWS`` (rows x modulator layers); and the factories' refusal
of a width the sine-layer kernels cannot take. Every test here carries the
``gpu`` marker and skips without a CUDA device. The file imports no JAX
(the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_hash_siren_gpu.py --noconftest -q -p no:cacheprovider

Tolerances, each with its reason: cuBLAS's float32 products sum in another
order than the reference's, kernel 1 takes each level's corners in its own
order and kernel 2 sums the table gradient with float atomics in no fixed
order; a sine layer at w0 30 multiplies a product's rounding by 30. A
relative 2e-6 on the loss, 1e-5 on a leaf's gradient (its norm of the
difference over its norm) and 2e-5 on Adam's replayed change and first
moment leave room above what the card reads (0, 3.1e-7 and 1.6e-6 on an
H100; the cell's 12-seed calibration, 1.7e-7, 3.3e-7 and 2.2e-6); the same
reference with TF32 products (1.5e-3 on the worst leaf's gradient, the
SIREN's first layer) must miss the gradients' tolerance by a factor of
ten, so that it binds.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import data, reference_hash_siren
from benchmark.common import strict_fp32
from benchmark.models import hash_siren

CONFIG = json.loads((Path(reference_hash_siren.__file__).resolve().parent / "configs" / "hash_siren.json").read_text())
SEED = 3_000_000_119
ROWS = 1 << 14
LAYERS = CONFIG["siren"]["n_layers"]
LOSS_RTOL, GRAD_RTOL, CHANGE_RTOL = 2e-6, 1e-5, 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash SIREN is held to the reference at its widths on the card")
    return torch.device("cuda")


def _rows(dev):
    """ROWS grid rows in [0, 1], drawn from the seed, and the seed's
    volume's values at them."""
    vol = data.make_volume(CONFIG["volume"], SEED, dev)
    coords = data.training_set(vol)[0]
    rows = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)[:ROWS]
    return coords[rows], data.targets(vol, coords[rows])


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _model(dev):
    model = hash_siren.build(CONFIG, dev)
    model.load_state_dict(reference_hash_siren.init_params(CONFIG, SEED, dev))
    return model


@pytest.mark.gpu
def test_published_widths_loss_and_gradients_equal_the_reference(cuda_device):
    dev = cuda_device
    with strict_fp32():
        model = _model(dev)
        x, y = _rows(dev)
        loss = torch.mean((model(x) - y) ** 2)
        named = list(model.named_parameters())
        grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [p for _, p in named])))
        grid = reference_hash_siren.make_grid(CONFIG)

        def ref(precision):
            p = {k: v.requires_grad_(True) for k, v in reference_hash_siren.init_params(CONFIG, SEED, dev).items()}
            value, g = reference_hash_siren.loss_and_grads(CONFIG, grid, p, sorted(p), x, y, precision, block=8192)
            return value, dict(zip(sorted(p), g))

        ref_loss, ref_grads = ref("fp32")
        _, tf_grads = ref("tf32")
    assert set(grads) == set(ref_grads)
    print(f"loss {float(loss)!r} ref {ref_loss!r} rel {abs(float(loss) - ref_loss) / ref_loss:.3e}")
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * ref_loss
    worst_tf = 0.0
    for k in sorted(ref_grads):
        print(f"{k}: grad rel {_rel(grads[k], ref_grads[k]):.3e}, tf32 {_rel(tf_grads[k], ref_grads[k]):.3e}")
        assert _rel(grads[k], ref_grads[k]) <= GRAD_RTOL, k
        worst_tf = max(worst_tf, _rel(tf_grads[k], ref_grads[k]))
    assert worst_tf >= 10 * GRAD_RTOL


@pytest.mark.gpu
def test_one_step_of_trainer_fit_equals_the_reference(cuda_device):
    """One step of ``Trainer.fit`` on the ROWS rows, held to the reference
    from the state the fit started from (``reference_hash_siren.step_gaps``),
    as the cell ``hash_siren.fit`` judges its window; the step's launches of
    the sine-layer pair and its ``MODULATOR_ROWS``."""
    from benchmark.entries.fit_hash_siren import _StepCapture
    from mri_interpolation_tpu_torch.models import siren
    from mri_interpolation_tpu_torch.ops import sine_layer
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    dev = cuda_device
    with strict_fp32():
        model = _model(dev)
        x, y = _rows(dev)
        capture = _StepCapture(model, 1)
        siren.reset_modulator_rows()
        sine_layer.reset_launches()
        try:
            result = Trainer(TrainConfig(batch_size=ROWS, epochs=1, lr=CONFIG["train"]["lr"], seed=SEED)).fit(
                model, x.cpu().numpy(), y.cpu().numpy(), device=dev)
        finally:
            capture.close()
        assert sine_layer.LAUNCHES == {"sine_layer_forward": LAYERS, "sine_layer_backward": LAYERS}
        assert siren.MODULATOR_ROWS == {"hash_siren": LAYERS * ROWS, "modulated_siren": 0}
        vol = data.make_volume(CONFIG["volume"], SEED, dev)
        batches = [(xb, data.targets(vol, xb)) for xb in capture.xs]
        gaps = reference_hash_siren.step_gaps(CONFIG, capture.reading([float(v) for v in result.losses]), batches,
                                              block=8192)
    print("losses", list(result.losses), "gaps", gaps)
    assert gaps["loss_gap"] <= LOSS_RTOL and gaps["grad_gap"] <= GRAD_RTOL and gaps["change_gap"] <= CHANGE_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("factory", ["make_modulated_siren", "make_hash_siren"])
def test_a_width_the_sine_layer_kernels_cannot_take_is_refused(cuda_device, factory):
    """dim_hidden 30 is refused by the factory with its reason; 32 builds
    and runs a forward through the kernels."""
    from mri_interpolation_tpu_torch.models import siren

    with pytest.raises(ValueError, match="multiple of 4, not 30"):
        getattr(siren, factory)(3, dim_hidden=30, n_layers=2, device=cuda_device)
    model = getattr(siren, factory)(3, dim_hidden=32, n_layers=2, device=cuda_device)
    assert model(torch.rand((5, 3), device=cuda_device)).shape == (5, 1)
