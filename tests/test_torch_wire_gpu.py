"""The port's WIRE at its published widths on the card against the
benchmark's plain reference (``benchmark/reference_wire.py``): 3 -> 181
complex x 3 Gabor layers -> 1 at w0 20, s0 10, on 65,536 rows of the
(352, 352, 15) grid on [-1, 1], float32 with TF32 off; the loss and every
parameter's gradient through ``view_as_real``, then three full-batch steps
of ``Trainer.fit`` on those rows, each held to the reference from the
state the fit reached (the cell ``wire.fit``'s check). Every test here
carries the ``gpu`` marker and skips without a CUDA device. The file
imports no JAX (the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_wire_gpu.py --noconftest -q -p no:cacheprovider

Tolerances, each with its reason: the port's complex products (cuBLAS's
complex64 GEMMs) and the reference's real 2 x 2 block products sum in
other orders, and the activations round differently (a complex ``exp``
against a real one times a cosine and a sine), a few float32 units that
w0 = 20 and s0^2 = 100 amplify through three layers. A relative 2e-6 on
the loss, 1e-4 on a part's gradient (its norm of the difference over its
norm) and 1e-5 on Adam's replayed change and first moment leave room above
what the card reads (5.7e-8, 1.5e-5 and 3.8e-7 on an H100); the same
reference with TF32 products (0.1 on most parts' gradients) must miss the
gradients' tolerance by a factor of ten, so that it binds. Two whole paths
of three steps are not compared: Adam's first step moves every weight by
the rate whatever its gradient's size, so a near-zero gradient's last bits
decide a weight's direction, and by the third step the losses of two
float32 summation orders part by ~1e-4 (read on the card).

The complex layers' weight gradient at the cell's shape (1,858,560 rows,
181 -> 181 as xᴴ dY, and the last layer's 181 -> 1 column as (dYᴴ x)ᴴ) is
held to the float64 product at a relative 2e-5 of the norm: float32 sums
over 1.86 M rows read 6.4e-6 for the matrix and 7.8e-7 for the column on
an H100; a gradient that drops the conjugate reads ~1.4. Its backward's
trace writes no conjugate or copy of the activations (the column's: of
dY's 1,858,560 entries and dW's 181).
"""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import data, reference_wire
from benchmark.common import strict_fp32
from benchmark.models import wire

CONFIG = json.loads((Path(reference_wire.__file__).resolve().parent / "configs" / "wire.json").read_text())
SEED = 3_000_000_081
ROWS = 65_536
LOSS_RTOL, GRAD_RTOL, CHANGE_RTOL = 2e-6, 1e-4, 1e-5
MATERIALISING = ("aten::conj_physical", "aten::resolve_conj", "aten::clone", "aten::copy_", "aten::contiguous")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: WIRE is held to the reference at its widths on the card")
    return torch.device("cuda")


def _rows(dev):
    """ROWS grid rows in [-1, 1], drawn from the seed, and the seed's
    volume's values at them."""
    vol = data.make_volume(CONFIG["volume"], SEED, dev)
    coords = data.training_set(vol)[0]
    rows = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)[:ROWS]
    return coords[rows] * 2.0 - 1.0, data.targets(vol, coords[rows])


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _model(dev):
    model = wire.build(CONFIG, dev)
    model.load_state_dict(reference_wire.port_state(reference_wire.init_params(CONFIG, SEED, dev)))
    return model


@pytest.mark.gpu
def test_wire_181x3_loss_and_gradients_equal_the_reference(cuda_device):
    dev = cuda_device
    with strict_fp32():
        model = _model(dev)
        x, y = _rows(dev)
        loss = torch.mean((model(x) - y) ** 2)
        named = list(model.named_parameters())
        grads = {}
        for (name, _), g in zip(named, torch.autograd.grad(loss, [p for _, p in named])):
            grads.update(reference_wire.real_parts(name, g))

        def ref(precision):
            p = {k: v.clone().requires_grad_(True) for k, v in reference_wire.init_params(CONFIG, SEED, dev).items()}
            value, g = reference_wire.loss_and_grads(CONFIG, p, sorted(p), x, y, precision, block=16_384)
            return value, dict(zip(sorted(p), g))

        ref_loss, ref_grads = ref("fp32")
        _, tf_grads = ref("tf32")
    assert set(grads) == set(ref_grads)
    print(f"loss {float(loss)!r} ref {ref_loss!r} rel {abs(float(loss) - ref_loss) / ref_loss:.3e}")
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * ref_loss
    worst_tf = 0.0
    for k in ref_grads:
        if k == "last.b.im":  # the value is the last Linear's real part: no gradient reaches it
            assert float(grads[k].abs().max()) == float(ref_grads[k].abs().max()) == 0.0
            continue
        print(f"{k}: grad rel {_rel(grads[k], ref_grads[k]):.3e}, tf32 {_rel(tf_grads[k], ref_grads[k]):.3e}")
        assert _rel(grads[k], ref_grads[k]) <= GRAD_RTOL, k
        worst_tf = max(worst_tf, _rel(tf_grads[k], ref_grads[k]))
    assert worst_tf >= 10 * GRAD_RTOL


@pytest.mark.gpu
def test_three_full_batch_steps_of_trainer_fit_equal_the_reference(cuda_device):
    """Each of three full-batch steps of ``Trainer.fit`` held to the
    reference from the state the fit reached (``reference_wire.step_gaps``:
    the loss and every part's gradient there, and Adam replayed over the
    gradients the fit fed it), as the cell ``wire.fit`` judges its window;
    and three steps' worth of ``GABOR_ROWS``."""
    from benchmark.entries.fit_wire import _StepCapture
    from mri_interpolation_tpu_torch.models import gabor
    from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

    dev = cuda_device
    with strict_fp32():
        model = _model(dev)
        x, y = _rows(dev)
        capture = _StepCapture(model, 3)
        gabor.reset_gabor_rows()
        try:
            result = Trainer(TrainConfig(batch_size=ROWS, epochs=3, lr=CONFIG["train"]["lr"], seed=SEED)).fit(
                model, x.cpu().numpy(), y.cpu().numpy(), device=dev)
        finally:
            capture.close()
        assert gabor.GABOR_ROWS["gabor_complex"] == 3 * 3 * ROWS
        vol = data.make_volume(CONFIG["volume"], SEED, dev)
        batches = [(xb, data.targets(vol, (xb + 1.0) * 0.5)) for xb in capture.xs]
        gaps = reference_wire.step_gaps(CONFIG, capture.reading([float(v) for v in result.losses]), batches,
                                        block=16_384)
    print("losses", list(result.losses), "gaps", gaps)
    assert result.losses[2] < result.losses[0]
    assert gaps["loss_gap"] <= LOSS_RTOL and gaps["grad_gap"] <= GRAD_RTOL and gaps["change_gap"] <= CHANGE_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("dim_out", [181, 1])
def test_complex_weight_gradient_at_the_cells_shape(cuda_device, dim_out):
    """One backward of ``gabor.complex_dense`` at wire.fit's rows: the path
    ``WEIGHT_GRADS`` counts, dW against the float64 product and again bit for
    bit, and the trace: no conjugate or copy written at 181 -> 181; for the
    column, none larger than dY's 1,858,560 entries (dY's and dW's
    conjugates), none of the activations."""
    from torch.profiler import ProfilerActivity, profile

    from mri_interpolation_tpu_torch.models import gabor

    dev, rows = cuda_device, 352 * 352 * 15
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape):
        return torch.complex(*(torch.randn(*shape, device=dev, generator=gen) for _ in range(2)))

    x, g = draw(rows, 181).requires_grad_(True), draw(rows, dim_out)
    w, b = draw(181, dim_out).requires_grad_(True), draw(dim_out).requires_grad_(True)
    with strict_fp32():
        y = gabor.complex_dense(w, b, x)
        gabor.reset_weight_grads()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            y.backward(g)
            torch.cuda.synchronize()
        assert gabor.WEIGHT_GRADS == {"matrix": int(dim_out > 1), "column": int(dim_out == 1)}
        assert torch.equal(gabor.weight_grad(x.detach(), g), w.grad)  # the same bits a second time
        dropped = gabor.weight_grad(x.detach().conj(), g)
    exact = x.detach().to(torch.complex128).mH @ g.to(torch.complex128)

    def gap(dw):
        return float(torch.linalg.vector_norm(dw.to(torch.complex128) - exact) / torch.linalg.vector_norm(exact))

    rel, rel_dropped = gap(w.grad), gap(dropped)
    print(f"181 -> {dim_out}: dW rel {rel:.3e}, dropped conjugate {rel_dropped:.3e}")
    assert rel <= 2e-5 < rel_dropped
    # what writes a conjugate or a copy (``aten::_conj`` is the lazy view cuBLAS takes as op C)
    made = [(e.name, e.input_shapes) for e in prof.events() if e.name in MATERIALISING]
    largest = max((math.prod(s) for _, shapes in made for s in shapes if isinstance(s, list) and s), default=0)
    assert (not made) if dim_out == 181 else largest <= rows, made
