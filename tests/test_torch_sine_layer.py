"""One SIREN sine layer's bias, w0 scale and sine (``ops/sine_layer.py``):
the plain version against the unfused chain of ``siren_layer_apply``, the
PSF SIREN through it against ``_siren_forward``, the ops' fake impls and the
wrappers' refusals on the CPU; the kernel pair against its plain version on
the card (tests marked ``gpu``, which skip without a CUDA device). The file
imports no JAX (the card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_sine_layer.py --noconftest -q -p no:cacheprovider

Tolerances, each with its reason. The forward and dz repeat autograd's
order of operations, each rounded alone, with the accurate sinf and cosf:
1e-6 of the norm, where the card is expected to read 0 (equal bit for bit).
db sums 512,000 rows in another order (a running sum per thread over ~121
rows, then fixed-order sums of the partials): about 3e-7 of the norm for
N(0, 1) upstream gradients at w0 = 30, so 1e-6.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mri_interpolation_tpu_torch.models import make_psf_siren
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.ops import sine_layer as sl
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

RTOL = 1e-6
ZERO = {name: 0 for name in sl.LAUNCHES}


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _layer(n, k, width, seed, device="cpu"):
    """x (n, k), a sine layer's {"w", "b"} at SIREN's hidden scale and an
    upstream gradient g (n, width), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6.0 / k) / 30.0
    x = torch.from_numpy(rng.uniform(-1, 1, (n, k)).astype(np.float32)).to(device)
    params = {"w": torch.from_numpy(rng.uniform(-bound, bound, (k, width)).astype(np.float32)).to(device),
              "b": torch.from_numpy(rng.uniform(-bound, bound, (width,)).astype(np.float32)).to(device)}
    g = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32)).to(device)
    return x, params, g


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("n, k, width, w0", [(300, 3, 16, 30.0), (257, 256, 256, 30.0), (40, 24, 6, 25.0)])
def test_plain_version_equals_siren_layer_apply(n, k, width, w0):
    """The forward bit for bit; dz and db through autograd of both chains
    within 1e-6 (the same operations: equal here)."""
    x, params, g = _layer(n, k, width, seed=n)
    want = port_siren.siren_layer_apply(params, x, w0)
    assert torch.equal(sl.sine_layer_reference(x @ params["w"], params["b"], w0), want)
    assert torch.equal(sl.sine_layer_forward(x @ params["w"], params["b"], w0), want)

    z = (x @ params["w"]).requires_grad_()
    b = params["b"].clone().requires_grad_()
    dz_want, db_want = torch.autograd.grad(torch.sin(w0 * (z + b)), (z, b), g)
    for dz, db in (sl.sine_layer_backward_reference(g, z.detach(), b.detach(), w0),
                   sl.sine_layer_backward(g, z.detach(), b.detach(), w0),
                   torch.autograd.grad(sl.SineLayer.apply(z, b, w0), (z, b), g)):
        assert _rel(dz, dz_want) <= RTOL and _rel(db, db_want) <= RTOL


@pytest.mark.parametrize("dim_hidden, n_layers", [(8, 3), (6, 2)])
def test_psf_siren_forward_and_loss_equal_the_unfused_path(dim_hidden, n_layers, monkeypatch):
    """``PsfSiren.forward`` (through ``SineLayer``), ``psf_loss`` and every
    parameter's gradient against the same model on ``_siren_forward``."""
    model = make_psf_siren(3, dim_hidden=dim_hidden, n_layers=n_layers, n_sample=3, seed=4,
                           coordinates_spacing=(0.1, 0.1, 0.25), device="cpu")
    rng = np.random.default_rng(dim_hidden)
    x = torch.from_numpy(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (64, 1)).astype(np.float32))
    params = list(model.parameters())

    def run():
        out = model(x)
        loss = model.loss(x, y)
        return out, loss, torch.autograd.grad(loss, params)

    got = run()
    monkeypatch.setattr(port_siren, "_sine_layers_forward", port_siren._siren_forward)
    want = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("name", ["sine_layer_forward", "sine_layer_backward"])
def test_fake_impls_give_the_shapes_and_dtypes(name):
    with FakeTensorMode():
        z, g, b = torch.empty((1000, 64)), torch.empty((1000, 64)), torch.empty((64,))
        out = (torch.ops.mri_torch.sine_layer_forward.default(z, b, 30.0) if name == "sine_layer_forward"
               else torch.ops.mri_torch.sine_layer_backward.default(g, z, b, 30.0))
    outs = [out] if name == "sine_layer_forward" else list(out)
    want = [(1000, 64)] if name == "sine_layer_forward" else [(1000, 64), (64,)]
    assert [tuple(t.shape) for t in outs] == want and all(t.dtype == torch.float32 for t in outs)


def _misaligned(n, width):
    flat = torch.zeros(n * width + 1)
    return flat[1:].view(n, width)  # contiguous, 4 bytes past a 16-byte boundary


REFUSALS = {
    "width_not_a_multiple_of_4": (lambda: (torch.zeros(8, 6), torch.zeros(6)), ValueError, "multiple of 4"),
    "bias_shape": (lambda: (torch.zeros(8, 8), torch.zeros(4)), ValueError, "b has shape"),
    "bias_2d": (lambda: (torch.zeros(8, 8), torch.zeros(1, 8)), ValueError, "b has shape"),
    "z_float64": (lambda: (torch.zeros(8, 8, dtype=torch.float64), torch.zeros(8)), TypeError, "float32"),
    "b_bfloat16": (lambda: (torch.zeros(8, 8), torch.zeros(8, dtype=torch.bfloat16)), TypeError, "float32"),
    "z_not_contiguous": (lambda: (torch.zeros(8, 16)[:, ::2], torch.zeros(8)), ValueError, "contiguous"),
    "z_misaligned": (lambda: (_misaligned(8, 8), torch.zeros(8)), ValueError, "16 bytes"),
    "cpu_tensors": (lambda: (torch.zeros(8, 8), torch.zeros(8)), ValueError, "CUDA device"),
}


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrappers_refuse_what_the_kernels_do_not_take(case, direction):
    """The kernels' wrappers raise before any launch (on the CPU, before
    they would look for the card); nothing counts."""
    make, error, match = REFUSALS[case]
    z, b = make()
    sl.reset_launches()
    with pytest.raises(error, match=match):
        if direction == "forward":
            sl._forward_cuda(z, b, 30.0)
        else:
            sl._backward_cuda(torch.zeros(z.shape, dtype=z.dtype), z, b, 30.0)
    assert sl.LAUNCHES == ZERO


def test_backward_refuses_a_gradient_of_another_shape():
    with pytest.raises(ValueError, match="g has shape"):
        sl._backward_cuda(torch.zeros(8, 4), torch.zeros(8, 8), torch.zeros(8), 30.0)


def test_a_cpu_psf_fit_counts_no_launch():
    """A PSF SIREN fit on the CPU runs the ops' plain versions: it trains,
    and nothing counts."""
    model = make_psf_siren(3, dim_hidden=8, n_layers=3, n_sample=3, coordinates_spacing=(0.1, 0.1, 0.2),
                           device="cpu")
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    values = rng.uniform(-1, 1, (96, 1)).astype(np.float32)
    sl.reset_launches()
    result = Trainer(TrainConfig(batch_size=32, epochs=2, lr=1e-4)).fit(model, coords, values, device="cpu")
    assert result.steps == 6 and np.all(np.isfinite(result.losses))
    assert sl.LAUNCHES == ZERO


def test_a_psf_siren_exports_as_one_graph(tmp_path):
    """The PSF SIREN's grid evaluator through ``torch.export``: one
    ``sine_layer_forward`` node a sine layer, equal to ``evaluate_grid``."""
    from mri_interpolation_tpu_torch.infer import evaluate_grid, load_evaluator, save_evaluator

    model = make_psf_siren(3, dim_hidden=8, n_layers=3, n_sample=3, coordinates_spacing=(0.1, 0.1, 0.2),
                           device="cpu")
    path = save_evaluator(str(tmp_path / "psf.pt2"), model, (5, 4, 3), lo=-1.0, chunk_size=16, device="cpu")
    assert torch.export.load(path).graph_module.code.count("mri_torch.sine_layer_forward") == 3
    np.testing.assert_array_equal(load_evaluator(path)(), evaluate_grid(model, (5, 4, 3), lo=-1.0, device="cpu"))


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sine-layer kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (rows, width): the PSF SIREN's 512,000 x 256 and a ragged row count at its width; a width whose column groups
# do not divide a block (3 groups: 85 rows a sweep, one thread idle); two column tiles (260 groups: 256 + 4)
SHAPES = [(512_000, 256), (4_097, 256), (1_001, 12), (3_001, 1_040)]


@pytest.mark.gpu
@pytest.mark.parametrize("n, width", SHAPES)
def test_kernels_equal_their_plain_version(n, width, cuda_device):
    """The forward and dz within 1e-6 of the norm (expected: equal), db
    within 1e-6, at w0 = 30 on pre-activations of a first layer's scale
    (N(0, 1): arguments to ~150 rad)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + width)
    z = torch.randn((n, width), generator=gen, device=cuda_device)
    b = torch.randn((width,), generator=gen, device=cuda_device) * 0.1
    g = torch.randn((n, width), generator=gen, device=cuda_device)
    sl.reset_launches()
    a = sl.sine_layer_forward(z, b, 30.0)
    dz, db = sl.sine_layer_backward(g, z, b, 30.0)
    torch.cuda.synchronize()
    assert sl.LAUNCHES == {"sine_layer_forward": 1, "sine_layer_backward": 1}
    a_want = sl.sine_layer_reference(z, b, 30.0)
    dz_want, db_want = sl.sine_layer_backward_reference(g, z, b, 30.0)
    assert _rel(a, a_want) <= RTOL and _rel(dz, dz_want) <= RTOL and _rel(db, db_want) <= RTOL


@pytest.mark.gpu
def test_two_runs_give_equal_gradients(cuda_device):
    """No atomics: the same inputs give the same dz and db bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    z, g = (torch.randn((100_003, 256), generator=gen, device=cuda_device) for _ in range(2))
    b = torch.randn((256,), generator=gen, device=cuda_device)
    first = sl.sine_layer_backward(g, z, b, 30.0)
    second = sl.sine_layer_backward(g, z, b, 30.0)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_a_psf_fit_launches_each_kernel_once_a_sine_layer_and_step(cuda_device):
    """A short PSF SIREN fit (5 sine layers) on the card: 5 forward and 5
    backward launches a step; its loss curve follows the same fit on the CPU
    (the sums' orders differ: 1e-4, as the card's other small fits)."""
    rng = np.random.default_rng(1)
    coords = rng.uniform(-1, 1, (4 * 256, 3)).astype(np.float32)
    values = rng.uniform(-1, 1, (4 * 256, 1)).astype(np.float32)
    cfg = TrainConfig(batch_size=256, epochs=2, lr=1e-4, shuffle=False)
    losses = {}
    for device in ("cpu", "cuda"):
        model = make_psf_siren(3, dim_hidden=64, n_layers=5, n_sample=3, coordinates_spacing=(0.1, 0.1, 0.2),
                               seed=3, device=device)
        sl.reset_launches()
        losses[device] = Trainer(cfg).fit(model, coords, values, device=device).losses
        counts = dict(sl.LAUNCHES)
    steps = 2 * 4
    assert counts == {"sine_layer_forward": 5 * steps, "sine_layer_backward": 5 * steps}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
