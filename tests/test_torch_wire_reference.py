"""The port's WIRE (the complex GaborNet with ``outermost_linear``) against
the benchmark's plain reference (``benchmark/reference_wire.py``), on the
CPU at a small size (width 12, 1 + 2 Gabor layers, w0 20, s0 10, a
(6, 6, 4) volume on [-1, 1], full batch) on seeded weights: the draws, the
forward, ``evaluate_grid`` on the ``chunked`` route, three full-batch
steps of ``Trainer.fit`` (losses, Adam's first moment and every parameter
through ``view_as_real``) and of ``fit_streaming``, a checkpoint saved and
loaded mid-fit that resumes to the same parameters, and the planted faults
(the Gaussian envelope dropped, Adam fed the conjugate gradient), each of
which misses the tolerances. Beside them: the reference and its roofline
import nothing of the port or of JAX; ``GABOR_ROWS`` counts rows x Gabor
layers and the span ``mri.model.gabor`` opens under a profiler.

Tolerances, each with its reason: the port's complex arithmetic (complex64
products, ``abs`` then a square, one complex ``exp``) and the reference's
real form (a 2 x 2 block product, ``p^2 + q^2``, a real ``exp`` times a
cosine and a sine) round differently, by a few float32 units, which w0 =
20 and s0^2 = 100 amplify through three layers (read here over four seeds:
at most 2.3e-6 relative on the forward, 4.5e-6 on a loss, 5.5e-6 on a
part's gradient and 2e-5 on a part's change after three Adam steps, whose
first steps move each element by about the rate whatever its gradient's
size). So: 1e-5 on the forward and the losses, 5e-5 on the gradients, 1e-4
on the changes. The conjugate gradient reads 0.05 and more on the losses of
the steps after the first and 0.1 and more on the changes; without the
envelope, exp(-w0 q) overflows by the second layer and the reference's
loss is not finite.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import reference_wire, roofline_wire
from benchmark.entries import fit_wire
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.infer import grid as port_grid
from mri_interpolation_tpu_torch.models import gabor as port_gabor
from mri_interpolation_tpu_torch.models import make_gabor_net, make_siren
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, restore_checkpoint
from mri_interpolation_tpu_torch.train.trainer import _take_step, _Updates

BENCH = Path(reference_wire.__file__).resolve().parent
CFG = {"wire": {"dim_in": 3, "dim_hidden": 12, "hidden_layers": 2, "dim_out": 1, "w0": 20.0, "s0": 10.0,
                "outermost_linear": True},
       "volume": [6, 6, 4], "train": {"batch_size": 144, "lr": 5e-3, "optimizer": "adam", "lr_schedule": None}}
SEED = 2**31 + 29
FWD_RTOL, GRAD_RTOL, CHANGE_RTOL = 1e-5, 5e-5, 1e-4


def _model(seed=SEED):
    w = CFG["wire"]
    return make_gabor_net(3, dim_hidden=w["dim_hidden"], n_layers=w["hidden_layers"] + 2, w0=w["w0"],
                          sigma=w["s0"], kind="complex", outermost_linear=True, seed=seed, device="cpu")


def _volume():
    """The (6, 6, 4) grid on [-1, 1] and a smooth volume's values on it."""
    axes = [torch.linspace(-1.0, 1.0, s) for s in CFG["volume"]]
    x = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    y = (0.5 + 0.4 * torch.sin(2.0 * x[:, :1]) * torch.cos(3.0 * x[:, 1:2] + x[:, 2:])).contiguous()
    return x, y


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _parts(model):
    """The model's parameters as the reference's real leaves."""
    return {k: t.detach() for n, p in model.named_parameters() for k, t in reference_wire.real_parts(n, p)}


def test_factory_draws_what_the_reference_draws():
    params = reference_wire.init_params(CFG, SEED)
    model = _model()
    state = model.state_dict()
    assert set(state) == {"layers.0.lin.w", "layers.0.lin.b", "layers.1.lin.w", "layers.1.lin.b", "layers.2.lin.w",
                          "layers.2.lin.b", "last.w", "last.b"}
    assert state["layers.0.lin.w"].dtype == torch.float32 and state["last.w"].dtype == torch.complex64
    for name, t in reference_wire.port_state(params).items():
        assert torch.equal(state[name], t), name
    # WIRE's form draws what the default form of the same depth draws: only the last layer's kind differs
    plain = make_gabor_net(3, dim_hidden=12, n_layers=4, kind="complex", seed=SEED, device="cpu").state_dict()
    assert torch.equal(plain["layers.3.lin.w"], state["last.w"]) and torch.equal(plain["layers.3.lin.b"],
                                                                                  state["last.b"])


def test_wire_widths_and_parameter_count():
    """WIRE's image INR: 3 -> 181 real, 2 x 181 -> 181 complex, 181 -> 1
    complex; 132,856 real parameters, as ``roofline_wire`` counts them."""
    model = make_gabor_net(3, dim_hidden=181, n_layers=4, w0=20, sigma=10, kind="complex", outermost_linear=True,
                           device="cpu")
    assert sum(2 * p.numel() if p.is_complex() else p.numel() for p in model.parameters()) == 132_856
    assert roofline_wire.n_params([3, 181, 181, 181, 1]) == 132_856
    assert [layer.complex for layer in model.layers] == [False, True, True]


def test_outermost_linear_is_refused_where_it_is_not_wires_form():
    for kw in (dict(kind="real"), dict(kind="complex", n_layers=1)):
        with pytest.raises(ValueError, match="outermost_linear"):
            make_gabor_net(3, outermost_linear=True, device="cpu", **kw)


def test_forward_equals_the_reference():
    model, params = _model(), reference_wire.init_params(CFG, SEED)
    x = torch.rand((500, 3), generator=torch.Generator().manual_seed(3)) * 2.0 - 1.0
    got = model(x)
    assert got.dtype == torch.float32 and got.shape == (500, 1)
    assert _rel(got.detach(), reference_wire.forward(CFG, params, x)) <= FWD_RTOL


def test_grid_on_the_chunked_route_equals_the_reference():
    model, params = _model(), reference_wire.init_params(CFG, SEED)
    shape = (6, 6, 8)
    before = port_grid.ROUTES["chunked"]
    vol = evaluate_grid(model, shape, lo=-1.0, chunk_size=100, device="cpu")
    assert port_grid.ROUTES["chunked"] == before + 1 and vol.shape == shape

    def coords(start, stop):
        idx = torch.arange(start, stop)
        digits = [(idx // int(np.prod(shape[k + 1:]))) % s for k, s in enumerate(shape)]
        return torch.stack([-1.0 + 2.0 * d.to(torch.float32) / (s - 1) for d, s in zip(digits, shape)], -1)

    ref = reference_wire.grid_volume(CFG, params, coords, int(np.prod(shape)), block=77)
    assert _rel(torch.from_numpy(vol).reshape(-1), ref) <= FWD_RTOL


def _fit_program(steps=3, streaming=False):
    """``steps`` full-batch steps of the port through ``Trainer.fit`` (or
    ``fit_streaming``), read by the benchmark's capture as a
    ``reference_wire.StepReading``: the inputs fed, and each step's loss,
    starting parameters and gradient fed Adam, then the parameters and
    Adam's first moment, each complex leaf as its real parts."""
    model = _model()
    x, y = _volume()
    capture = fit_wire._StepCapture(model, steps)
    cfg = TrainConfig(batch_size=len(x), epochs=steps, lr=CFG["train"]["lr"], seed=5)
    try:
        if streaming:
            vol = y.numpy().reshape(CFG["volume"])
            result = Trainer(cfg).fit_streaming(model, vol, shard_voxels=len(x), lo=-1.0, hi=1.0, value_range=False,
                                                device="cpu")
        else:
            result = Trainer(cfg).fit(model, x.numpy(), y.numpy(), device="cpu")
    finally:
        capture.close()
    return capture.xs, capture.reading([float(v) for v in result.losses])


def _targets(xs):
    """Each input row's value, looked up by its grid digits."""
    _, y = _volume()
    out = []
    for xb in xs:
        flat = torch.zeros(len(xb), dtype=torch.int64)
        for k, s in enumerate(CFG["volume"]):
            flat = flat * s + torch.round((xb[:, k].double() + 1.0) * 0.5 * (s - 1)).to(torch.int64)
        out.append(y[flat])
    return out


def _batches(xs):
    return list(zip(xs, _targets(xs)))


@pytest.mark.parametrize("streaming", [False, True], ids=["fit", "fit_streaming"])
def test_three_full_batch_steps_equal_the_reference(streaming):
    """Each step against the reference from the state the port reached
    (``step_gaps``), and the port's whole path of three steps against the
    reference's own (at this size the two paths stay within the
    tolerances)."""
    xs, prog = _fit_program(streaming=streaming)
    assert len(xs) == 3 and all(len(x) == 144 for x in xs)
    gaps = reference_wire.step_gaps(CFG, prog, _batches(xs), block=50)
    assert gaps["loss_gap"] <= FWD_RTOL and gaps["grad_gap"] <= GRAD_RTOL and gaps["change_gap"] <= FWD_RTOL, gaps
    ref = reference_wire.fit_steps(CFG, reference_wire.init_params(CFG, SEED), _batches(xs), block=50)
    assert max(abs(a - b) / b for a, b in zip(prog.losses, ref.losses)) <= FWD_RTOL
    assert prog.losses[2] < prog.losses[0]
    start = ref.params[0]
    assert set(prog.after) == set(start) and "last.b.im" in start
    for k in start:
        assert _rel(prog.grads[0][k], ref.grads[0][k]) <= GRAD_RTOL or k == "last.b.im", k
        if k != "last.b.im":
            assert _rel(prog.after[k] - start[k], ref.after[k] - start[k]) <= CHANGE_RTOL, k
    # the value is the last Linear's real part: no gradient reaches its bias's imaginary part, and Adam leaves it
    assert float(prog.grads[0]["last.b.im"].abs().max()) == float(ref.grads[0]["last.b.im"].abs().max()) == 0.0
    assert torch.equal(prog.after["last.b.im"], start["last.b.im"])


@pytest.mark.parametrize("fault", [dict(s0=0.0), dict(conjugate=True), dict(precision="tf32")],
                         ids=["envelope_dropped", "conjugate_grad", "control_tf32"])
def test_each_planted_fault_misses_the_tolerances(fault):
    """The cell's numbers (``step_gaps``) of the reference's own steps with
    a fault planted, in the program's place: without the envelope the loss
    is not finite; the conjugate gradient and TF32 products miss the
    gradient's tolerance by far."""
    xs, _ = _fit_program()
    faulted = reference_wire.fit_steps(CFG, reference_wire.init_params(CFG, SEED), _batches(xs), block=50, **fault)
    gaps = reference_wire.step_gaps(CFG, faulted, _batches(xs), block=50)
    if "s0" in fault:
        assert not np.isfinite(faulted.losses).all() and gaps["loss_gap"] == np.inf
    else:
        assert gaps["grad_gap"] > 100 * GRAD_RTOL, gaps


def test_a_step_that_leaves_its_state_unchanged_reads_one():
    xs, prog = _fit_program()
    prog.after = prog.params[0]
    assert reference_wire.step_gaps(CFG, prog, _batches(xs), block=50)["change_gap"] == pytest.approx(1.0)


def test_a_checkpoint_mid_fit_resumes_to_the_same_parameters(tmp_path):
    """Four full-batch steps in one fit, against two, a checkpoint (the
    model and the optimizer's complex moments through ``torch.save``), and
    two more from it in a fresh model and optimizer: the same parameters,
    bit for bit."""
    x, y = _volume()
    cfg = dict(batch_size=len(x), lr=CFG["train"]["lr"], shuffle=False)
    whole = _model()
    Trainer(TrainConfig(epochs=4, **cfg)).fit(whole, x.numpy(), y.numpy(), device="cpu")
    first = _model()
    Trainer(TrainConfig(epochs=2, checkpoint_dir=str(tmp_path), checkpoint_every_epochs=2, **cfg)).fit(
        first, x.numpy(), y.numpy(), device="cpu")
    saved = restore_checkpoint(str(tmp_path))
    assert saved["step"] == 2 and saved["model"]["last.w"].dtype == torch.complex64
    resumed = _model(seed=SEED + 1)
    resumed.load_state_dict(saved["model"])
    updates = _Updates(TrainConfig(epochs=2, **cfg), resumed, 1)
    updates.optimizer.load_state_dict(saved["optimizer"]["adam"])
    updates.updates = saved["optimizer"]["updates"]
    moments = [updates.optimizer.state[p]["exp_avg"] for p in updates.params]
    assert any(m.is_complex() for m in moments)
    loss_fn = lambda a, b: torch.mean((resumed(a) - b) ** 2)  # noqa: E731
    for _ in range(2):
        _take_step(resumed, loss_fn, updates, x, y, remat=False)
    for name, p in whole.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], p), name


def test_gabor_rows_count_rows_times_layers_and_no_other_model():
    port_gabor.reset_gabor_rows()
    model = _model()
    model(torch.zeros(10, 3))
    assert port_gabor.GABOR_ROWS["gabor_complex"] == 3 * 10
    model(torch.zeros(2, 5, 3))
    assert port_gabor.GABOR_ROWS["gabor_complex"] == 3 * 20
    x, y = _volume()
    Trainer(TrainConfig(batch_size=48, epochs=1)).fit(make_siren(3, dim_hidden=8, n_layers=2, device="cpu"),
                                                      x.numpy(), y.numpy(), device="cpu")
    assert port_gabor.GABOR_ROWS["gabor_complex"] == 3 * 20
    port_gabor.reset_gabor_rows()
    assert port_gabor.GABOR_ROWS["gabor_complex"] == 0


def test_gabor_span_opens_under_a_profiler():
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.zeros(7, 3))
    assert sum(e.name == "mri.model.gabor" for e in prof.events()) == 3


@pytest.mark.parametrize("name", ["reference_wire.py", "roofline_wire.py"])
def test_reference_imports_nothing_of_the_port_or_jax(name):
    for node in ast.walk(ast.parse((BENCH / name).read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.module in ("reference", "roofline", "roofline_psf"), f"{name} imports .{node.module}"
        elif isinstance(node, ast.ImportFrom):
            assert node.module in ("__future__", "dataclasses", "typing"), f"{name} imports {node.module}"
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] in ("math", "numpy", "torch") for a in node.names), name


def test_data_parallel_fits_still_refuse_complex_parameters():
    """The data-parallel mean and the gathered state vector are real float32
    buffers: a complex model fits in one process only."""
    from mri_interpolation_tpu_torch.parallel import DataParallelTrainer, fit_multi_volume, make_mesh

    x, y = _volume()
    cfg = TrainConfig(batch_size=len(x), epochs=1)
    with pytest.raises(NotImplementedError, match="one process"):
        DataParallelTrainer(cfg, device="cpu").fit(_model(), x.numpy(), y.numpy())
    with pytest.raises(NotImplementedError, match="one process"):
        fit_multi_volume([_model()], x.numpy(), y.numpy()[None], cfg, mesh=make_mesh(device="cpu"))
