"""The benchmark's cells ``wire.fit`` and ``psf_siren.interp`` on the CPU.

- A whole run of the entry ``fit_wire`` at a tiny size (width 16, 1 + 2
  Gabor layers, a (6, 6, 4) volume, full batch of 144 rows; the cell's
  entry, traffic parameters and limits otherwise) reads ``correct`` true,
  and false with a fault planted under the timed path: the program's
  products in TF32 (the control), the Gaussian envelope dropped (s0 = 0),
  Adam fed the conjugate gradient, half of each batch left out, and a step
  that leaves the state unchanged.
- A whole run of the entry ``interp_siren`` at a tiny size (the PSF
  SIREN's config at width 16, 2 sine layers, a (6, 6, 8) grid in chunks of
  100) reads ``correct`` true, and false with the program's products in
  TF32 or its hidden layers' w0 off by a thousandth.
- The new readers on a hand-made traced window (``gabor_device_ms``,
  ``gabor_host_us``; ``mlp_roofline_pct`` and ``mfu_pct`` on the entries'
  work), and the step's and the request's least times at their published
  sizes.
"""

import copy
import json

import pytest
import torch

from benchmark import reference, reference_wire, roofline_psf, roofline_wire, run, spec, trace
from benchmark.common import Outcome
from benchmark.entries import fit_wire, interp_siren
from mri_interpolation_tpu_torch.models import core as port_core
from mri_interpolation_tpu_torch.models import gabor as port_gabor
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.ops.sine_layer import SineLayer
from mri_interpolation_tpu_torch.train import trainer as port_trainer

WIRE, INTERP = "wire.fit", "psf_siren.interp"
_ORIGINAL_LOAD = spec.load_cell


def _shrink(cell):
    cell = copy.deepcopy(cell)
    if cell.name == WIRE:
        cell.config["wire"]["dim_hidden"] = 16
        cell.config["volume"] = [6, 6, 4]
        cell.config["train"]["batch_size"] = 144
    else:
        cell.config["siren"].update(dim_hidden=16, n_layers=2)
        cell.workload.update(grid=[6, 6, 8], chunk_size=100)
    return cell


def _drive(monkeypatch, capsys, cell, seed=2147483659):
    """A whole tiny run; the check that the run loads no JAX counts what
    the run loads beyond what the test process (whose conftest imports
    JAX) held before it."""
    monkeypatch.setattr(spec, "load_cell", lambda name, root=spec.ROOT: _shrink(_ORIGINAL_LOAD(name, root)))
    monkeypatch.setattr(run, "require_chips", lambda n: torch.device("cpu"))
    held = set(run.loaded_forbidden())
    loaded = run.loaded_forbidden
    monkeypatch.setattr(run, "loaded_forbidden", lambda: sorted(set(loaded()) - held))
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"]) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def _tf32(t):
    """``t`` with its operands rounded to TF32 forward, the gradient passed
    through unchanged; a complex tensor's parts each."""
    d = t.detach()
    r = torch.view_as_complex(reference.tf32_round(torch.view_as_real(d))) if d.is_complex() else \
        reference.tf32_round(d)
    return t + (r - d)


def _tf32_dense(monkeypatch):
    monkeypatch.setattr(port_core, "dense", lambda w, b, x: _tf32(x) @ _tf32(w) + b)


def _envelope_dropped(monkeypatch):
    forward = port_gabor.ComplexGaborLayer.forward
    monkeypatch.setattr(port_gabor.ComplexGaborLayer, "forward", lambda self, z, w0, sigma: forward(self, z, w0, 0.0))


def _conjugate_grad(monkeypatch):
    step = port_trainer._Updates.step

    def conjugated(self):
        for p in self.params:
            if p.grad is not None and p.is_complex():
                p.grad = p.grad.conj().resolve_conj()
        step(self)

    monkeypatch.setattr(port_trainer._Updates, "step", conjugated)


def _half_batch(monkeypatch):
    step_loss = port_trainer._step_loss

    def half(model, loss_fn, x, y, remat):
        return step_loss(model, loss_fn, x[: len(x) // 2], y[: len(y) // 2], remat)

    monkeypatch.setattr(port_trainer, "_step_loss", half)


def _state_unchanged(monkeypatch):
    step = port_trainer._Updates.step

    def frozen(self):
        held = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, h in zip(self.params, held):
                p.copy_(h)

    monkeypatch.setattr(port_trainer._Updates, "step", frozen)


def _siren_forward(product, scale=1.0):
    def plant(monkeypatch):
        def forward(params, x, n_layers, w0, w0_initial):
            for i in range(n_layers):
                layer = params["layers"][i]
                x = SineLayer.apply(product(x, layer["w"]), layer["b"], w0_initial if i == 0 else w0 * scale)
            return product(x, params["last"]["w"]) + params["last"]["b"]

        monkeypatch.setattr(port_siren, "_sine_layers_forward", forward)

    return plant


WIRE_FAULTS = {"tf32_products": _tf32_dense, "envelope_dropped": _envelope_dropped,
               "conjugate_grad": _conjugate_grad, "half_batch": _half_batch, "state_unchanged": _state_unchanged}
INTERP_FAULTS = {"tf32_products": _siren_forward(lambda x, w: reference.matmul(x, w, "tf32")),
                 "w0_off": _siren_forward(lambda x, w: x @ w, scale=1.001)}


@pytest.mark.parametrize("seed", [2147483659, 40_000_000_003])
def test_wire_fit_unbroken_reads_correct(seed, monkeypatch, capsys):
    result, err = _drive(monkeypatch, capsys, WIRE, seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "rows_short"}
    assert list(result)[-1] == "checks" and set(result["metrics"]) == {"fit_voxels_per_s", "setup_s"}
    line = next(s for s in err.splitlines() if s.startswith("gabor rows over the window"))
    counted, expected = line.split(": ")[1].split(" (")[0], line.split("= ")[1].rstrip(")")
    assert counted == expected


@pytest.mark.parametrize("fault", sorted(WIRE_FAULTS))
def test_wire_fit_fault_reads_incorrect(fault, monkeypatch, capsys):
    WIRE_FAULTS[fault](monkeypatch)
    result, _ = _drive(monkeypatch, capsys, WIRE)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [2147483659, 40_000_000_003])
def test_psf_siren_interp_unbroken_reads_correct(seed, monkeypatch, capsys):
    result, err = _drive(monkeypatch, capsys, INTERP, seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"volume_gap"}
    assert set(result["metrics"]) == {"interp_voxels_per_s", "setup_s"}
    assert "gabor rows over the window: 0" in err


@pytest.mark.parametrize("fault", sorted(INTERP_FAULTS))
def test_psf_siren_interp_fault_reads_incorrect(fault, monkeypatch, capsys):
    INTERP_FAULTS[fault](monkeypatch)
    result, _ = _drive(monkeypatch, capsys, INTERP)
    assert not result["correct"], result["checks"]


def test_the_capture_reads_each_step_as_real_leaves():
    """The capture keeps k steps (inputs, starting parameters, gradients fed
    Adam) and the state after step k, each complex leaf as its ``.re`` and
    ``.im`` (the reference's leaves), and takes its hooks off on close."""
    config = _shrink(_ORIGINAL_LOAD(WIRE)).config
    model = spec.model_builder(config)(config, "cpu")
    capture = fit_wire._StepCapture(model, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for _ in range(3):
        opt.zero_grad()
        model(torch.rand(9, 3)).sum().backward()
        opt.step()
    capture.close()
    names = set(reference_wire.init_params(config, 1))
    assert len(capture.xs) == len(capture.params) == len(capture.grads) == 2
    assert set(capture.params[1]) == set(capture.grads[1]) == set(capture.after) == set(capture.first_moment) == names
    assert not torch.equal(capture.params[0]["last.w.im"], capture.params[1]["last.w.im"])
    assert float(capture.grads[0]["last.b.im"].abs().max()) == 0.0
    assert capture.reading([1.0]) is None and capture.reading([1.0, 1.0]) is not None


# ---------------------------------------------------------------------------
# the per-layer readers on a hand-made window: 3 steps of 10 ms


WIRE_WORK = fit_wire.step_work(_ORIGINAL_LOAD(WIRE).config)
OPS = [("void cutlass::Kernel2<cutlass_80_simt_cgemm_128x64_8x5_nn_align1>", 1.0e-3, 4e-3),
       ("void gemv2T_kernel_val<int, int, float2>", 5.2e-3, 1e-4),
       ("void at::native::vectorized_elementwise_kernel<4, exp_kernel_cuda>", 5.6e-3, 2e-3),
       ("void at::native::reduce_kernel<512, 1, ReduceOp<c10::complex<float>, sum_functor>>", 7.8e-3, 3e-4),
       ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>, FusedAdamMathFunctor>", 8.6e-3, 6e-4),
       ("Memcpy DtoH (Device -> Pageable)", 9.8e-3, 1e-4)]
SPANS = [("mri.model.gabor", 1.0e-3 + 1e-2 * i + off, 2e-5) for i in range(3) for off in (1e-4, 2e-4, 3e-4)]


def _outcome(work, host=SPANS, units=3):
    window = trace.TraceWindow(window_s=30e-3, ops=OPS, host=host, start_s=1.0e-3)
    return Outcome(metrics={}, checks={}, attempted=0, failed=0, memory_peak_bytes=0, trace=window, units=units,
                   work=work)


def _read(name, out):
    return spec.metric_reader(name)(out)


def test_new_metrics_are_declared_for_the_new_cells():
    declared = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    wire = ["gabor_device_ms.wire", "gabor_host_us.wire", "mlp_roofline_pct.wire", "mfu_pct.wire",
            "device_idle_pct.wire"]
    for name in wire:
        assert declared[name]["workloads"] == [WIRE] and declared[name]["moves"] == "fit_voxels_per_s"
    assert [m["name"] for m in _ORIGINAL_LOAD(WIRE).per_layer] == wire
    assert [m["name"] for m in _ORIGINAL_LOAD(INTERP).per_layer] == [
        "grid_device_ms.interp", "mlp_roofline_pct.interp", "device_idle_pct.interp", "mfu_pct.interp",
        "chunk_host_us.interp", "to_host_ms.interp"]
    e2e = {m["name"]: m for m in spec.load_benchmark()["end_to_end"]}
    assert WIRE in e2e["fit_voxels_per_s"]["workloads"] and INTERP in e2e["interp_voxels_per_s"]["workloads"]


def test_gabor_readers():
    out = _outcome(WIRE_WORK)
    assert _read("gabor_host_us.wire", out) == pytest.approx(1e6 * 9 * 2e-5 / 3)
    assert _read("gabor_host_us.wire", _outcome(WIRE_WORK, host=[])) is None  # the parent's tree
    # the exponential, the reduction and the copy, over 3 steps; not the products nor Adam
    assert _read("gabor_device_ms.wire", out) == pytest.approx(1e3 * (2e-3 + 3e-4 + 1e-4) / 3)
    assert _read("gabor_device_ms.wire", _outcome({})) is None  # another entry's work
    products_s = 4e-3 + 1e-4
    assert _read("mlp_roofline_pct.wire", out) == pytest.approx(100 * WIRE_WORK["mlp"]["least_s"] * 3 / products_s)
    assert _read("mfu_pct.wire", out) == pytest.approx(100 * WIRE_WORK["whole_least_s"] * 3 / 30e-3)


def test_wire_step_is_priced_at_its_published_sizes():
    """1,858,560 rows a step at 1,576,872 product operations a row (8 a
    complex multiply-add, 2 a real one, 4 for the last layer's real part):
    2.93 TFLOP, at 3xTF32's 164.9 TFLOP/s 17.77 ms, which bounds the step;
    the activations' least bytes, 15,928 a row, take 8.84 ms."""
    dims = [3, 181, 181, 181, 1]
    assert roofline_wire.products(1, dims) == 1_576_872
    assert WIRE_WORK["mlp"]["least_s"] == pytest.approx(1_576_872 * 1_858_560 / 164.9e12)
    assert roofline_wire.activations(1, dims)[0] == 15_928
    assert WIRE_WORK["whole_least_s"] == pytest.approx(WIRE_WORK["mlp"]["least_s"])
    assert WIRE_WORK["gabor"]["not_works"] == ["mlp_forward", "mlp_backward", "mlp_dense", "optimizer"]


def test_siren_request_is_priced_at_its_published_sizes():
    """3,717,120 voxels through SIREN 3-256x5-1: 263,168 multiply-adds a
    voxel, 1.956 TFLOP of products, 11.87 ms at 3xTF32, which bounds the
    request."""
    work = interp_siren.request_work(_ORIGINAL_LOAD(INTERP).config, 352 * 352 * 30)
    assert work["mlp"]["least_s"] == pytest.approx(2 * 263_168 * 3_717_120 / roofline_psf.PRODUCT_FLOPS)
    assert work["whole_least_s"] == pytest.approx(work["mlp"]["least_s"])
    out = _outcome(work, units=2)
    assert _read("mlp_roofline_pct.interp", out) == pytest.approx(100 * work["mlp"]["least_s"] * 2 / (4e-3 + 1e-4))
