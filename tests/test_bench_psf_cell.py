"""The benchmark's cell ``psf_siren.fit`` on the CPU.

- A whole run of the entry ``fit_psf`` at a tiny size (width 16, 2 sine
  layers, 3^3 PSF points, a (6, 6, 4) volume, batch 16; the cell's entry,
  traffic parameters and limits otherwise) reads ``correct`` true, and
  false with a fault planted under the timed path: the program's products
  in TF32 (the control), the PSF cut to its centre point, uniform PSF
  weights, and a step that leaves the state unchanged.
- The new per-layer readers on a hand-made traced window: ``psf_host_us``,
  ``psf_device_ms``, and ``mlp_roofline_pct`` and ``mfu_pct`` on the
  entry's ``step_work``; and ``kernels/dense_products.json`` leaves every
  metric of the other cells as it read without it, on the same window.
"""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import reference, roofline_psf, run, spec, trace
from benchmark.common import Outcome
from benchmark.entries import fit_psf
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.ops.sine_layer import SineLayer
from mri_interpolation_tpu_torch.train import trainer as port_trainer

CELL = "psf_siren.fit"
_ORIGINAL_LOAD = spec.load_cell


def _shrink(cell):
    cell = copy.deepcopy(cell)
    cell.config["siren"].update(dim_hidden=16, n_layers=2)
    cell.config["psf"]["n_sample"] = 3
    cell.config["volume"] = [6, 6, 4]
    cell.config["train"]["batch_size"] = 16
    return cell


def _drive(monkeypatch, capsys, seed=2147483659):
    """A whole tiny run; the check that the run loads no JAX counts what
    the run loads beyond what the test process (whose conftest imports
    JAX) held before it."""
    monkeypatch.setattr(spec, "load_cell", lambda name, root=spec.ROOT: _shrink(_ORIGINAL_LOAD(name, root)))
    monkeypatch.setattr(run, "require_chips", lambda n: torch.device("cpu"))
    held = set(run.loaded_forbidden())
    loaded = run.loaded_forbidden
    monkeypatch.setattr(run, "loaded_forbidden", lambda: sorted(set(loaded()) - held))
    assert run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tf32_products(monkeypatch):
    """Every SIREN layer of the program takes its operands rounded to TF32:
    the PSF SIREN's forward with each product in TF32, its sine layers
    still through the program's ``SineLayer``."""

    def forward(params, x, n_layers, w0, w0_initial):
        for i in range(n_layers):
            layer = params["layers"][i]
            x = SineLayer.apply(reference.matmul(x, layer["w"], "tf32"), layer["b"], w0_initial if i == 0 else w0)
        return reference.matmul(x, params["last"]["w"], "tf32") + params["last"]["b"]

    monkeypatch.setattr(port_siren, "_sine_layers_forward", forward)


def _psf_points(kind):
    original = port_siren.psf_offsets_and_weights

    def plant(monkeypatch):
        def points(spacing, n_sample=5):
            offsets, weights = original(spacing, n_sample)
            if kind == "centre":
                return offsets[len(offsets) // 2:len(offsets) // 2 + 1], np.ones(1, np.float32)
            return offsets, np.full_like(weights, 1.0 / len(weights))

        monkeypatch.setattr(port_siren, "psf_offsets_and_weights", points)

    return plant


def _state_unchanged(monkeypatch):
    step = port_trainer._Updates.step

    def frozen(self):
        held = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, h in zip(self.params, held):
                p.copy_(h)

    monkeypatch.setattr(port_trainer._Updates, "step", frozen)


FAULTS = {"tf32_products": _tf32_products, "psf_centre_only": _psf_points("centre"),
          "psf_uniform_weights": _psf_points("uniform"), "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("seed", [2147483659, 40_000_000_003])
def test_unbroken_reads_correct(seed, monkeypatch, capsys):
    result = _drive(monkeypatch, capsys, seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "rows_short"}
    assert list(result)[-1] == "checks" and set(result["metrics"]) == {"fit_voxels_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    result = _drive(monkeypatch, capsys)
    assert not result["correct"], result["checks"]


def test_centres_are_caught_at_the_loss_hook():
    """The capture keeps the B voxel centres of each of its first k steps
    (not the B x K rows the forward sees) and gives the hook back."""
    config = _shrink(_ORIGINAL_LOAD(CELL)).config
    model = spec.model_builder(config)(config, "cpu")
    hook = model.loss
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    capture = fit_psf._CentreCapture(model, start, 2)
    x, y = torch.rand(5, 3) * 2 - 1, torch.rand(5, 1)
    for _ in range(3):
        model.loss(x, y)
    capture.close()
    assert [tuple(t.shape) for t in capture.xs] == [(5, 3), (5, 3)]
    assert model.loss == hook


# ---------------------------------------------------------------------------
# the per-layer readers on a hand-made window: 3 steps of 10 ms


PSF_WORK = fit_psf.step_work(_ORIGINAL_LOAD(CELL).config)
OPS = [("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", 1.0e-3, 4e-3),
       ("cutlass_80_simt_sgemm_128x64_8x5_nt_align1", 5.0e-3, 2e-3),
       ("void gemv2T_kernel_val<int, int, float>", 7.2e-3, 1e-4),
       ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", 7.4e-3, 1e-4),
       ("void at::native::vectorized_elementwise_kernel<4, sin_kernel_cuda>", 7.6e-3, 5e-4),
       ("void at::native::reduce_kernel<512, 1, ReduceOp<float, func_wrapper_t<float, sum_functor>>>", 8.2e-3, 3e-4),
       ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>, FusedAdamMathFunctor>", 8.6e-3, 6e-4),
       ("fused_mlp_forward_kernel<0>", 9.3e-3, 2e-4), ("hash_encode_forward_kernel<4, 4, false>", 9.6e-3, 1e-4),
       ("Memcpy DtoH (Device -> Pageable)", 9.8e-3, 1e-4)]
SPANS = [(name, 1.0e-3 + 1e-2 * i + off, dur) for i in range(3)
         for name, off, dur in (("mri.model.psf_expand", 1e-4, 2e-5), ("mri.model.psf_integrate", 5e-3, 4e-5))]


def _window(ops, host, families=None):
    window = trace.TraceWindow(window_s=30e-3, ops=ops, host=host, start_s=1.0e-3)
    if families is not None:
        window.families = families
    return window


def _outcome(window, work, units=3):
    return Outcome(metrics={}, checks={}, attempted=0, failed=0, memory_peak_bytes=0, trace=window, units=units,
                   work=work)


def _read(name, out):
    return spec.metric_reader(name)(out)


def test_new_metrics_are_declared_for_the_cell_alone():
    declared = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in ("psf_host_us.psf", "psf_device_ms.psf", "mlp_roofline_pct.psf", "mfu_pct.psf",
                 "device_idle_pct.psf"):
        assert declared[name]["workloads"] == [CELL] and declared[name]["moves"] == "fit_voxels_per_s"
    assert [m["name"] for m in _ORIGINAL_LOAD(CELL).per_layer] == [
        "psf_host_us.psf", "psf_device_ms.psf", "mlp_roofline_pct.psf", "mfu_pct.psf", "device_idle_pct.psf"]


def test_psf_host_us_sums_the_two_spans_means():
    out = _outcome(_window(OPS, SPANS), PSF_WORK)
    assert _read("psf_host_us.psf", out) == pytest.approx(60.0)
    assert _read("psf_host_us.psf", _outcome(_window(OPS, SPANS[::2]), PSF_WORK)) is None  # one span missing
    assert _read("psf_host_us.psf", _outcome(_window(OPS, []), PSF_WORK)) is None  # the parent's tree


def test_psf_device_ms_reads_everything_but_products_and_adam():
    out = _outcome(_window(OPS, SPANS), PSF_WORK)
    # the sine, the reduction, kernel 1 and the copy, over 3 steps; not the products nor Adam
    assert _read("psf_device_ms.psf", out) == pytest.approx(1e3 * (5e-4 + 3e-4 + 1e-4 + 1e-4) / 3)
    assert _read("psf_device_ms.psf", _outcome(_window(OPS, SPANS), {})) is None  # another entry's work


def test_product_roofline_counts_cublas_and_the_fused_kernels_alike():
    out = _outcome(_window(OPS, SPANS), PSF_WORK)
    products_s = 4e-3 + 2e-3 + 1e-4 + 1e-4 + 2e-4  # the dense family and kernel 5
    assert _read("mlp_roofline_pct.psf", out) == pytest.approx(100 * PSF_WORK["mlp"]["least_s"] * 3 / products_s)
    assert _read("mfu_pct.psf", out) == pytest.approx(100 * PSF_WORK["whole_least_s"] * 3 / 30e-3)
    assert _read("device_idle_pct.psf", out) == pytest.approx(100 * (1 - out.trace.busy_s / 30e-3))


def test_psf_step_is_priced_at_its_published_sizes():
    """512,000 rows a step: 807.67 GFLOP of products, at 3xTF32's 164.9
    TFLOP/s a least time of 4.898 ms; the whole step is bound by them."""
    dims = [3, 256, 256, 256, 256, 256, 1]
    assert roofline_psf.siren_products(4096 * 125, dims) == 807_665_664_000
    assert PSF_WORK["mlp"]["least_s"] == pytest.approx(807_665_664_000 / 164.9e12)
    assert PSF_WORK["mlp"]["least_s"] <= PSF_WORK["whole_least_s"] <= 1.001 * PSF_WORK["mlp"]["least_s"]
    # the least time is the largest of the three rates' times, never their sum
    assert roofline_psf.least_s((3.35e12, 164.9e12, 67e12)) == pytest.approx(1.0)


OLD_WORK = {  # the parts the entries "fit" and "interp" give, with their works
    "hash": {"least_s": 2e-4, "works": ["hash_forward", "hash_table_grad"]},
    "mlp": {"least_s": 1e-4, "works": ["mlp_forward", "mlp_backward"]},
    "optimizer": {"works": ["optimizer"]}, "whole_least_s": 5e-4}


def test_dense_products_leave_every_other_cell_as_it_read():
    families = trace.kernel_families()
    assert families["dense_products"][0] == "mlp_dense"
    without = {k: v for k, v in families.items() if k != "dense_products"}
    host = SPANS + [("mri.train.step", 2e-3, 3e-3), ("mri.train.optimizer", 4e-3, 1e-3),
                    ("mri_torch::fused_mlp_forward", 5e-3, 1e-4), ("mri.grid.chunk", 6e-3, 2e-4),
                    ("mri.grid.to_host", 7e-3, 1e-3)]
    others = [m["name"] for m in spec.load_benchmark()["per_layer"] if CELL not in m["workloads"]]
    assert len(others) == 28
    for name in others:
        with_dense = _read(name, _outcome(_window(OPS, host), OLD_WORK))
        assert with_dense == _read(name, _outcome(_window(OPS, host, without), OLD_WORK)), name
    for name, _, _ in OPS[:4]:
        assert trace.TraceWindow(1.0, [], []).work_of(name) == "mlp_dense", name
    for name, _, _ in OPS[4:]:
        assert trace.TraceWindow(1.0, [], []).work_of(name) != "mlp_dense", name
