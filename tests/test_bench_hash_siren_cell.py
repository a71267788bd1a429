"""The benchmark's cell ``hash_siren.fit`` on the CPU.

- A whole run of the entry ``fit_hash_siren`` at a tiny size (4 levels of
  a grid that grows by 1.4 from base 4, log2 10, so three dense levels and
  a hashed one; width 16, 2 sine layers and 2 modulator layers; an
  (8, 8, 6) volume, batch 96, 4 steps an epoch; the cell's entry, traffic
  parameters and limits otherwise) reads ``correct`` true, and false with
  a fault planted under the timed path: the program's products in TF32
  (the control), the gates set to 1, the latent zeroed, half of each batch
  left out, and a step that leaves the state unchanged.
- The new readers on a hand-made traced window (``modulator_host_us``,
  ``gate_device_ms``; ``hash_roofline_pct``, ``mlp_roofline_pct``,
  ``mfu_pct`` and ``device_idle_pct`` on the entry's work), and the step's
  least time at a toy shape and at the published sizes.
"""

import copy
import json

import pytest
import torch

from benchmark import reference, reference_hash_siren, roofline, roofline_hash_siren, roofline_psf, run, spec, trace
from benchmark.common import Outcome
from benchmark.entries import fit_hash_siren
from mri_interpolation_tpu_torch.models import core as port_core
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.ops.sine_layer import SineLayer
from mri_interpolation_tpu_torch.train import trainer as port_trainer

CELL = "hash_siren.fit"
_ORIGINAL_LOAD = spec.load_cell
SMALL = {"encoder": {"dim": 3, "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
                     "base_resolution": 4, "per_level_scale": 1.4},
         "siren": {"dim_hidden": 16, "n_layers": 2}, "modulator": {"dim_hidden": 16, "n_layers": 2},
         "volume": [8, 8, 6], "batch_size": 96}


def _shrink(cell):
    cell = copy.deepcopy(cell)
    cell.config["encoder"] = dict(SMALL["encoder"])
    cell.config["siren"].update(SMALL["siren"])
    cell.config["modulator"].update(SMALL["modulator"])
    cell.config["volume"] = list(SMALL["volume"])
    cell.config["train"]["batch_size"] = SMALL["batch_size"]
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
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def _tf32_products(monkeypatch):
    """Every product of both networks takes its operands rounded to TF32:
    the modulator's ``Dense`` layers and the SIREN's products, its sine
    layers still through the program's ``SineLayer``."""
    monkeypatch.setattr(port_core, "dense", lambda w, b, x: reference.matmul(x, w, "tf32") + b)

    def forward(params, x, n_layers, w0, w0_initial, mods=None):
        for i in range(n_layers):
            layer = params["layers"][i]
            x = SineLayer.apply(reference.matmul(x, layer["w"], "tf32"), layer["b"], w0_initial if i == 0 else w0)
            x = x * mods[i]
        return reference.matmul(x, params["last"]["w"], "tf32") + params["last"]["b"]

    monkeypatch.setattr(port_siren, "_sine_layers_forward", forward)


def _gates_one(monkeypatch):
    modulations = port_siren.ModulatedSiren.modulations
    monkeypatch.setattr(port_siren.ModulatedSiren, "modulations",
                        lambda self, lat: [torch.ones_like(m) for m in modulations(self, lat)])


def _latent_zero(monkeypatch):
    latent = port_siren.HashSiren.latent
    monkeypatch.setattr(port_siren.HashSiren, "latent", lambda self, x: latent(self, x) * 0.0)


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


FAULTS = {"tf32_products": _tf32_products, "gates_one": _gates_one, "latent_zero": _latent_zero,
          "half_batch": _half_batch, "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("seed", [2147483659, 40_000_000_003])
def test_hash_siren_fit_unbroken_reads_correct(seed, monkeypatch, capsys):
    result, err = _drive(monkeypatch, capsys, seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "rows_short"}
    assert list(result)[-1] == "checks" and set(result["metrics"]) == {"fit_voxels_per_s", "setup_s"}
    line = next(s for s in err.splitlines() if s.startswith("modulator rows over the window"))
    counted, expected = line.split(": ")[1].split(" (")[0], line.split("= ")[1].rstrip(")")
    assert counted == expected


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_hash_siren_fit_fault_reads_incorrect(fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    result, _ = _drive(monkeypatch, capsys)
    assert not result["correct"], result["checks"]


def test_the_capture_reads_each_step_under_the_references_names():
    config = _shrink(_ORIGINAL_LOAD(CELL)).config
    model = spec.model_builder(config)(config, "cpu")
    capture = fit_hash_siren._StepCapture(model, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for _ in range(3):
        opt.zero_grad()
        model(torch.rand(9, 3)).sum().backward()
        opt.step()
    capture.close()
    names = set(reference_hash_siren.init_params(config, 1))
    assert len(capture.xs) == len(capture.params) == len(capture.grads) == 2
    assert set(capture.params[1]) == set(capture.grads[1]) == set(capture.after) == names
    assert not torch.equal(capture.params[0]["encoder.table"], capture.params[1]["encoder.table"])
    assert capture.reading([1.0]) is None and capture.reading([1.0, 1.0]) is not None


def test_the_model_builder_refuses_a_modulator_the_factory_cannot_build():
    config = _shrink(_ORIGINAL_LOAD(CELL)).config
    config["modulator"]["dim_hidden"] = 8
    with pytest.raises(ValueError, match="modulator"):
        spec.model_builder(config)(config, "cpu")


# ---------------------------------------------------------------------------
# the per-layer readers on a hand-made window: 3 steps of 10 ms


WORK = fit_hash_siren.step_work(_ORIGINAL_LOAD(CELL).config, 4_000_000)
OPS = [("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3", 1.0e-3, 4e-3),
       ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>", 5.0e-3, 2e-3),
       ("void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>", 7.1e-3, 5e-4),
       ("_anonymous_namespace_::sine_layer_forward_kernel<float4, const>", 7.7e-3, 3e-4),
       ("void at::native::CatArrayBatchedCopy<float, unsigned int, 2, 128, 1>", 8.1e-3, 1e-4),
       ("void hash_encode_forward_kernel<3, 2, false>", 8.3e-3, 1e-4),
       ("void hash_encode_table_grad_kernel<3, 2>", 8.5e-3, 2e-4),
       ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>, FusedAdamMathFunctor>", 8.8e-3, 6e-4),
       ("Memcpy DtoH (Device -> Pageable)", 9.6e-3, 1e-4)]
SPANS = [("mri.model.modulator", 1.0e-3 + 1e-2 * i, 3e-5) for i in range(3)]


def _outcome(work, host=SPANS, units=3):
    window = trace.TraceWindow(window_s=30e-3, ops=OPS, host=host, start_s=1.0e-3)
    return Outcome(metrics={}, checks={}, attempted=0, failed=0, memory_peak_bytes=0, trace=window, units=units,
                   work=work)


def _read(name, out):
    return spec.metric_reader(name)(out)


def test_new_metrics_are_declared_for_the_cell_alone():
    declared = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    new = ["modulator_host_us.hsiren", "gate_device_ms.hsiren", "hash_roofline_pct.hsiren",
           "mlp_roofline_pct.hsiren", "mfu_pct.hsiren", "device_idle_pct.hsiren"]
    for name in new:
        assert declared[name]["workloads"] == [CELL] and declared[name]["moves"] == "fit_voxels_per_s"
    # the trainer's and the kernel binding's accepted metrics list the cell too
    shared = ["optimizer_ms.fit", "launches_per_step.fit", "step_host_ms.fit", "optimizer_host_ms.fit",
              "op_host_us.fit"]
    for name in shared:
        assert declared[name]["workloads"] == ["full4d.fit", CELL]
    assert [m["name"] for m in _ORIGINAL_LOAD(CELL).per_layer] == shared + new
    e2e = {m["name"]: m for m in spec.load_benchmark()["end_to_end"]}
    assert CELL in e2e["fit_voxels_per_s"]["workloads"] and CELL not in e2e["interp_voxels_per_s"]["workloads"]


def test_the_readers_on_the_cells_window():
    out = _outcome(WORK)
    assert _read("modulator_host_us.hsiren", out) == pytest.approx(1e6 * 3 * 3e-5 / 3)
    assert _read("modulator_host_us.hsiren", _outcome(WORK, host=[])) is None  # the parent's tree
    # the gate product, the sine layer, the concatenation and the copy, over 3 steps: not the products, kernels
    # 1-2 nor Adam
    assert _read("gate_device_ms.hsiren", out) == pytest.approx(1e3 * (5e-4 + 3e-4 + 1e-4 + 1e-4) / 3)
    assert _read("gate_device_ms.hsiren", _outcome({})) is None  # another entry's work
    assert _read("hash_roofline_pct.hsiren", out) == pytest.approx(100 * WORK["hash"]["least_s"] * 3 / 3e-4)
    assert _read("mlp_roofline_pct.hsiren", out) == pytest.approx(100 * WORK["mlp"]["least_s"] * 3 / 6e-3)
    assert _read("mfu_pct.hsiren", out) == pytest.approx(100 * WORK["whole_least_s"] * 3 / 30e-3)
    assert _read("optimizer_ms.fit", out) == pytest.approx(1e3 * 6e-4 / 3)
    assert _read("optimizer_ms.fit", _outcome({})) is None  # an entry that names no optimizer part
    busy = 4e-3 + 2e-3 + 5e-4 + 3e-4 + 1e-4 + 1e-4 + 2e-4 + 6e-4 + 1e-4
    assert _read("device_idle_pct.hsiren", out) == pytest.approx(100 * (1 - busy / 30e-3))


def test_the_step_is_priced_piece_by_piece_at_a_toy_shape():
    """A 2-layer, width-4 hash SIREN over 2 levels x F = 2 (latent 4), dim_out
    1, on 10 rows touching 7 table rows of 20: each piece's bytes, products
    and other operations by hand, the step the largest of the three over
    their sums."""
    cfg = {"encoder": {"dim": 3, "n_levels": 2, "n_features_per_level": 2, "log2_hashmap_size": 4,
                       "base_resolution": 2, "per_level_scale": 1.5},
           "siren": {"dim_in": 3, "dim_hidden": 4, "n_layers": 2, "dim_out": 1}}
    # SIREN 3*4 + 4*4 + 4*1 = 32 multiply-adds, modulator 4*4 + 8*4 = 48
    assert roofline_hash_siren.macs(cfg) == {"siren": 32, "modulator": 48}
    # forward x W, dW, and dX but the SIREN's first: 2 x (3 x 32 - 12 + 3 x 48) = 456 operations a row
    prods = roofline_hash_siren.products(10, cfg)
    assert prods == (4.0 * 2 * ((12 + 4 + 16 + 4 + 4 + 1) + (16 + 4 + 32 + 4)), 4560, 0.0)
    # a row's coordinates and value read; the activations between layers count no bytes
    elem = roofline_hash_siren.elementwise(10, cfg)
    assert elem == (4.0 * 10 * (3 + 1), 0.0, 10 * 2 * 4 * (6 + 9) + 10 * 6)
    # the 7 touched rows read and the 20-row dense gradient written, F = 2; kernels 1-2's operations
    enc = roofline_hash_siren.hash_encoding(10, cfg, 7, 20)
    assert enc == (4.0 * (7 + 20) * 2, 0.0, 10 * 2 * (roofline.flops_per_point_level(3, 2, False)
                                                    + roofline.flops_per_point_level(3, 2, True)))
    n_params = 20 * 2 + 41 + 56
    assert roofline_hash_siren.n_params(cfg, 20) == n_params
    pieces = roofline_hash_siren.fit_step(10, cfg, 7, 20)
    assert pieces["products"] == pytest.approx(max(prods[0] / 3.35e12, 4560 / 164.9e12))
    assert pieces["hash"] == pytest.approx(roofline.least_s(roofline.hash_forward(10, 3, 2, 2, 7))
                                           + roofline.least_s(roofline.hash_table_grad(10, 3, 2, 2, 7)))
    assert pieces["adam"] == pytest.approx(7 * 4.0 * n_params / 3.35e12)
    nbytes = prods[0] + elem[0] + enc[0] + 7 * 4.0 * n_params
    other = elem[2] + enc[2] + 13.0 * n_params
    assert pieces["whole"] == pytest.approx(max(nbytes / 3.35e12, 4560 / 164.9e12, other / 67e12))
    assert pieces["whole"] < pieces["products"] + pieces["hash"] + pieces["adam"]


def test_the_step_is_priced_at_its_published_sizes():
    """2^18 rows of 566,272 forward multiply-adds (263,168 SIREN, 303,104
    modulator): 3,396,096 product operations a row, 5.40 ms at 3xTF32, which
    set the step's least time; its bytes (Adam's over 12,849,889 parameters
    the most) take 0.14 ms, its other operations 0.09 ms."""
    config = _ORIGINAL_LOAD(CELL).config
    assert roofline_hash_siren.macs(config) == {"siren": 263_168, "modulator": 303_104}
    assert roofline_hash_siren.products(1, config)[1] == 3_396_096
    assert WORK["mlp"]["least_s"] == pytest.approx(3_396_096 * 2**18 / roofline_psf.PRODUCT_FLOPS)
    assert roofline_hash_siren.elementwise(1, config)[0] == 16
    assert roofline_hash_siren.n_params(config, 6_140_528) == 12_849_889
    assert WORK["whole_least_s"] == pytest.approx(3_396_096 * 2**18 / roofline_psf.PRODUCT_FLOPS)
    assert WORK["whole_least_s"] == pytest.approx(5.399e-3, rel=1e-3)
    assert WORK["optimizer"] == {"least_s": pytest.approx(7 * 4 * 12_849_889 / 3.35e12), "works": ["optimizer"]}
    assert WORK["gate"]["not_works"] == ["mlp_forward", "mlp_backward", "mlp_dense", "hash_forward",
                                         "hash_table_grad", "optimizer"]
