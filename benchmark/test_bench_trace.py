"""The reading of a traced window and the per-layer readers, on a
hand-made chrome trace (CPU): the window's bounds, the union of the device
operations, the kernel families, the breakdown and each reader's
arithmetic."""

import json

import pytest

from benchmark import spec, trace
from benchmark.common import Outcome

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 1000.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "void hash_encode_forward_kernel<4, 4>(float const*)", "ts": 1010.0,
     "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void hash_encode_table_grad_kernel<4, 4>(float const*)", "ts": 1015.0,
     "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void multi_tensor_apply_kernel<Adam>", "ts": 1040.0, "dur": 20.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 1090.0, "dur": 20.0},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000.0, "dur": 5.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1020.0, "dur": 30.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 1060.0, "dur": 35.0},
]


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.read_chrome_trace(str(path))


def test_window_and_busy_time(window):
    assert window.window_s == pytest.approx(100e-6)
    assert window.n_ops == 4  # the kernel outside the window is left out
    # [1010, 1025] + [1040, 1060] + [1090, 1100] (the copy clipped at the window's end)
    assert window.busy_s == pytest.approx(45e-6)


def test_kernel_families(window):
    assert window.work_of("void hash_encode_forward_kernel<4, 4>(float const*)") == "hash_forward"
    assert window.work_of("void hash_encode_coarse_forward_kernel<3, 1>()") is None  # no family names it
    assert window.work_of("void hash_encode_table_grad_private_kernel<3, 1>()") == "hash_table_grad"
    assert window.work_of("void (anonymous namespace)::fused_mlp_weight_grad_kernel()") == "mlp_backward"
    assert window.work_s(["hash_forward", "hash_table_grad"]) == pytest.approx(20e-6)
    assert window.work_s(["optimizer"]) == pytest.approx(20e-6)
    assert window.work_s(["mlp_forward"]) == 0.0


def test_breakdown(window):
    b = window.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    gaps = dict(b["idle_gaps"])
    # gaps [1000, 1010] (no host event), [1025, 1040] (aten::copy_), [1060, 1090] (the sync)
    assert gaps == pytest.approx({"cudaStreamSynchronize": 30e-6, "aten::copy_": 15e-6, "(no host event)": 10e-6})


def test_readers(window):
    out = Outcome(metrics={}, checks={}, attempted=0, failed=0, memory_peak_bytes=0, trace=window, units=2,
                  work={"hash": {"least_s": 2e-6, "works": ["hash_forward", "hash_table_grad"]},
                        "mlp": {"least_s": 1e-6, "works": ["mlp_forward"]},
                        "optimizer": {"works": ["optimizer"]}, "whole_least_s": 5e-6})

    def read(name):
        return spec.metric_reader(name)(out)

    assert read("optimizer_ms.fit") == pytest.approx(0.01)
    assert read("launches_per_step.fit") == 2.0
    assert read("grid_device_ms.interp") == pytest.approx(0.0225)
    assert read("hash_roofline_pct.fit") == pytest.approx(20.0)
    assert read("mlp_roofline_pct.interp") is None  # no fused-MLP kernel ran
    assert read("device_idle_pct.fit") == pytest.approx(55.0)
    assert read("mfu_pct.interp") == pytest.approx(10.0)
