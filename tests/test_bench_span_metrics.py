"""The benchmark's readers of the port's host spans (``benchmark/spans.py``
and the six metrics on it), on the CPU: each on a hand-made traced window
gives its value in its unit (the mean wall of its span; for ``op_host_us``
the ops' host time over the units traced), and nothing without its span; a
span across the window's edges is not counted in a mean and is clipped in
a total; and on a real CPU trace of a tiny fit and grid evaluation every
reader finds its span."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans, spec, trace
from benchmark.common import Outcome
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

# metric: (the host events it reads, seconds to its unit); the windows below
# hold 3 units, so op_host_us's total over them equals the mean a call
METRICS = {
    "step_host_ms.fit": ("mri.train.step", 1e3),
    "optimizer_host_ms.fit": ("mri.train.optimizer", 1e3),
    "op_host_us.fit": ("mri_torch::fused_mlp_forward", 1e6),
    "op_host_us.interp": ("mri_torch::hash_encode_forward", 1e6),
    "chunk_host_us.interp": ("mri.grid.chunk", 1e6),
    "to_host_ms.interp": ("mri.grid.to_host", 1e3),
}
OTHERS = [("aten::empty", 1.0e-3, 1e-6), ("mri.grid.request", 1.0e-3, 9e-3), ("cudaLaunchKernel", 2.0e-3, 4e-6)]


def _outcome(host, start=1.0e-3, width=10e-3):
    window = trace.TraceWindow(window_s=width, ops=[("kernel", start, 1e-6)], host=host, start_s=start)
    return Outcome(metrics={}, checks={}, attempted=0, failed=0, memory_peak_bytes=0, trace=window, units=3)


def _read(name, out):
    return spec.metric_reader(name)(out)


def test_every_span_metric_is_declared():
    declared = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in METRICS:
        assert declared[name]["source"] == "device_trace"
        assert declared[name]["unit"] == ("ms" if METRICS[name][1] == 1e3 else "us")


@pytest.mark.parametrize("name", METRICS)
def test_reader_gives_the_mean_wall_in_its_unit(name):
    event, scale = METRICS[name]
    host = OTHERS + [(event, 2.0e-3, 1e-4), (event, 3.0e-3, 3e-4), (event, 5.0e-3, 2e-4)]
    assert _read(name, _outcome(host)) == pytest.approx(2e-4 * scale)


@pytest.mark.parametrize("name", METRICS)
def test_reader_gives_nothing_without_its_span(name):
    """The parent's tree, or a cell that runs no such layer: None, not 0."""
    assert _read(name, _outcome(OTHERS)) is None
    assert _read(name, _outcome([])) is None


def test_spans_across_the_window_edges_are_not_counted():
    """A step open when the window opened (entered before the profiler
    started) or when it closed (exited after the profiler stopped) has no
    wall inside the window."""
    host = [("mri.train.step", 0.5e-3, 1e-3),  # starts before the window
            ("mri.train.step", 2.0e-3, 2e-3),
            ("mri.train.step", 10.5e-3, 1e-3)]  # ends after it
    out = _outcome(host)
    assert spans.mean_wall_s(out.trace, "mri.train.step") == pytest.approx(2e-3)
    assert spans.mean_wall_s(out.trace, "mri.train") is None  # a name, not a prefix
    assert spans.mean_wall_s(out.trace, "mri.train", prefix=True) == pytest.approx(2e-3)


def test_total_wall_clips_to_the_window_and_counts_nested_events_once():
    host = [("mri_torch::a", 0.5e-3, 1e-3),  # 0.5 ms of it inside the window
            ("mri_torch::b", 2.0e-3, 2e-3),
            ("mri_torch::c", 2.5e-3, 1e-3),  # nested in b
            ("mri_torch::d", 10.5e-3, 1e-3)]  # 0.5 ms inside
    out = _outcome(host)
    assert spans.total_wall_s(out.trace, "mri_torch::", prefix=True) == pytest.approx(3e-3)
    assert spans.total_wall_s(out.trace, "mri_torch::b") == pytest.approx(2e-3)
    assert spans.total_wall_s(out.trace, "mri_torch::") is None  # a prefix, not a name
    assert spans.total_wall_s(_outcome([("mri_torch::a", 20e-3, 1e-3)]).trace, "mri_torch::a") is None


def test_op_host_us_reads_a_fused_op_as_a_gain():
    """Per unit of work, not per call: dropping a cheap op lowers the
    reading, where a mean a call would rise."""
    ops = [("mri_torch::fused_mlp_backward", 2.0e-3, 6e-4), ("mri_torch::hash_encode_forward", 3.0e-3, 1e-4),
           ("mri_torch::fused_mlp_forward", 4.0e-3, 1e-4)]
    before, after = _read("op_host_us.fit", _outcome(ops)), _read("op_host_us.fit", _outcome(ops[:2]))
    assert before == pytest.approx(8e-4 / 3 * 1e6) and after == pytest.approx(7e-4 / 3 * 1e6)
    out = _outcome(ops)
    out.units = 0
    assert _read("op_host_us.fit", out) is None


def test_readers_on_a_cpu_trace(tmp_path):
    """A tiny fit and two grid requests (the per-chunk route) under the
    profiler, the window marked as the benchmark's ``Tracer`` marks it: the
    six readers each find their spans, the ops' events included (the CPU
    impls are dispatched as on the card)."""
    model = make_hash_mlp(3, n_levels=2, n_features_per_level=2, log2_hashmap_size=8, base_resolution=(2, 2, 2),
                          finest_resolution=(6, 6, 6), dim_hidden=8, decoder="relu_plain", seed=1, device="cpu")
    rng = np.random.default_rng(0)
    coords, values = rng.random((64, 3), dtype=np.float32), rng.random((64, 1), dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            Trainer(TrainConfig(batch_size=16, epochs=1, lr=1e-2)).fit(model, coords, values, device="cpu")
            for _ in range(2):
                evaluate_grid(model, (7, 5, 3), chunk_size=32, device="cpu", transform=lambda x: x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = _outcome([])
    out.trace = trace.read_chrome_trace(str(path))
    names = {h[0] for h in out.trace.host}
    assert {"mri.train.step", "mri.grid.chunk", "mri_torch::hash_encode_forward"} <= names
    for name in METRICS:
        value = _read(name, out)
        assert value is not None and value > 0, name
    assert json.loads(path.read_text())["traceEvents"]
