"""The port's spans (``mri_interpolation_tpu_torch.tracing``) on the CPU.

Off, no span enters ``record_function``. Under torch.profiler a fit and a
grid evaluation hold the spans their layers name, as many as the work has
steps, chunks and syncs, nested as ``tracing``'s docstring says; a span
entered before the profiler starts stays off, one open when it stops exits
cleanly; and the profiler changes no loss and no voxel. The last test runs
on the card (marker ``gpu``): one launch span for each launch the ops count.
The file imports no JAX, so it also runs on the card on its own:

    python -m pytest tests/test_torch_tracing.py --noconftest -q -p no:cacheprovider
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.optim.optimizer import register_optimizer_step_post_hook

from mri_interpolation_tpu_torch import tracing
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.models import make_hash_mlp, make_siren
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

PORT_DIR = Path(__file__).resolve().parents[1] / "mri_interpolation_tpu_torch"
TINY = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=8, base_resolution=(2, 2, 2),
            finest_resolution=(6, 6, 6), dim_hidden=8, decoder="relu_plain")
EPOCHS, STEPS, BATCH = 2, 4, 16


def _model(device="cpu", **kw):
    return make_hash_mlp(3, **{**TINY, **kw}, seed=3, device=device)


def _data(n=STEPS * BATCH):
    rng = np.random.default_rng(0)
    return rng.random((n, 3), dtype=np.float32), rng.random((n, 1), dtype=np.float32)


def _fit(model, device="cpu", epochs=EPOCHS):
    coords, values = _data()
    cfg = TrainConfig(batch_size=BATCH, epochs=epochs, lr=1e-2, optimizer="adam_tcnn", lr_schedule="cosine")
    return Trainer(cfg).fit(model, coords, values, device=device)


def _spans(prof, tmp_path):
    """The trace's ``mri.*`` host events, as (name, start µs, end µs,
    thread); with CUDA activity each also has a device-side shadow
    (``gpu_user_annotation``), which is not counted."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("mri.")]


def _names(spans):
    out = {}
    for name, *_ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _inside(spans, outer, name):
    """The ``name`` spans inside ``outer`` on its thread."""
    _, a, b, tid = outer
    return [s for s in spans if s[0] == name and s[3] == tid and a <= s[1] and s[2] <= b]


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof, tmp_path)


def test_every_span_is_named_once_and_used():
    """``SPANS`` lists each name once, under ``mri.``; the package opens a
    span of each name and of no other, always by a constant string."""
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    assert all(name.startswith("mri.") for name in tracing.SPANS)
    used = set()
    for path in PORT_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                assert len(node.args) == 1 and isinstance(node.args[0], ast.Constant), f"{path}:{node.lineno}"
                used.add(node.args[0].value)
    assert used == set(tracing.SPANS)


def test_off_no_span_enters_record_function(monkeypatch):
    """Without a profiler a fit and both grid routes enter no
    ``record_function`` of a span (torch's own, such as the optimizer's,
    are not the port's); under one the same calls do."""
    entered = []
    original = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return original(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)

    def work():
        model = _model()
        _fit(model)
        evaluate_grid(model, (5, 4, 3), chunk_size=16, device="cpu")
        evaluate_grid(model, (5, 4, 3), chunk_size=16, device="cpu", transform=lambda x: x)

    work()
    assert [n for n in entered if n.startswith("mri.")] == []
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    assert {n for n in entered if n.startswith("mri.")} >= {"mri.train.step", "mri.grid.chunk", "mri.grid.encode"}


def test_fit_spans(tmp_path):
    """E epochs of S steps: E x S steps, each with one forward, backward and
    optimizer span inside it, in that order; E shuffles, syncs and hooks."""
    _, spans = _traced(lambda: _fit(_model()), tmp_path)
    counts = _names(spans)
    n = EPOCHS * STEPS
    assert counts["mri.train.step"] == n
    for name in ("mri.train.forward", "mri.train.backward", "mri.train.optimizer"):
        assert counts[name] == n
    for name in ("mri.train.shuffle", "mri.train.sync", "mri.train.hooks"):
        assert counts[name] == EPOCHS
    for step in (s for s in spans if s[0] == "mri.train.step"):
        parts = [_inside(spans, step, name) for name in ("mri.train.forward", "mri.train.backward",
                                                         "mri.train.optimizer")]
        assert [len(p) for p in parts] == [1, 1, 1]
        assert parts[0][0][2] <= parts[1][0][1] and parts[1][0][2] <= parts[2][0][1]
    for name in ("mri.train.shuffle", "mri.train.sync", "mri.train.hooks"):
        assert all(not _inside(spans, s, name) for s in spans if s[0] == "mri.train.step")


def test_streamed_fit_spans(tmp_path):
    """``fit_streaming``: one step span a step and one sync an epoch; the
    wait for a shard is timed by ``TrainResult.shard_wait_s``, not a span."""
    volume = np.random.default_rng(1).random((8, 6, 4), dtype=np.float32)
    cfg = TrainConfig(batch_size=BATCH, epochs=EPOCHS, lr=1e-2)
    shard = 4 * BATCH  # 192 voxels: 3 shards of 4 steps each
    result, spans = _traced(lambda: Trainer(cfg).fit_streaming(_model(), volume, shard_voxels=shard, device="cpu"),
                            tmp_path)
    counts = _names(spans)
    assert len(result.shard_wait_s) == EPOCHS
    assert counts["mri.train.step"] == result.steps == EPOCHS * 12
    assert counts["mri.train.sync"] == EPOCHS
    assert "mri.train.shuffle" not in counts


@pytest.mark.parametrize("transport,latents", [("f32", False), ("u16", False), ("f32", True)])
def test_grid_spans_per_chunk_route(tmp_path, transport, latents):
    """The per-chunk route (here through ``transform``): one request, one
    copy to the host (the latents' too), ceil(n / chunk) chunks inside the
    request and no encode."""
    model, shape, chunk = _model(), (7, 5, 3), 16
    _, spans = _traced(lambda: evaluate_grid(model, shape, chunk_size=chunk, device="cpu", transport=transport,
                                             transform=lambda x: x, return_latents=latents), tmp_path)
    counts = _names(spans)
    assert counts == {"mri.grid.request": 1, "mri.grid.to_host": 1, "mri.grid.chunk": math.ceil(105 / chunk)}
    request = next(s for s in spans if s[0] == "mri.grid.request")
    assert len(_inside(spans, request, "mri.grid.chunk")) == counts["mri.grid.chunk"]
    assert len(_inside(spans, request, "mri.grid.to_host")) == 1


def test_grid_spans_separable_route(tmp_path):
    """The separable route: one encode of the whole grid, then the decoder's
    chunks; a SIREN (no split) takes the per-chunk route with no encode."""
    _, spans = _traced(lambda: evaluate_grid(_model(), (7, 5, 3), chunk_size=16, device="cpu"), tmp_path)
    assert _names(spans) == {"mri.grid.request": 1, "mri.grid.encode": 1, "mri.grid.chunk": 7,
                             "mri.grid.to_host": 1}
    siren = make_siren(3, dim_hidden=8, n_layers=2, device="cpu")
    _, spans = _traced(lambda: evaluate_grid(siren, (7, 5, 3), chunk_size=32, device="cpu"), tmp_path)
    assert _names(spans) == {"mri.grid.request": 1, "mri.grid.chunk": 4, "mri.grid.to_host": 1}


def test_span_entered_before_the_profiler_stays_off(tmp_path):
    early = tracing.span("mri.train.step")
    with early:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("mri.train.forward"):
                torch.ones(4).add_(1)
    assert _names(_spans(prof, tmp_path)) == {"mri.train.forward": 1}


def test_span_open_when_the_profiler_stops_exits_cleanly(tmp_path):
    """The profiler stops inside a span (as the fit entry's tracer does, in an
    optimizer hook): the span exits without error, later spans stay off,
    and the trace reads, with the spans that closed in it."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with tracing.span("mri.train.step"):
        with tracing.span("mri.train.forward"):
            torch.ones(4).add_(1)
        prof.stop()
        with tracing.span("mri.train.optimizer"):
            torch.ones(4).mul_(2)
    counts = _names(_spans(prof, tmp_path))
    assert counts.get("mri.train.forward") == 1 and "mri.train.optimizer" not in counts
    assert counts.get("mri.train.step", 0) <= 1  # torch 2.13 keeps the open span; its end is not the window's


def test_profiler_started_and_stopped_in_optimizer_hooks(tmp_path):
    """The fit entry's traced epoch: the profiler starts after step S and
    stops after step 2S, both inside the optimizer's post-hook, so inside a
    step span. The steps between lie whole in the trace, each with its
    three parts; the step that was open at the start is not in it."""
    model = _model()
    prof = profile(activities=[ProfilerActivity.CPU])
    count = [0]

    def hook(opt, args, kwargs):
        count[0] += 1
        if count[0] == STEPS:
            prof.start()
        elif count[0] == 2 * STEPS:
            prof.stop()

    handle = register_optimizer_step_post_hook(hook)
    try:
        _fit(model, epochs=3)
    finally:
        handle.remove()
    counts = _names(_spans(prof, tmp_path))
    assert counts["mri.train.sync"] == counts["mri.train.shuffle"] == 1  # epoch 0's sync, epoch 1's shuffle
    assert counts["mri.train.forward"] == counts["mri.train.backward"] == STEPS
    assert counts["mri.train.step"] in (STEPS - 1, STEPS)  # the last, open at the stop, may be kept


def test_the_profiler_moves_no_number(tmp_path):
    """Losses and volumes are bitwise the same with the profiler on and off."""
    def run():
        model = _model()
        result = _fit(model)
        return (result.losses, evaluate_grid(model, (7, 5, 3), chunk_size=16, device="cpu"),
                evaluate_grid(model, (7, 5, 3), chunk_size=16, device="cpu", transport="u16",
                              transform=lambda x: x))

    off = run()
    on, spans = _traced(run, tmp_path)
    assert spans
    for a, b in zip(off, on):
        assert np.array_equal(a, b)


@pytest.mark.gpu
def test_one_launch_span_a_counted_launch(tmp_path):
    """On the card, fit steps of a reduced full-4D geometry (its levels, F
    and decoder; a 2^19 table, finest (64, 64, 6, 15), batch 4096) open one
    ``mri.op.launch`` span for each launch the ops count in ``LAUNCHES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mri_interpolation_tpu_torch.ops import fused_mlp as fm
    from mri_interpolation_tpu_torch.ops import hash_encode as he

    model = make_hash_mlp(4, n_levels=5, n_features_per_level=4, log2_hashmap_size=19, base_resolution=(8, 8, 2, 3),
                          finest_resolution=(64, 64, 6, 15), growth="paper", dim_hidden=64, decoder="relu_plain",
                          seed=3, device="cuda")
    rng = np.random.default_rng(0)
    coords, values = rng.random((4 * 4096, 4), dtype=np.float32), rng.random((4 * 4096, 1), dtype=np.float32)
    cfg = TrainConfig(batch_size=4096, epochs=1, lr=1e-2, optimizer="adam_tcnn")
    Trainer(cfg).fit(model, coords, values, device="cuda")  # builds and warms the kernels
    before = sum(he.LAUNCHES.values()) + sum(fm.LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        Trainer(cfg).fit(model, coords, values, device="cuda")
        torch.cuda.synchronize()
    launched = sum(he.LAUNCHES.values()) + sum(fm.LAUNCHES.values()) - before
    counts = _names(_spans(prof, tmp_path))
    assert launched > 0 and counts["mri.op.launch"] == launched
    assert counts["mri.train.step"] == 4 and "mri.op.build" not in counts
