"""The grid's ``pinned`` transfer on the card: the volume goes to pinned
host memory slab by slab on the device's copy stream while the chunks
compute. Held bit for bit against the device-side volume on the
``fused_grid``, ``separable`` and ``chunked`` routes; each request's array
is its own; under torch.profiler the copies go to pinned memory on a
stream that runs no kernel; ``device_eval_seconds`` copies nothing. Every
test here carries the ``gpu`` marker and skips without a CUDA device: the
copy stream and pinned memory need one. The file imports no JAX (the
card's machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_grid_copy_gpu.py --noconftest -q -p no:cacheprovider
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mri_interpolation_tpu_torch.infer import (ROUTES, TRANSFERS, device_eval_seconds, evaluate_grid, reset_routes,
                                               reset_transfers)
from mri_interpolation_tpu_torch.infer import grid as g
from mri_interpolation_tpu_torch.models import make_hash_mlp

# 3-D, level 2 hashed, F = 2, the fused relu decoder: the fused_grid route
HASHED = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=12, base_resolution=(8, 8, 4),
              finest_resolution=(48, 48, 20), growth="paper", dim_hidden=32, decoder="relu_plain")
# every level dense: the separable route on [0, 1]
DENSE = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23, base_resolution=(8, 8, 4),
             finest_resolution=(48, 48, 20), dim_hidden=32, decoder="norm")
# a hashed level and the BatchNorm decoder with 2 outputs: the chunked route
CHUNKED = {**HASHED, "decoder": "norm", "dim_out": 2}
MODELS = {"fused_grid": HASHED, "separable": DENSE, "chunked": CHUNKED}
# route, grid, lo, chunk size, chunks a slab (None: the module's): padded tails, chunk counts that are not a multiple
# of the slab, a single-chunk grid, one chunk a slab
CASES = {
    "fused_grid_slab3": ("fused_grid", (50, 17, 9), 0.0, 1000, 3),
    "fused_grid_slab1_pm1": ("fused_grid", (31, 23, 7), -1.0, 999, 1),
    "fused_grid_one_chunk": ("fused_grid", (20, 9, 7), 0.0, 1 << 17, None),
    "fused_grid_default": ("fused_grid", (64, 64, 40), 0.0, 1 << 12, None),
    "separable_slab4": ("separable", (40, 33, 9), 0.0, 999, 4),
    "separable_slab1": ("separable", (21, 13, 5), 0.0, 256, 1),
    "chunked_dim2_slab3": ("chunked", (31, 23, 5), 0.0, 500, 3),
    "chunked_dim2_one_chunk": ("chunked", (11, 7, 5), -1.0, 1 << 17, None),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned transfer's copy stream and pinned memory have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _model(route, device, seed=0):
    model = make_hash_mlp(3, seed=seed, device=device, **MODELS[route])
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(seed)
        model.encoder.table.uniform_(-1.0, 1.0, generator=gen)  # a fitted table's scale, not init's 1e-4
    return model


def _slab_chunks(monkeypatch, per_slab, shape, chunk, dim_out):
    if per_slab is not None:
        monkeypatch.setattr(g, "_SLAB_BYTES", per_slab * min(chunk, int(np.prod(shape))) * dim_out * 4)


def _device_ops(prof, tmp_path):
    """The trace's device kernels and copies: (category, name, stream)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["cat"], e["name"], e["args"]["stream"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_pinned_volume_equals_the_device_volume(case, cuda_device, monkeypatch):
    """The returned volume is the device-side volume's copy bit for bit, a
    C-contiguous writable float32 array; the request counts ``pinned``."""
    route, shape, lo, chunk, per_slab = CASES[case]
    model = _model(route, cuda_device)
    _slab_chunks(monkeypatch, per_slab, shape, chunk, model.dim_out)
    with torch.no_grad():
        want = g._grid_on_device(model, shape, lo, 1.0, chunk, cuda_device, None, None, False)[0].cpu().numpy()
    reset_routes()
    reset_transfers()
    got = evaluate_grid(model, shape, lo=lo, chunk_size=chunk, device=cuda_device)
    assert ROUTES[route] == 1 and TRANSFERS == {"pinned": 1, "pageable": 0}
    assert got.shape == (shape if model.dim_out == 1 else shape + (model.dim_out,)) and got.dtype == np.float32
    assert got.flags.c_contiguous and got.flags.writeable and np.isfinite(got).all()
    assert np.array_equal(got, want.reshape(got.shape))


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(MODELS))
def test_each_request_owns_its_array(route, cuda_device, monkeypatch):
    """Two consecutive requests give arrays that share no memory, and the
    first is unchanged by the second; a dropped array's pinned block serves
    the next request once its copies are done."""
    shape, chunk = (40, 33, 9), 1000
    a_model, b_model = _model(route, cuda_device, seed=1), _model(route, cuda_device, seed=2)
    _slab_chunks(monkeypatch, 2, shape, chunk, a_model.dim_out)
    first = evaluate_grid(a_model, shape, chunk_size=chunk, device=cuda_device)
    kept = first.copy()
    second = evaluate_grid(b_model, shape, chunk_size=chunk, device=cuda_device)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept) and not np.array_equal(first, second)
    address = second.ctypes.data
    del second
    torch.cuda.synchronize()
    third = evaluate_grid(b_model, shape, chunk_size=chunk, device=cuda_device)
    assert third.ctypes.data == address
    assert np.array_equal(first, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(MODELS))
def test_a_profiled_request_copies_to_pinned_memory_on_its_own_stream(route, cuda_device, monkeypatch, tmp_path):
    """Under torch.profiler a request's device-to-host copies go to pinned
    memory, one a slab, on a stream that runs none of the kernels; none goes
    to pageable memory."""
    shape, chunk, per_slab = (50, 17, 9), 1000, 3
    model = _model(route, cuda_device)
    _slab_chunks(monkeypatch, per_slab, shape, chunk, model.dim_out)
    evaluate_grid(model, shape, chunk_size=chunk, device=cuda_device)  # builds the kernels, pins a block
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluate_grid(model, shape, chunk_size=chunk, device=cuda_device)
    ops = _device_ops(prof, tmp_path)
    copies = [(name, stream) for cat, name, stream in ops if cat == "gpu_memcpy" and "DtoH" in name]
    kernel_streams = {stream for cat, _, stream in ops if cat == "kernel"}
    n_chunks = -(-int(np.prod(shape)) // chunk)
    assert len(copies) == -(-n_chunks // per_slab), copies
    assert all("Pinned" in name and "Pageable" not in name for name, _ in copies), copies
    assert kernel_streams and not kernel_streams & {stream for _, stream in copies}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(MODELS))
def test_device_eval_seconds_copies_nothing_to_the_host(route, cuda_device, tmp_path):
    """``device_eval_seconds`` times the device side alone: no device-to-host
    copy, and no request counted as a transfer."""
    model = _model(route, cuda_device)
    reset_transfers()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert device_eval_seconds(model, (50, 17, 9), chunk_size=1000, iters=1, device=cuda_device) > 0
    ops = _device_ops(prof, tmp_path)
    assert any(cat == "kernel" for cat, _, _ in ops)
    assert not [name for cat, name, _ in ops if cat == "gpu_memcpy" and "DtoH" in name]
    assert TRANSFERS == {"pinned": 0, "pageable": 0}
