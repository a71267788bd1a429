"""The grid's ``fused_grid`` route on the card: the op
``hash_mlp_grid_forward`` (kernel 1's grid variant, then kernel 5) against
the ``chunked`` route, bit for bit, its launches and its kernels' names.
Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode. The file imports no JAX (the card's machine
has none), so it runs there on its own:

    python -m pytest tests/test_torch_grid_route_gpu.py --noconftest -q -p no:cacheprovider

No tolerance: the two routes run the same kernels on the same coordinates,
so the volumes are equal bit for bit.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import ROUTES, evaluate_grid, flat_index_to_coords, reset_routes
from mri_interpolation_tpu_torch.infer.grid import _grid_on_device
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.ops import fused_mlp as fm
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.tracing import SPANS

# the full-4D recipe's encoder and decoder (benchmark/configs/full4d.json): 5 levels x F = 4, 12,134,251 rows,
# level 4 hashed; relu_plain 20-64-1
FULL4D = dict(n_levels=5, n_features_per_level=4, log2_hashmap_size=23, base_resolution=(64, 64, 2, 3),
              finest_resolution=(352, 352, 6, 15), growth="paper", dim_hidden=64, decoder="relu_plain")
# 3-D, level 2 hashed, F = 2
SMALL3D = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=12, base_resolution=(8, 8, 4),
               finest_resolution=(48, 48, 20), growth="paper", dim_hidden=32, decoder="relu_plain")
# grid, lo, hi, chunk: every case has a padded tail
CASES = {
    "full4d": (4, FULL4D, (45, 37, 6, 15), 0.0, 1.0, 1 << 15),
    "full4d_pm1_size1": (4, FULL4D, (61, 1, 6, 29), -1.0, 1.0, 5000),
    "small3d": (3, SMALL3D, (50, 17, 9), 0.0, 1.0, 4096),
    "small3d_pm1": (3, SMALL3D, (31, 23, 1), -1.0, 1.0, 999),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grid route's kernels have no CPU mode")
    return torch.device("cuda")


def _model(dim, kw, device, seed=0):
    model = make_hash_mlp(dim, seed=seed, device=device, **kw)
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(seed)
        model.encoder.table.uniform_(-1.0, 1.0, generator=gen)  # a fitted table's scale, not init's 1e-4
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_grid_equals_the_chunked_route(case, cuda_device):
    """The volume of the fused route equals the chunked route's bit for bit,
    with one kernel-1 and one kernel-5 launch a chunk."""
    dim, kw, shape, lo, hi, chunk = CASES[case]
    model = _model(dim, kw, cuda_device)
    n_chunks = -(-int(np.prod(shape)) // chunk)
    evaluate_grid(model, shape, lo=lo, hi=hi, chunk_size=chunk, device=cuda_device)  # builds the kernels
    reset_routes()
    he.reset_launches()
    fm.reset_launches()
    fused = evaluate_grid(model, shape, lo=lo, hi=hi, chunk_size=chunk, device=cuda_device)
    assert he.LAUNCHES["hash_encode_forward"] == n_chunks and sum(he.LAUNCHES.values()) == n_chunks
    assert fm.LAUNCHES == {"fused_mlp_forward": n_chunks, "fused_mlp_backward": 0}
    chunked = evaluate_grid(model, shape, lo=lo, hi=hi, chunk_size=chunk, device=cuda_device,
                            transform=lambda x: x)
    assert ROUTES == {"separable": 0, "fused_grid": 1, "chunked": 1}
    assert fused.shape == shape and np.isfinite(fused).all()
    assert np.array_equal(fused, chunked)


# a 4-D grid (strides 231, 33, 11, 1) and chunks of 64 voxels whose first voxel sits just below a carry of each
# digit, below the grid's last voxel (the padded tail), and at 0
BOUNDARY_SHAPE = (5, 7, 3, 11)
BOUNDARY_STARTS = (0, 231 - 30, 2 * 231 - 40, 33 * 4 - 20, 11 * 5 - 3, 1155 - 50)
STAGING = {
    "mixed": dict(dim=4, n_levels=2, n_features_per_level=2, log2_hashmap_size=22, base_resolution=(64, 64, 8, 16),
                  finest_resolution=(512, 512, 40, 88), growth="paper"),
    "hashed": dict(dim=4, n_levels=2, n_features_per_level=4, log2_hashmap_size=12, base_resolution=(64, 64, 8, 16),
                   finest_resolution=(512, 512, 40, 88), growth="paper", storage="hashed"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (-1.0, 1.0), (0.1, 0.7)])
@pytest.mark.parametrize("name", sorted(STAGING))
def test_grid_encode_stages_the_coordinates_of_flat_index_to_coords(name, lo, hi, cuda_device):
    """Kernel 1's grid variant against kernel 1 on ``flat_index_to_coords``'s
    coordinates made on the card, bit for bit, at chunks across the carries
    of the mixed-radix digits and past the last voxel. The finest level has
    512 cells an axis, so a coordinate one float32 step off moves the
    features."""
    enc = HashGridEncoding(**STAGING[name])
    table = torch.empty((enc.total_size, enc.n_features_per_level), device=cuda_device).uniform_(-1.0, 1.0)
    n = int(np.prod(BOUNDARY_SHAPE))
    scratch = torch.empty((64, enc.output_dim), device=cuda_device)
    launch = he.GridEncodeLaunch(enc, table, scratch, BOUNDARY_SHAPE, lo, hi)
    for start in BOUNDARY_STARTS:
        launch.launch(start)
        flat = torch.arange(start, start + 64, device=cuda_device).clamp_(max=n - 1)
        want = he.hash_encode_forward(enc, table, flat_index_to_coords(flat, BOUNDARY_SHAPE, lo, hi))
        assert torch.equal(scratch, want), f"start {start}"


@pytest.mark.gpu
def test_a_profiled_request_runs_the_benchmarks_forward_kernels_alone(cuda_device):
    """Every kernel of a fused-route request maps to the ``hash_forward`` or
    the ``mlp_forward`` work of the benchmark's kernel families, and both
    are there."""
    from benchmark.trace import kernel_families

    dim, kw, shape, lo, hi, chunk = CASES["small3d"]
    model = _model(dim, kw, cuda_device)
    args = (model, shape, lo, hi, chunk, cuda_device, None, None, False)
    _grid_on_device(*args)
    torch.cuda.synchronize()
    reset_routes()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _grid_on_device(*args)
        torch.cuda.synchronize()
    assert ROUTES["fused_grid"] == 1
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in SPANS}  # a span's device shadow
    families = kernel_families()

    def work(name):
        return {w for w, patterns in families.values() if any(p.search(name) for p in patterns)}

    assert names and all(work(name) for name in names), names
    assert set().union(*map(work, names)) == {"hash_forward", "mlp_forward"}, names
