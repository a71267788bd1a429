"""The counts of ``roofline.py`` against hand-worked cases, on the CPU."""

import pytest
import torch

from benchmark import reference, roofline

FULL4D = {"dim": 4, "n_levels": 5, "n_features_per_level": 4, "log2_hashmap_size": 23,
          "base_resolution": [64, 64, 2, 3], "finest_resolution": [352, 352, 6, 15], "growth": "paper"}


def test_least_time_is_the_larger_bound():
    assert roofline.least_s((3.35e12, 0.0)) == pytest.approx(1.0)
    assert roofline.least_s((0.0, 67e12)) == pytest.approx(1.0)
    assert roofline.least_s((3.35e9, 67e12)) == pytest.approx(1.0)


def test_flops_per_point_level():
    # d = 4, F = 4: 8 (scale, fraction) + 16 * 3 + 4 (weights) + 4 * 31 (sums) = 184; grad: 8 + 52 + 128 = 188
    assert roofline.flops_per_point_level(4, 4, False) == 184
    assert roofline.flops_per_point_level(4, 4, True) == 188
    # d = 3, F = 1: 6 + 8 * 2 + 3 + 15 = 40
    assert roofline.flops_per_point_level(3, 1, False) == 40


def test_adam_over_the_full4d_recipe():
    grid = reference.make_grid(FULL4D)
    n_params = grid.rows * 4 + roofline.mlp_params([20, 64, 1])
    assert grid.rows == 12_134_251 and n_params == 48_538_413
    nbytes, flops = roofline.adam(n_params)
    assert nbytes == pytest.approx(1.359e9, rel=1e-3)  # 7 x 4 B x 48.5 M
    assert roofline.least_s((nbytes, flops)) == pytest.approx(1.359e9 / 3.35e12, rel=1e-3)  # 0.406 ms


def test_mlp_counts():
    # relu 20 -> 64 -> 1: 1,344 multiply-adds a row, 1,409 parameters
    assert roofline.mlp_macs([20, 64, 1]) == 1344 and roofline.mlp_params([20, 64, 1]) == 1409
    nbytes, flops = roofline.mlp_forward(1000, [20, 64, 1], ["relu", "id"])
    assert nbytes == 4.0 * (1000 * 20 + 1409 + 1000)
    assert flops == 1000 * (2 * 1344 + 2 * 64 + 1)
    nbytes, flops = roofline.mlp_train(1000, [20, 64, 1], ["relu", "id"])
    assert nbytes == 4.0 * (2 * 1000 * 20 + 2 * 1000 + 2 * 1409)
    assert flops == 1000 * (6 * 1344 + 4 * 64 + 1)


def test_fit_step_sums_its_parts():
    # batch 10, 2-D, one level of F = 1 touching 7 of 9 rows, a 2 -> 2 -> 1 relu decoder
    step = roofline.fit_step(10, 2, 1, 1, 7, 9, [1, 2, 1], ["relu", "id"], 9 + 7)
    nbytes = 4.0 * (10 * 3 + 7 + 9 + 2 * 7) + 28 * 16
    flops = 10 * (roofline.flops_per_point_level(2, 1, False) + roofline.flops_per_point_level(2, 1, True)) \
        + 10 * (6 * 4 + 4 * 2 + 1) + 40 + 13 * 16
    assert step == (nbytes, flops)


def test_kernel_bounds_at_full4d_from_perf_md():
    """PERF.md's kernel table: kernel 1's bound 11.2 / 22.5 us and kernel 2's
    21.0 / 41.1 us on the full-4D encoder at N = 50,000 / 131,072, x drawn as
    ``chip_smoke.check_full4d_hash_kernels`` draws it (the touched rows
    counted here by the reference's corners)."""
    grid = reference.make_grid(FULL4D)
    gen = torch.Generator().manual_seed(14)
    torch.rand((grid.rows, 4), generator=gen)  # the table: only the generator's state matters here
    bounds = []
    for n in (50_000, 1 << 17):
        x = torch.rand((n, 4), generator=gen)
        x[0], x[1] = 0.0, 1.0
        torch.randn((n, 20), generator=gen)
        touched = reference.touched_rows(grid, x)
        bounds.append((roofline.least_s(roofline.hash_forward(n, 4, 5, 4, touched)),
                       roofline.least_s(roofline.hash_table_grad(n, 4, 5, 4, touched))))
    # PERF.md prints them to 0.1 us (22.45 as 22.5)
    for got, table in zip([b for pair in bounds for b in pair], (11.2, 21.0, 22.5, 41.1)):
        assert abs(got * 1e6 - table) <= 0.06
