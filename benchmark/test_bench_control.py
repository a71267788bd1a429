"""The control reads incorrect: the reference put in the program's place and
computed one precision below the configs' (TF32 products for float32 with
TF32 off) fails at least one of each cell's numbers against its limit, on
three seeds. On the CPU at the tiny sizes of ``tiny.py``; on the card
(marked ``gpu``, skipped without one, decided inside the test) at the
cells' own sizes, the fit on three batches of its own permutation."""

import pytest
import torch

from benchmark import data, reference, spec, tiny
from benchmark.common import strict_fp32

SEEDS = (3, 2**31 + 7, 40_000_000_001)


def _device(where):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(where)


def _cell(name, where):
    cell = spec.load_cell(name)
    return cell if where == "cuda" else tiny.shrink(cell)


def _fit_control(cell, seed, dev):
    cfg = cell.config
    vol = data.make_volume(cfg["volume"], seed, dev)
    coords, _ = data.training_set(vol)
    batch = int(cfg["train"]["batch_size"])
    perm = torch.randperm(len(coords), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    xs = [coords[perm[s * batch:(s + 1) * batch]] for s in range(int(cell.workload["checked_steps"]))]
    spe = len(coords) // batch
    with strict_fp32():
        params = data.draw_weights(cfg, seed, dev, cell.workload["weights"])
        batches = [(x, data.targets(vol, x)) for x in xs]
        ref = reference.fit_steps(cfg, params, batches, spe, "fp32", frozen=data.buffer_names(cfg))
        ctrl = reference.fit_steps(cfg, params, batches, spe, "tf32", frozen=data.buffer_names(cfg))
    return reference.fit_gaps(ctrl, ref)


def _interp_control(cell, seed, dev):
    cfg, wl = cell.config, cell.workload
    with strict_fp32():
        params = data.draw_weights(cfg, seed, dev, wl["weights"])
        ref = reference.grid_volume(cfg, params, wl["grid"])
        ctrl = reference.grid_volume(cfg, params, wl["grid"], precision="tf32")
    return {"volume_gap": reference.volume_gap(ctrl, ref)}


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("name", ["full4d.fit", "flagship.interp", "full4d.interp"])
def test_control_fails_a_limit(name, where):
    dev = _device(where)
    cell = _cell(name, where)
    control = _fit_control if cell.workload["entry"] == "fit" else _interp_control
    for seed in SEEDS:
        readings = control(cell, seed, dev)
        over = {k: v for k, v in readings.items() if v > cell.workload["limits"][k]}
        assert over, (seed, readings, cell.workload["limits"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-10), 3.0e-30])
    r = reference.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0 + 2**-10 and r[3] == -(1.0 + 2**-10)
    assert abs(float(r[4]) - 3.0e-30) <= 3.0e-30 * 2**-11
