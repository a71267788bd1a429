"""The reference agrees with the port at tiny sizes on the CPU (where the
port runs its kernels' plain versions), and at the cells' full sizes on
the geometry; the data helpers invert each other."""

import numpy as np
import pytest
import torch

from benchmark import data, reference, spec, tiny
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

CELLS = ["full4d.fit", "flagship.interp", "full4d.interp"]
CONFIGS = ["flagship", "full4d"]


def _port_geometry(enc):
    return HashGridEncoding(dim=enc["dim"], n_levels=enc["n_levels"], n_features_per_level=enc["n_features_per_level"],
                            log2_hashmap_size=enc["log2_hashmap_size"], base_resolution=tuple(enc["base_resolution"]),
                            finest_resolution=tuple(enc["finest_resolution"]), growth=enc["growth"])


def _config(name, small):
    cell = spec.load_cell(f"{name}.interp")
    return (tiny.shrink(cell) if small else cell).config


@pytest.mark.parametrize("small", [False, True], ids=["cell", "tiny"])
@pytest.mark.parametrize("name", CONFIGS)
def test_geometry_matches_the_port(name, small):
    enc = _config(name, small)["encoder"]
    grid, port = reference.make_grid(enc), _port_geometry(enc)
    assert [lv.res for lv in grid.levels] == [tuple(r) for r in port.level_resolutions.tolist()]
    assert [lv.dense for lv in grid.levels] == port.level_dense.tolist()
    assert [lv.size for lv in grid.levels] == port.level_sizes.tolist()
    assert grid.rows == port.total_size


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_matches_the_port(name):
    enc = _config(name, True)["encoder"]
    grid, port = reference.make_grid(enc), _port_geometry(enc)
    gen = torch.Generator().manual_seed(5)
    table = torch.rand((grid.rows, grid.n_features), generator=gen) * 2 - 1
    x = torch.rand((777, grid.dim), generator=gen)
    x[0], x[1] = 0.0, 1.0
    ids, w = reference.corners(grid, x)
    pids, pw = port.corner_ids_and_weights(x)
    assert torch.equal(ids, pids) and torch.equal(w, pw)
    torch.testing.assert_close(reference.encode(grid, table, x), he.hash_encode_reference(port, table, x),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", ["flagship.interp", "full4d.interp"])
def test_grid_volume_matches_evaluate_grid(cell):
    c = tiny.tiny_cell(cell)
    shape = tuple(c.workload["grid"])
    weights = data.draw_weights(c.config, 11, "cpu", "served")
    model = spec.model_builder(c.config)(c.config, "cpu")
    model.load_state_dict(weights)
    port = evaluate_grid(model, shape, chunk_size=c.workload["chunk_size"], device="cpu")
    ref = reference.grid_volume(c.config, weights, shape)
    assert reference.volume_gap(torch.from_numpy(port), ref) < 1e-6


def test_fit_steps_match_trainer():
    c = tiny.tiny_cell("full4d.fit")
    cfg = c.config
    vol = data.make_volume(cfg["volume"], 12, "cpu")
    coords, values = data.training_set(vol)
    weights = data.draw_weights(cfg, 12, "cpu", "init")
    model = spec.model_builder(cfg)(cfg, "cpu")
    model.load_state_dict(weights)
    seen = []
    model.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
    tr = cfg["train"]
    n, batch = coords.shape[0], tr["batch_size"]
    res = Trainer(TrainConfig(batch_size=batch, epochs=1, lr=tr["lr"], optimizer=tr["optimizer"],
                              lr_schedule=tr["lr_schedule"], cosine_t_max=tr["cosine_t_max"], seed=12)).fit(
        model, coords.numpy(), values.numpy(), device="cpu")
    steps = n // batch
    ref = reference.fit_steps(cfg, weights, [(x, data.targets(vol, x)) for x in seen], steps)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-6)
    for name, p in model.named_parameters():  # every parameter after the epoch
        change = float(torch.linalg.vector_norm((p.detach() - weights[name]).double()))
        assert change == pytest.approx(ref.change_norms[name], rel=1e-5)


def test_targets_invert_the_training_set():
    vol = data.make_volume([5, 4, 3, 6], 3, "cpu")
    coords, values = data.training_set(vol)
    assert torch.equal(data.targets(vol, coords), values)
    assert float(vol.min()) == 0.0 and float(vol.max()) == 1.0


def test_volume_and_weights_repeat_for_a_seed():
    cfg = _config("full4d", True)
    big = 2**31 + 12345
    assert torch.equal(data.make_volume([4, 4, 3, 3], big, "cpu"), data.make_volume([4, 4, 3, 3], big, "cpu"))
    a, b = data.draw_weights(cfg, big, "cpu", "init"), data.draw_weights(cfg, big, "cpu", "init")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.table"], data.draw_weights(cfg, big + 1, "cpu", "init")["encoder.table"])
