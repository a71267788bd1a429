"""The port's hash SIREN (``make_hash_siren``) against the benchmark's plain
reference (``benchmark/reference_hash_siren.py``), on the CPU at a small
size (4 levels growing by 1.4 from base 4 under log2 10: three dense levels
and a hashed one; width 16, 2 sine layers and 2 modulator layers; w0 30;
coordinates in [0, 1]) on seeded weights: the draws and the geometry, the
forward, the loss and every leaf's gradient (the table included), three
steps of ``Trainer.fit`` (each held to the reference from the state the
fit reached, and the whole path against the reference's own), and the
planted faults (the TF32 control, the gates set to 1, the latent zeroed),
each of which misses the tolerances. Beside them: the modulated and hash
SIRENs through the sine-layer pair equal the unfused ``siren_layer_apply``
chain bit for bit; ``MODULATOR_ROWS`` counts rows x modulator layers and
the span ``mri.model.modulator`` opens once a forward; leading dimensions
are taken as rows; a width the sine-layer kernels cannot take is refused
on the card alone; the reference and its roofline import nothing of the
port or of JAX.

Tolerances, each with its reason. On the CPU the port's encoder is the
hash-encode kernels' plain version, which takes the reference's corners,
weights and sums in the same order, and both networks are the same float32
products and elementwise operations in the same order (the sine layers'
plain version repeats autograd's chain): the forward, the loss and the
gradients read equal bit for bit (0.0) on every seed tried. The tolerances
leave room for a float32 summation order that a later torch may change:
1e-6 relative on the forward and the loss, 1e-5 on a leaf's gradient (its
norm of the difference over its norm: the table's sums of a few weighted
cotangents, a sine layer at w0 30 multiplying a product's rounding by 30),
and on the steps the cell's own numbers at 1e-6, 1e-5 and 1e-5 (Adam
replayed over the fit's gradients against torch's foreach Adam: 1.7e-7
read). The TF32 control misses the gradients' tolerance by more than a
factor of 10, so that it binds; the gates set to 1 and the latent zeroed
leave whole leaves without their gradient.
"""

import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import reference_hash_siren
from benchmark.entries import fit_hash_siren
from mri_interpolation_tpu_torch.encodings.hashgrid import HashGridEncoding
from mri_interpolation_tpu_torch.models import make_hash_siren, make_modulated_siren, make_siren
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

BENCH = Path(reference_hash_siren.__file__).resolve().parent
ENC = {"dim": 3, "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10, "base_resolution": 4,
       "per_level_scale": 1.4}
CFG = {"encoder": ENC, "siren": {"dim_in": 3, "dim_hidden": 16, "n_layers": 2, "dim_out": 1, "w0": 30.0,
                                 "w0_initial": 30.0, "sigma": 6.0},
       "modulator": {"n_layers": 2, "dim_hidden": 16, "activation": "relu"}, "volume": [8, 8, 6],
       "train": {"batch_size": 96, "lr": 1e-4, "optimizer": "adam", "lr_schedule": None}}
SEED = 2**31 + 41
FWD_RTOL, GRAD_RTOL, CHANGE_RTOL = 1e-6, 1e-5, 1e-5
TABLE_SCALES = [1.0, 1000.0]  # the factory's U(-1e-4, 1e-4), and U(-0.1, 0.1): features that move the gates


def _model(seed=SEED):
    s = CFG["siren"]
    return make_hash_siren(3, dim_hidden=s["dim_hidden"], n_layers=s["n_layers"], w0=s["w0"],
                           w0_initial=s["w0_initial"], sigma=s["sigma"], n_levels=ENC["n_levels"],
                           n_features_per_level=ENC["n_features_per_level"],
                           log2_hashmap_size=ENC["log2_hashmap_size"], base_resolution=ENC["base_resolution"],
                           per_level_scale=ENC["per_level_scale"], seed=seed, device="cpu")


def _pair(table_scale=1.0):
    """The port's model and the reference's parameters, the table scaled alike."""
    model, params = _model(), reference_hash_siren.init_params(CFG, SEED)
    params["encoder.table"] = params["encoder.table"] * table_scale
    model.load_state_dict(params)
    return model, params


def _rows(n=300, seed=3):
    return torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))


def _volume():
    """The (8, 8, 6) grid on [0, 1] and a smooth volume's values on it."""
    axes = [torch.linspace(0.0, 1.0, s) for s in CFG["volume"]]
    x = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    y = (0.5 + 0.4 * torch.sin(5.0 * x[:, :1]) * torch.cos(4.0 * x[:, 1:2] + 2.0 * x[:, 2:])).contiguous()
    return x, y


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def test_factory_draws_what_the_reference_draws():
    params = reference_hash_siren.init_params(CFG, SEED)
    state = _model().state_dict()
    assert set(state) == set(params) and "encoder.table" in state and "modulator.1.w" in state
    for name, t in params.items():
        assert torch.equal(state[name], t), name
    assert params["modulator.0.w"].shape == (8, 16) and params["modulator.1.w"].shape == (24, 16)


@pytest.mark.parametrize("enc", [ENC, {**ENC, "n_levels": 16, "log2_hashmap_size": 19, "base_resolution": 16}],
                         ids=["small", "published"])
def test_the_references_grid_is_the_ports(enc):
    grid = reference_hash_siren.make_grid({"encoder": enc})
    port = HashGridEncoding(dim=3, n_levels=enc["n_levels"], n_features_per_level=2,
                            log2_hashmap_size=enc["log2_hashmap_size"], base_resolution=enc["base_resolution"],
                            finest_resolution=None, per_level_scale=enc["per_level_scale"])
    assert [lv.res for lv in grid.levels] == [tuple(int(r) for r in res) for res in port.level_resolutions]
    assert [lv.dense for lv in grid.levels] == list(port.level_dense)
    assert [lv.offset for lv in grid.levels] == list(port.level_offsets[:-1]) and grid.rows == port.total_size


def test_published_widths_and_parameter_count():
    """16 levels x F = 2 (6,140,528 rows, levels 0-4 dense), the modulator
    32 -> 256 then 288 -> 256 four times, the SIREN 3 -> 256 x 5 -> 1:
    12,849,889 parameters."""
    model = make_hash_siren(3, dim_hidden=256, n_layers=5, device="cpu")
    geometry = model.encoder.geometry
    assert geometry.total_size == 6_140_528 and list(geometry.level_dense) == [True] * 5 + [False] * 11
    assert [layer.w.shape[0] for layer in model.modulator] == [32, 288, 288, 288, 288]
    assert sum(p.numel() for p in model.modulator.parameters()) == 304_384
    assert sum(p.numel() for p in model.siren.parameters()) == 264_449
    assert sum(p.numel() for p in model.parameters()) == 12_849_889


@pytest.mark.parametrize("table_scale", TABLE_SCALES)
def test_forward_loss_and_every_gradient_equal_the_reference(table_scale):
    model, params = _pair(table_scale)
    x, y = _rows(), torch.rand((300, 1), generator=torch.Generator().manual_seed(4))
    got = model(x)
    grid = reference_hash_siren.make_grid(CFG)
    want = reference_hash_siren.forward(CFG, grid, params, x)
    assert got.shape == (300, 1) and _rel(got.detach(), want) <= FWD_RTOL
    loss = torch.mean((got - y) ** 2)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    ref_loss, ref_grads = reference_hash_siren.loss_and_grads(CFG, grid, leaves, sorted(leaves), x, y, block=70)
    assert abs(float(loss.detach()) - ref_loss) <= FWD_RTOL * ref_loss
    for name, g in zip(sorted(leaves), ref_grads):
        assert float(torch.linalg.vector_norm(g)) > 0, name
        assert _rel(grads[name], g) <= GRAD_RTOL, name


def _fit_program(steps=3, table_scale=1.0):
    """``steps`` steps of ``Trainer.fit`` at batch 96 on the (8, 8, 6) grid,
    read by the benchmark's capture: the inputs fed, and each step's loss,
    starting parameters and gradient fed Adam, then the parameters and
    Adam's first moment."""
    model, _ = _pair(table_scale)
    x, y = _volume()
    capture = fit_hash_siren._StepCapture(model, steps)
    cfg = TrainConfig(batch_size=CFG["train"]["batch_size"], epochs=1, lr=CFG["train"]["lr"], seed=5)
    try:
        result = Trainer(cfg).fit(model, x.numpy(), y.numpy(), device="cpu")
    finally:
        capture.close()
    return capture.xs, capture.reading([float(v) for v in result.losses[:steps]])


def _batches(xs):
    """Each input row's value, looked up by its grid digits."""
    _, y = _volume()
    out = []
    for xb in xs:
        flat = torch.zeros(len(xb), dtype=torch.int64)
        for k, s in enumerate(CFG["volume"]):
            flat = flat * s + torch.round(xb[:, k].double() * (s - 1)).to(torch.int64)
        out.append((xb, y[flat]))
    return out


@pytest.mark.parametrize("table_scale", TABLE_SCALES)
def test_three_adam_steps_equal_the_reference(table_scale):
    """Each step against the reference from the state the port reached
    (``step_gaps``), and the port's whole path of three steps against the
    reference's own from the same weights."""
    xs, prog = _fit_program(table_scale=table_scale)
    assert len(xs) == 3 and all(len(x) == 96 for x in xs)
    gaps = reference_hash_siren.step_gaps(CFG, prog, _batches(xs), block=50)
    assert gaps["loss_gap"] <= FWD_RTOL and gaps["grad_gap"] <= GRAD_RTOL and gaps["change_gap"] <= CHANGE_RTOL, gaps
    ref = reference_hash_siren.fit_steps(CFG, prog.params[0], _batches(xs), block=50)
    assert max(abs(a - b) / b for a, b in zip(prog.losses, ref.losses)) <= FWD_RTOL
    start = ref.params[0]
    for k in start:
        assert _rel(prog.grads[0][k], ref.grads[0][k]) <= GRAD_RTOL, k
        assert _rel(prog.after[k] - start[k], ref.after[k] - start[k]) <= CHANGE_RTOL, k


@pytest.mark.parametrize("fault", [dict(precision="tf32"), dict(fault="gates_one"), dict(fault="latent_zero")],
                         ids=["control_tf32", "gates_one", "latent_zero"])
def test_each_planted_fault_misses_the_tolerances(fault):
    """The cell's numbers of the reference's own steps with a fault planted,
    in the program's place, at a table that moves the gates."""
    xs, prog = _fit_program(table_scale=1000.0)
    faulted = reference_hash_siren.fit_steps(CFG, prog.params[0], _batches(xs), block=50, **fault)
    gaps = reference_hash_siren.step_gaps(CFG, faulted, _batches(xs), block=50)
    assert gaps["grad_gap"] > 10 * GRAD_RTOL, gaps


def test_a_step_that_leaves_its_state_unchanged_reads_one():
    xs, prog = _fit_program()
    prog.after = prog.params[0]
    assert reference_hash_siren.step_gaps(CFG, prog, _batches(xs), block=50)["change_gap"] == pytest.approx(1.0)


def _unfused(model, x):
    """The modulated SIREN's function through the unfused
    ``siren_layer_apply`` chain, in the order it ran before the sine-layer
    pair: the modulator, then each sine layer times its modulation."""
    lat = model.latent(x)
    h, mods = lat, []
    for layer in model.modulator:
        h = torch.relu(layer(h))
        mods.append(h)
        h = torch.cat([h, lat], dim=-1)
    params, y = model.siren.params, x
    for i in range(model.n_layers):
        y = port_siren.siren_layer_apply(params["layers"][i], y, model.w0_initial if i == 0 else model.w0) * mods[i]
    return port_siren.siren_layer_apply(params["last"], y, model.w0, sine=False)


@pytest.mark.parametrize("name", ["modulated_siren", "hash_siren"])
def test_the_sine_layer_pair_is_the_unfused_chain_bit_for_bit(name):
    model = make_modulated_siren(3, dim_hidden=24, n_layers=3, seed=7, device="cpu") if name == "modulated_siren" \
        else _pair(1000.0)[0]
    x, y = _rows(257, seed=8), torch.rand((257, 1), generator=torch.Generator().manual_seed(9))
    params = list(model.parameters())
    got, want = model(x), _unfused(model, x)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(torch.mean((got - y) ** 2), params),
                    torch.autograd.grad(torch.mean((want - y) ** 2), params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["modulated_siren", "psf_siren"])
def test_leading_dimensions_are_taken_as_rows(name):
    """The sine-layer kernels take (n, width): a (5, 7, 3) input gives the
    (35, 3) rows' outputs, bit for bit, in the input's leading shape (the
    hash SIREN's encoder takes (n, 3) alone)."""
    model = make_modulated_siren(3, dim_hidden=24, n_layers=3, seed=7, device="cpu") if name == "modulated_siren" \
        else port_siren.make_psf_siren(3, dim_hidden=24, n_layers=3, seed=7, device="cpu", n_sample=2,
                                       coordinates_spacing=(0.1, 0.1, 0.1))
    x = _rows(35, seed=10)
    got = model(x.reshape(5, 7, 3))
    assert got.shape == (5, 7, 1) and torch.equal(got.reshape(35, 1), model(x))


@pytest.mark.parametrize("factory", ["modulated_siren", "hash_siren", "psf_siren"])
def test_a_width_the_sine_layer_kernels_cannot_take_is_refused_on_the_card_alone(factory):
    """The kernels read rows as float4: on a CUDA device a dim_hidden that is
    not a multiple of 4 is refused by name, before any draw; on the CPU it
    runs."""
    with pytest.raises(ValueError, match=f"{factory} on cuda:0: .*multiple of 4, not 30"):
        port_siren.check_card_width(factory, 30, torch.device("cuda", 0))
    port_siren.check_card_width(factory, 32, torch.device("cuda", 0))
    port_siren.check_card_width(factory, 30, torch.device("cpu"))
    kwargs = {"coordinates_spacing": (0.1, 0.1, 0.1), "n_sample": 2} if factory == "psf_siren" else {}
    model = getattr(port_siren, "make_" + factory)(3, dim_hidden=30, n_layers=2, device="cpu", **kwargs)
    assert model(_rows(6, seed=11)).shape == (6, 1)


def test_modulator_rows_count_rows_times_layers_and_no_other_model():
    port_siren.reset_modulator_rows()
    model = _model()
    model(torch.zeros(10, 3))
    assert port_siren.MODULATOR_ROWS == {"hash_siren": 2 * 10, "modulated_siren": 0}
    make_modulated_siren(3, dim_hidden=8, n_layers=3, device="cpu")(torch.zeros(4, 3))
    assert port_siren.MODULATOR_ROWS == {"hash_siren": 2 * 10, "modulated_siren": 3 * 4}
    x, y = _volume()
    Trainer(TrainConfig(batch_size=48, epochs=1)).fit(make_siren(3, dim_hidden=8, n_layers=2, device="cpu"),
                                                      x.numpy(), y.numpy(), device="cpu")
    assert port_siren.MODULATOR_ROWS == {"hash_siren": 2 * 10, "modulated_siren": 3 * 4}
    port_siren.reset_modulator_rows()
    assert port_siren.MODULATOR_ROWS == {"hash_siren": 0, "modulated_siren": 0}


def test_modulator_span_opens_once_a_forward_under_a_profiler():
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.zeros(7, 3))
    assert sum(e.name == "mri.model.modulator" for e in prof.events()) == 1


@pytest.mark.parametrize("name", ["reference_hash_siren.py", "roofline_hash_siren.py"])
def test_reference_imports_nothing_of_the_port_or_jax(name):
    for node in ast.walk(ast.parse((BENCH / name).read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.module in (None, "common", "reference", "reference_wire", "roofline", "roofline_psf"), \
                f"{name} imports .{node.module}"
            assert node.module is not None or [a.name for a in node.names] == ["roofline"], name
        elif isinstance(node, ast.ImportFrom):
            assert node.module in ("__future__", "typing"), f"{name} imports {node.module}"
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] in ("math", "torch") for a in node.names), name
