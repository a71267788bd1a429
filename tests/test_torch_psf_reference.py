"""The port's PSF SIREN against the benchmark's plain reference
(``benchmark/reference_psf.py``), on the CPU at a small size (width 16, 2
sine layers, 3^3 PSF points, batch 64) on seeded random weights: the
forward, the PSF's offsets and weights, the PSF loss, every parameter's
gradient and three Adam steps. Beside them: the reference and its roofline
import nothing of the port or of JAX; ``PSF_ROWS`` counts B * K rows a call
and both of the objective's spans open under a profiler.

Tolerances, each with its reason: the port and the reference run the same
float32 operations on the CPU, but not in the same order everywhere (the
port integrates by an ``einsum``, the reference by a matrix product, over
blocks of the batch whose squared errors it sums in float64), so the
numbers agree to a few float32 roundings, amplified by the sines' w0 = 30
(read here: 1e-7 on the loss, at most 3.4e-7 on a leaf's gradient): a
relative 5e-7 for the loss and the predictions, 5e-6 for a leaf's gradient
and its change after three steps. The same reference with its products in
TF32 lands outside them (read here: 1.4e-6 on the loss, 2.3e-5 to 3e-3 on
the gradients; checked below), so they bind.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import reference_psf
from mri_interpolation_tpu_torch.models import make_psf_siren
from mri_interpolation_tpu_torch.models import siren as port_siren
from mri_interpolation_tpu_torch.train import TrainConfig
from mri_interpolation_tpu_torch.train.trainer import make_optimizer

BENCH = Path(reference_psf.__file__).resolve().parent
CFG = {"siren": {"dim_in": 3, "dim_hidden": 16, "n_layers": 2, "dim_out": 1, "w0": 30.0, "w0_initial": 30.0,
                 "sigma": 6.0},
       "psf": {"n_sample": 3}, "volume": [6, 6, 4],
       "train": {"batch_size": 64, "lr": 1e-4, "optimizer": "adam", "lr_schedule": None}}
SEED = 2**31 + 11
LOSS_RTOL, GRAD_RTOL, CHANGE_RTOL = 5e-7, 5e-6, 5e-6


def _model(cfg=CFG, seed=SEED):
    s = cfg["siren"]
    model = make_psf_siren(3, dim_hidden=s["dim_hidden"], n_layers=s["n_layers"], w0=s["w0"],
                           w0_initial=s["w0_initial"], sigma=s["sigma"], n_sample=cfg["psf"]["n_sample"],
                           coordinates_spacing=reference_psf.half_extents(cfg), device="cpu")
    params = reference_psf.init_params(cfg, seed, "cpu")
    model.load_state_dict(params)
    return model, params


def _batch(seed, n=64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=gen) * 2.0 - 1.0
    return x, torch.rand((n, 1), generator=gen) * 2.0 - 1.0


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def test_init_params_follow_sirens_bounds():
    params = reference_psf.init_params(CFG, SEED, "cpu")
    assert sorted(params) == sorted(_model()[0].state_dict())
    assert float(params["layers.0.w"].abs().max()) <= 1.0 / 3
    bound = np.sqrt(6.0 / 16) / 30.0
    for name in ("layers.1.w", "layers.1.b", "last.w", "last.b"):
        assert float(params[name].abs().max()) <= bound
    assert float(params["layers.1.w"].abs().max()) > 0.8 * bound  # drawn over the whole range
    again = reference_psf.init_params(CFG, SEED, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_forward_equals_the_reference():
    model, params = _model()
    x, _ = _batch(1, 500)
    with torch.no_grad():
        got = model(x)
    want = reference_psf.siren(CFG, params, x)
    torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("spacing,n", [((0.1, 0.2, 0.3), 5), ((0.5 / 351, 0.5 / 351, 0.5 / 14), 5),
                                       ((0.1, 0.1, 0.1), 3)])
def test_psf_points_equal_the_reference(spacing, n):
    """Both are computed in float64 from the same description and cast to
    float32: equal exactly."""
    offsets, weights = port_siren.psf_offsets_and_weights(spacing, n)
    ref_offsets, ref_weights = reference_psf.psf_points(spacing, n)
    np.testing.assert_array_equal(offsets, ref_offsets.numpy())
    np.testing.assert_array_equal(weights, ref_weights.numpy())
    assert abs(float(ref_weights.double().sum()) - 1.0) < 1e-6
    assert float(ref_weights.max()) == float(ref_weights[(n**3) // 2])  # the centre weighs most


def _reference_loss_and_grads(params, x, y, precision="fp32", block=16):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = sorted(p)
    offsets, weights = reference_psf.psf_points(reference_psf.half_extents(CFG), CFG["psf"]["n_sample"])
    loss, grads = reference_psf.psf_loss_and_grads(CFG, p, names, x, y, offsets, weights, precision, block)
    return loss, dict(zip(names, grads))


def test_psf_loss_and_every_gradient_equal_the_reference():
    model, params = _model()
    x, y = _batch(2)
    loss = model.psf_loss(x, y)
    grads = dict(zip([n for n, _ in model.named_parameters()], torch.autograd.grad(loss, list(model.parameters()))))
    ref_loss, ref_grads = _reference_loss_and_grads(params, x, y)
    assert abs(float(loss.detach()) - ref_loss) <= LOSS_RTOL * ref_loss
    assert sorted(grads) == sorted(ref_grads)
    for name in grads:
        assert _rel(grads[name], ref_grads[name]) <= GRAD_RTOL, name
    # the control binds: TF32 products miss the tolerances
    tf_loss, tf_grads = _reference_loss_and_grads(params, x, y, "tf32")
    assert abs(tf_loss - ref_loss) > LOSS_RTOL * ref_loss
    assert min(_rel(tf_grads[n], ref_grads[n]) for n in ref_grads) > GRAD_RTOL
    assert max(_rel(tf_grads[n], ref_grads[n]) for n in ref_grads) > 100 * GRAD_RTOL


def test_blocks_do_not_change_the_reference():
    _, params = _model()
    x, y = _batch(3)
    whole, g_whole = _reference_loss_and_grads(params, x, y, block=64)
    parts, g_parts = _reference_loss_and_grads(params, x, y, block=7)
    assert abs(whole - parts) <= LOSS_RTOL * whole
    assert all(_rel(g_parts[n], g_whole[n]) <= GRAD_RTOL for n in g_whole)


def test_three_adam_steps_equal_the_reference():
    """The port's model under the trainer's optimizer (torch's Adam at
    1e-4) against ``reference_psf.fit_steps`` on the same three batches:
    each step's loss, and each leaf's change after the three."""
    model, params = _model()
    batches = [_batch(10 + t) for t in range(3)]
    opt = make_optimizer(TrainConfig(lr=1e-4), model.parameters())
    losses = []
    for x, y in batches:
        opt.zero_grad()
        loss = model.psf_loss(x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    ref = reference_psf.fit_steps(CFG, params, batches, block=16)
    for got, want in zip(losses, ref.losses):
        assert abs(got - want) <= LOSS_RTOL * want
    for name, p in model.named_parameters():
        change = float(torch.linalg.vector_norm((p.detach() - params[name]).double()))
        assert abs(change - ref.change_norms[name]) <= CHANGE_RTOL * ref.change_norms[name], name
    assert losses[2] != losses[0]  # the steps moved the model


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((alias.name, 0) for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "", node.level)


@pytest.mark.parametrize("name", ["reference_psf.py", "roofline_psf.py"])
def test_reference_imports_nothing_of_the_port_or_jax(name):
    for module, level in _imports(BENCH / name):
        if level:
            assert module in ("reference", "roofline"), f"{name} imports .{module}"
        else:
            assert module.split(".")[0] in ("__future__", "math", "typing", "torch"), f"{name} imports {module}"


def test_psf_rows_count_b_times_k_a_call():
    model, _ = _model()
    port_siren.reset_psf_rows()
    x, y = _batch(4, 10)
    model.psf_loss(x, y)
    assert port_siren.PSF_ROWS["psf_siren"] == 10 * 27
    model.psf_loss(*_batch(5, 7))
    assert port_siren.PSF_ROWS["psf_siren"] == 10 * 27 + 7 * 27
    with torch.no_grad():
        model(x)  # the forward alone feeds no PSF rows
    assert port_siren.PSF_ROWS["psf_siren"] == 17 * 27
    port_siren.reset_psf_rows()
    assert port_siren.PSF_ROWS["psf_siren"] == 0


def test_both_spans_open_under_a_profiler():
    model, _ = _model()
    x, y = _batch(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.psf_loss(x, y)
    names = [e.name for e in prof.events()]
    assert names.count("mri.model.psf_expand") == 1 and names.count("mri.model.psf_integrate") == 1
