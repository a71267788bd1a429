"""The slice's parity table on the CPU: each row measures one maximum error
of the port against the JAX package and holds it to its tolerance.

``PYTHONPATH=. python tests/test_torch_parity_table.py`` prints the rows as
the Markdown table kept in PERF.md. Each measurement runs once per process
(cached), whichever rows read it. The reasons for each tolerance are in the test files
of the same functions (test_torch_hash_encode, _hash_mlp, _trainer, _pipeline,
_fused_mlp, _siren), whose helpers the slice-2 rows reuse.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu.encodings.hashgrid import HashGridEncoding as JaxHashGrid
from mri_interpolation_tpu.infer import evaluate_grid as jax_evaluate_grid
from mri_interpolation_tpu.metrics import evaluate_reconstruction as jax_evaluate_reconstruction
from mri_interpolation_tpu.models import make_hash_mlp as jax_make_hash_mlp
from mri_interpolation_tpu.ops.pallas.hash_encode import pallas_hash_encode
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import HashGridEncoding
from mri_interpolation_tpu_torch.infer import evaluate_grid
from mri_interpolation_tpu_torch.io import dataset_from_array, synthetic_volume
from mri_interpolation_tpu_torch.metrics import evaluate_reconstruction
from mri_interpolation_tpu_torch.models import make_hash_mlp
from mri_interpolation_tpu_torch.ops import hash_encode as he
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer

FLAGSHIP = dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=23,
                base_resolution=(64, 64, 5), finest_resolution=(352, 352, 15))
# the slice's geometry and a hashed 4-D one (per-geometry rows: test_torch_hash_encode)
ENCODINGS = {
    "flagship": dict(dim=3, **FLAGSHIP),
    "d4_hashed": dict(dim=4, n_levels=2, n_features_per_level=3, log2_hashmap_size=9,
                      base_resolution=(3, 3, 2, 2), finest_resolution=(9, 9, 5, 6), storage="hashed"),
}
SMALL = dict(FLAGSHIP, base_resolution=(4, 4, 2), finest_resolution=(16, 16, 8), dim_hidden=16)


@functools.lru_cache(maxsize=None)
def _encode_errors(jax_path: str):
    """Max |port - JAX| of the forward and the table gradient over ENCODINGS."""
    fwd = grad = 0.0
    for cfg in ENCODINGS.values():
        rng = np.random.default_rng(0)
        enc, jenc = HashGridEncoding(**cfg), JaxHashGrid(**cfg)
        x = rng.random((97, cfg["dim"]), dtype=np.float32)
        x[0], x[1] = 0.0, 1.0
        table = rng.uniform(-1, 1, (enc.total_size, cfg["n_features_per_level"])).astype(np.float32)
        g = rng.standard_normal((97, enc.output_dim)).astype(np.float32)
        if jax_path == "pallas":
            f = lambda t: pallas_hash_encode(jenc, {"table": t}, jnp.asarray(x), tile=64, interpret=True)  # noqa: E731
        else:
            f = jax.jit(lambda t: jenc.apply({"table": t}, jnp.asarray(x)))  # noqa: E731
        y, vjp = jax.vjp(f, jnp.asarray(table))
        dt = vjp(jnp.asarray(g))[0]
        xt = torch.from_numpy(x)
        fwd = max(fwd, float(np.abs(he.hash_encode_forward(enc, torch.from_numpy(table), xt).numpy()
                                    - np.asarray(y)).max()))
        grad = max(grad, float(np.abs(he.hash_encode_table_grad(enc, xt, torch.from_numpy(g)).numpy()
                                      - np.asarray(dt)).max()))
    return fwd, grad


@functools.lru_cache(maxsize=None)
def _hash_mlp_errors():
    """Max |port - JAX| of the train-mode output and of every parameter gradient."""
    jm = jax_make_hash_mlp(dim_in=3, dim_hidden=16, **FLAGSHIP)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    params["encoder"]["table"] = rng.uniform(-0.5, 0.5, params["encoder"]["table"].shape).astype(np.float32)
    tm = make_hash_mlp(3, dim_hidden=16, device="cpu", **FLAGSHIP)
    tm.load_state_dict(params_from_jax(params, state))
    x = rng.random((256, 3), dtype=np.float32)
    y = rng.standard_normal((256, 1)).astype(np.float32)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True, rng=None)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = tm(torch.from_numpy(x))
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    named = dict(tm.named_parameters())
    grad_err = max(float(np.abs(named[k].grad.numpy() - v.numpy()).max())
                   for k, v in params_from_jax(jax.device_get(grads)).items())
    return float(np.abs(out.detach().numpy() - np.asarray(pred)).max()), grad_err


def _fit_pair(table_scale, epochs, batch_size):
    ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7))
    jm = jax_make_hash_mlp(dim_in=3, **SMALL)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    if table_scale is not None:
        shape = params["encoder"]["table"].shape
        params["encoder"]["table"] = np.random.default_rng(0).uniform(
            -table_scale, table_scale, shape).astype(np.float32)
    tm = make_hash_mlp(3, device="cpu", **SMALL)
    tm.load_state_dict(params_from_jax(params, state))
    cfg = dict(batch_size=batch_size, epochs=epochs, lr=5e-3, seed=0, shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords, ds.values, params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords, ds.values, device="cpu")
    return ds, jm, jres, tm, tres


@functools.lru_cache(maxsize=None)
def _loss_curve_rel(table_scale):
    _, _, jres, _, tres = _fit_pair(table_scale, epochs=1, batch_size=200)
    return float(np.max(np.abs(tres.losses / np.asarray(jres.losses) - 1)))


@functools.lru_cache(maxsize=None)
def _pipeline_errors():
    ds, jm, jres, tm, _ = _fit_pair(None, epochs=10, batch_size=256)
    jq = jax_evaluate_reconstruction(jax_evaluate_grid(jm, jres.params, jres.state, ds.shape),
                                     jnp.asarray(ds.image()))
    tq = evaluate_reconstruction(evaluate_grid(tm, ds.shape, device="cpu"), ds.image(), device="cpu")
    same = make_hash_mlp(3, device="cpu", **SMALL)
    same.load_state_dict(params_from_jax(jax.device_get(jres.params), jax.device_get(jres.state)))
    grid_err = float(np.abs(evaluate_grid(same, (24, 24, 16), device="cpu")
                            - np.asarray(jax_evaluate_grid(jm, jres.params, jres.state, (24, 24, 16)))).max())
    return abs(tq["psnr"] - jq["psnr"]), abs(tq["ssim"] - jq["ssim"]), grid_err


def _max_err(pairs):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in pairs)


@functools.lru_cache(maxsize=None)
def _fused_mlp_errors(sine: bool):
    """Max |port - Pallas interpret| of the fused-MLP forward and of the
    backward's dW, db and dx, over the stacks of test_torch_fused_mlp with
    (or without) sine layers."""
    import test_torch_fused_mlp as tf

    fwd, bwd = [], []
    for name in sorted(tf.STACKS):
        ws, bs, x, g, acts = tf._stack(name)
        if any(a[0] == "sine" for a in acts) != sine:
            continue
        flat, L = tf._jax_flat(ws, bs), len(ws) - 1
        want = tf.jfm._forward_call(flat, jnp.asarray(x), L, acts, tf.TILE, True, ws[-1].shape[1])
        got = tf.fm.mlp_forward(tf._torch(ws), tf._torch(bs), torch.from_numpy(x), acts)
        fwd.append((got.numpy(), want))
        grads, jdx = tf.jfm._backward_call(flat, jnp.asarray(x), jnp.asarray(g), L, acts, tf.TILE, True, True)
        dws, dbs, dx = tf.fm.mlp_backward(tf._torch(ws), tf._torch(bs), torch.from_numpy(x), torch.from_numpy(g),
                                          acts, True)
        bwd += [(d.numpy(), grads[2 * l]) for l, d in enumerate(dws)]
        bwd += [(d.numpy(), np.asarray(grads[2 * l + 1]).reshape(-1)) for l, d in enumerate(dbs)]
        bwd.append((dx.numpy(), jdx))
    return _max_err(fwd), _max_err(bwd)


@functools.lru_cache(maxsize=None)
def _slice2_model_errors(model: str):
    """Max |port - JAX| of the output and of every parameter gradient (the
    table's included) of make_siren or the relu_plain HashMLP, the JAX
    model's Pallas kernels in interpret mode."""
    import test_torch_siren as ts

    jm, params, state, tm = ts._siren_pair() if model == "siren" else ts._hash_pair()
    x, y = ts._points(257, -1.0 if model == "siren" else 0.0, seed=2)

    def loss(p):
        pred, _ = jm.apply(p, state, jnp.asarray(x), train=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, pred), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x))
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    named = dict(tm.named_parameters())
    grad_err = _max_err((named[k].grad.numpy(), v.numpy())
                        for k, v in params_from_jax(jax.device_get(grads)).items())
    return _max_err([(out.detach().numpy(), pred)]), grad_err


@functools.lru_cache(maxsize=None)
def _slice2_fit_rel(model: str):
    """Max relative difference of 8 Adam steps' losses (adam_tcnn for the
    relu_plain HashMLP), port vs JAX trainer, from one init."""
    import test_torch_siren as ts

    if model == "siren":
        ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7), zero_centered=True)
        jm, params, state, tm = ts._siren_pair(fused="off")
        cfg = dict(batch_size=256, epochs=1, lr=1e-4, seed=0, shuffle=False)
    else:
        ds = dataset_from_array(synthetic_volume((16, 16, 8), seed=7))
        jm, params, state, tm = ts._hash_pair(fused="off")
        cfg = dict(batch_size=256, epochs=1, lr=1e-2, seed=0, shuffle=False, optimizer="adam_tcnn")
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords, ds.values, params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords, ds.values, device="cpu")
    return float(np.max(np.abs(tres.losses / np.asarray(jres.losses) - 1)))


@functools.lru_cache(maxsize=None)
def _siren_grid_error():
    import test_torch_siren as ts

    jm, params, state, tm = ts._siren_pair(fused="off", seed=3)
    want = jax_evaluate_grid(jm, params, state, (12, 10, 6), lo=-1.0, chunk_size=256)
    return _max_err([(evaluate_grid(tm, (12, 10, 6), lo=-1.0, chunk_size=256, device="cpu"), want)])


# (slice, function, tolerance, measure) -> each row's measure returns its max error
ROWS = {
    "encode_fwd_pallas": ("encoding", "hash_encode_forward vs Pallas interpret", 1e-6,
                          lambda: _encode_errors("pallas")[0]),
    "encode_grad_pallas": ("encoding", "hash_encode_table_grad vs Pallas VJP", 1e-6,
                           lambda: _encode_errors("pallas")[1]),
    "encode_fwd_apply": ("encoding", "hash_encode_forward vs HashGridEncoding.apply", 1e-6,
                         lambda: _encode_errors("apply")[0]),
    "encode_grad_apply": ("encoding", "hash_encode_table_grad vs apply's VJP", 1e-6,
                          lambda: _encode_errors("apply")[1]),
    "mlp_forward": ("model", "HashMLP train-mode output (flagship, hidden 16)", 1e-5,
                    lambda: _hash_mlp_errors()[0]),
    "mlp_grads": ("model", "HashMLP parameter gradients", 1e-5, lambda: _hash_mlp_errors()[1]),
    "fit_curve": ("trainer", "Trainer.fit loss curve, rel (table U(+-0.5))", 1e-4,
                  lambda: _loss_curve_rel(0.5)),
    "fit_curve_factory": ("trainer", "Trainer.fit loss curve, rel (factory init)", 1e-3,
                          lambda: _loss_curve_rel(None)),
    "grid_same_params": ("pipeline", "evaluate_grid (24,24,16), same params", 1e-4,
                         lambda: _pipeline_errors()[2]),
    "psnr": ("pipeline", "reconstruction PSNR of two fits, dB", 0.05, lambda: _pipeline_errors()[0]),
    "ssim": ("pipeline", "reconstruction SSIM of two fits", 5e-3, lambda: _pipeline_errors()[1]),
    "fused_fwd": ("fused MLP", "mlp_forward vs Pallas interpret (relu, gelu, id)", 1e-5,
                  lambda: _fused_mlp_errors(False)[0]),
    "fused_fwd_sine": ("fused MLP", "mlp_forward vs Pallas interpret (sine, w0 30 / 25 / 50)", 2e-5,
                       lambda: _fused_mlp_errors(True)[0]),
    "fused_bwd": ("fused MLP", "mlp_backward dW, db, dx vs Pallas _backward_call (relu, gelu, id)", 1e-5,
                  lambda: _fused_mlp_errors(False)[1]),
    "fused_bwd_sine": ("fused MLP", "mlp_backward dW, db, dx vs Pallas _backward_call (sine)", 2e-5,
                       lambda: _fused_mlp_errors(True)[1]),
    "siren_forward": ("SIREN", "make_siren output (3-32x3-1, fused interpret)", 2e-5,
                      lambda: _slice2_model_errors("siren")[0]),
    "siren_grads": ("SIREN", "make_siren parameter gradients", 2e-5, lambda: _slice2_model_errors("siren")[1]),
    "siren_fit": ("SIREN", "Trainer.fit loss curve, rel (zero-centred)", 1e-4, lambda: _slice2_fit_rel("siren")),
    "siren_grid": ("SIREN", "evaluate_grid (12,10,6) at lo=-1, same params", 2e-5, _siren_grid_error),
    "relu_plain_forward": ("tcnn HashMLP", "relu_plain output (fused interpret)", 1e-5,
                           lambda: _slice2_model_errors("relu_plain")[0]),
    "relu_plain_grads": ("tcnn HashMLP", "relu_plain parameter gradients, table (via dx) included", 1e-5,
                         lambda: _slice2_model_errors("relu_plain")[1]),
    "relu_plain_fit": ("tcnn HashMLP", "Trainer.fit loss curve with adam_tcnn, rel", 1e-4,
                       lambda: _slice2_fit_rel("relu_plain")),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_parity_row(row):
    _, _, tol, measure = ROWS[row]
    err = measure()
    assert np.isfinite(err) and err <= tol, f"{row}: {err} > {tol}"


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    print(f"torch {torch.__version__}, jax {jax.__version__}, python {sys.version.split()[0]}, CPU")
    print("| slice | function | tolerance | max error (CPU) |")
    print("|---|---|---|---|")
    for name in ROWS:
        sl, fn, tol, measure = ROWS[name]
        print(f"| {sl} | {fn} | {tol:g} | {measure():.3g} |")
