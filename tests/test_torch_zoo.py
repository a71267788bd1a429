"""Port parity: the rest of the model zoo (BaseMLP, RffNet, GaborNet real and
complex, FreqMLP with its four encoder families), its encodings (frequency,
Gaussian Fourier) and spectral norm, against the JAX package, with the same
parameters moved over by ``convert.params_from_jax``. Inputs come from numpy
seeds. The JAX package fuses none of these models, nor does the port.

Tolerances and their reasons:

- forwards: the largest difference within 1e-5 of the largest reference
  value, 1e-4 where a sine or cosine runs at w0 = 30 (XLA and PyTorch sum
  the float32 products in another order; w0 multiplies that difference);
- spectral norm: the normalised weight and the new u within 1e-5 of the
  largest value, the power iteration's sums taken in another order;
- parameter gradients: per leaf, within 1e-4 of the leaf's largest
  gradient (1e-3 where the forward holds 1e-4: the backward multiplies by
  w0 once more). The complex Gabor's gradient is held through ``apply``,
  since no trainer fits it: torch's gradient of a real loss in a complex
  parameter is the conjugate of JAX's;
- loss curves, 10 steps from one init with ``shuffle=False``: rtol 1e-4;
  the BatchNorm statistics and u after them within 1e-3 of the largest
  value (they follow parameters that Adam moved by float noise: its step is
  about lr whatever the gradient's size);
- launchers from one init: PSNR within 0.05 dB and SSIM within 5e-3
  (``test_torch_pipeline.py``'s bounds for two fits).
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu import launcher as jlauncher
from mri_interpolation_tpu.encodings.fourier import GaussianFourierEncoding as JaxFourier
from mri_interpolation_tpu.encodings.frequency import FrequencyEncoding as JaxFrequency
from mri_interpolation_tpu.models import REGISTRY as JAX_REGISTRY
from mri_interpolation_tpu.models import core as jcore
from mri_interpolation_tpu.models import freq_mlp as jfreq
from mri_interpolation_tpu.models import gabor as jgabor
from mri_interpolation_tpu.models import mlp as jmlp
from mri_interpolation_tpu.train import TrainConfig as JaxTrainConfig
from mri_interpolation_tpu.train import Trainer as JaxTrainer
from mri_interpolation_tpu.train import save_checkpoint as jax_save_checkpoint
from mri_interpolation_tpu_torch import launcher
from mri_interpolation_tpu_torch.configs import RunConfig, override_from_args
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.encodings import FrequencyEncoding, GaussianFourierEncoding
from mri_interpolation_tpu_torch.io import dataset_from_array, nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import REGISTRY, core, make_freq_mlp, make_gabor_net, make_mlp, make_rff_net
from mri_interpolation_tpu_torch.train import TrainConfig, Trainer, save_checkpoint

SHAPE = (16, 16, 8)
FREQ = dict(n_frequencies=8, n_frequencies_t=4)
# name -> (JAX factory, port factory, keyword arguments, forward tolerance)
MODELS = {
    "mlp_relu": (jmlp.make_mlp, make_mlp, dict(dim_hidden=16, n_layers=3), 1e-5),
    "mlp_gelu": (jmlp.make_mlp, make_mlp, dict(dim_hidden=16, n_layers=3, activation="gelu"), 1e-5),
    "mlp_identity": (jmlp.make_mlp, make_mlp, dict(dim_hidden=16, n_layers=3, activation="identity"), 1e-5),
    "rff_net": (jmlp.make_rff_net, make_rff_net, dict(dim_hidden=16, n_layers=3, n_frequencies=8), 1e-5),
    "gabor_real_auto": (jgabor.make_gabor_net, make_gabor_net, dict(dim_hidden=16, n_layers=3), 1e-4),
    "gabor_real_torch": (jgabor.make_gabor_net, make_gabor_net,
                         dict(dim_hidden=16, n_layers=3, init_scheme="torch", sigma=1.0), 1e-4),
    "gabor_complex": (jgabor.make_gabor_net, make_gabor_net, dict(dim_hidden=16, n_layers=3, kind="complex",
                                                                  w0=10.0, sigma=4.0), 1e-4),
    **{f"freq_mlp_{e}": (jfreq.make_freq_mlp, make_freq_mlp,
                         dict(dim_hidden=16, n_layers=3, skip_connections=(2,), encoder_type=e, **FREQ),
                         1e-4 if e in ("gabor", "siren") else 1e-5)
       for e in ("gabor", "siren", "frequency", "rff")},
}


def _x(n=64, seed=0, dim=3):
    return np.random.default_rng(seed).uniform(0, 1, (n, dim)).astype(np.float32)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: max abs diff {err} > {rel} x {scale}"


def _pair(name, seed=0):
    jmake, tmake, kw, tol = MODELS[name]
    jm = jmake(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(seed)))
    tm = tmake(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm, tol


@pytest.mark.parametrize("dim, levels", [(1, 4), (2, 6), (3, 10)])
def test_frequency_encoding_matches_jax(dim, levels):
    x = _x(50, dim, dim) * 2 - 1
    want = JaxFrequency(dim, levels)(jnp.asarray(x))
    enc = FrequencyEncoding(dim, levels)
    np.testing.assert_array_equal(enc.freqs.numpy(), np.asarray(JaxFrequency(dim, levels)._freqs))
    got = enc(torch.from_numpy(x))
    assert got.shape == (50, dim * levels * 2)
    _close(got.numpy(), want, 1e-5, "frequency")


def test_fourier_encoding_matches_jax_and_trains_b():
    jenc = JaxFourier(3, encoded_size=8, sigma=10.0)
    params = jax.device_get(jenc.init(jax.random.key(3)))
    enc = GaussianFourierEncoding(3, encoded_size=8, sigma=10.0)
    enc.load_state_dict(params_from_jax(params))
    x = _x(40, 1)
    _close(enc(torch.from_numpy(x)).detach().numpy(), jenc.apply(params, jnp.asarray(x)), 1e-4, "fourier")
    assert [n for n, p in enc.named_parameters() if p.requires_grad] == ["b"]
    drawn = GaussianFourierEncoding(3, encoded_size=4000, sigma=10.0, generator=torch.Generator().manual_seed(0))
    assert abs(float(drawn.b.std()) - 10.0) < 0.3


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_spectral_norm_matches_jax(train):
    """The normalised weight, the new u (updated in training only), and the
    weight's gradient through the normalisation."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    u0 = jax.device_get(jcore.spectral_norm_init(jax.random.key(1), 7))["u"]
    g = rng.normal(size=(12, 7)).astype(np.float32)

    def f(wv):
        wn, st = jcore.spectral_norm_apply(wv, {"u": jnp.asarray(u0)}, train=train)
        return jnp.sum(wn * g), (wn, st["u"])

    (_, (jw, ju)), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    tw, tu = core.spectral_norm_apply(wt, torch.from_numpy(np.asarray(u0)), train)
    (tw * torch.from_numpy(g)).sum().backward()
    _close(tw.detach().numpy(), jw, 1e-5, "normalised weight")
    _close(tu.numpy(), ju, 1e-5, "u")
    _close(wt.grad.numpy(), jgrad, 1e-4, "gradient")
    if not train:
        np.testing.assert_array_equal(tu.numpy(), u0)
    # the module keeps u as its buffer, written in training only
    sn = core.SpectralNorm(7)
    sn.u.copy_(torch.from_numpy(np.asarray(u0)))
    sn.train(train)
    sn(torch.from_numpy(w))
    _close(sn.u.numpy(), ju, 1e-5, "buffer u")


def test_spectral_norm_init_is_a_unit_vector():
    u = core.spectral_norm_init(64, torch.Generator().manual_seed(0))
    assert u.shape == (64,) and abs(float(torch.linalg.norm(u)) - 1.0) < 1e-6


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name):
    """Each model's forward at one set of parameters; FreqMLP in training
    (batch statistics, spectral norm's power iteration, both state updates)
    and then in eval (running statistics and the stored u)."""
    jm, params, state, tm, tol = _pair(name)
    x = _x()
    apply = jax.jit(jm.apply, static_argnames=("train",))
    for train in ((True, False) if name.startswith("freq_mlp") else (False,)):
        want, new_state = apply(params, state, jnp.asarray(x), train=train)
        tm.train(train)
        got = tm(torch.from_numpy(x)).detach()
        assert got.dtype == torch.float32 and got.shape == (64, 1)
        _close(got.numpy(), want, tol, f"{name} train={train}")
        for key, value in params_from_jax(jax.device_get(new_state)).items():
            _close(tm.state_dict()[key].numpy(), value.numpy(), 1e-5, f"{name} state {key}")
        state = new_state


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_gradients_match_jax(name):
    """The gradient of sum(y * G) in every parameter, in training mode."""
    jm, params, state, tm, tol = _pair(name, seed=1)
    x = _x(48, 2)
    g = np.random.default_rng(9).normal(size=(48, 1)).astype(np.float32)
    train = name.startswith("freq_mlp")
    # the complex net's per-layer "complex" bool leaf: its float0 cotangent is dropped
    if name == "gabor_complex":  # its bool leaves cannot pass through jit: eager, with allow_int
        grad = jax.grad(lambda p: jnp.sum(jm.apply(p, state, jnp.asarray(x), train=train)[0] * g), allow_int=True)
    else:
        grad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, state, jnp.asarray(x), train=train)[0] * g)))
    jgrads = grad(params)
    for layer in jgrads.get("layers", []):
        layer.pop("complex", None)
    want = params_from_jax(jax.device_get(jgrads))
    tm.train(train)
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want)
    # a bias that feeds a BatchNorm has a true gradient of zero, where both frameworks leave float noise:
    # no leaf is held tighter than 1% of the model's largest gradient
    floor = 1e-2 * max(float(g.abs().max()) for g in want.values())
    for n, grad in grads.items():
        ref = want[n].numpy()
        if np.iscomplexobj(ref):
            ref = np.conj(ref)  # torch's gradient of a real loss in z is the conjugate of JAX's
        err = float(np.abs(grad.numpy() - ref).max())
        assert err <= 10 * tol * max(float(np.abs(ref).max()), floor), f"{name} {n}: max abs diff {err}"


def test_complex_gabor_layers_and_fit():
    """The complex net's first layer is real, the rest complex64, and its
    output real; ``Trainer.fit`` refuses its complex parameters (the JAX
    trainer cannot fit them either: ROADMAP.md, section 3)."""
    tm = make_gabor_net(3, dim_hidden=8, n_layers=3, kind="complex", device="cpu")
    assert [layer.lin.w.dtype for layer in tm.layers] == [torch.float32, torch.complex64, torch.complex64]
    assert [layer.complex for layer in tm.layers] == [False, True, True] and tm.name == "gabor_complex"
    ds = dataset_from_array(synthetic_volume((4, 4, 4), seed=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(TrainConfig(batch_size=16)).fit(tm, ds.coords, ds.values, device="cpu")


def test_freq_mlp_refuses_the_hash_encoder():
    with pytest.raises(ValueError, match="encoder_type"):
        make_freq_mlp(3, encoder_type="hash", device="cpu")


def test_registry_matches_jax():
    assert set(REGISTRY) == set(JAX_REGISTRY)
    for name in ("mlp", "BaseMLP", "rff_net", "RffNet", "gabor", "GaborNet", "freq_mlp", "FreqMLP", "warp_inr"):
        assert REGISTRY[name].__name__ == JAX_REGISTRY[name].__name__


@pytest.mark.parametrize("encoder_type", ["siren", "rff"])
def test_freq_mlp_loss_curve_matches_jax(encoder_type):
    """Ten steps of ``Trainer.fit`` with weight decay 1e-5 (FreqMLP's Adam
    setting): the BatchNorm statistics and spectral norm's u advance each
    step in both."""
    kw = dict(dim_hidden=16, n_layers=3, skip_connections=(2,), encoder_type=encoder_type, **FREQ)
    jm = jfreq.make_freq_mlp(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(2)))
    tm = make_freq_mlp(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    ds = dataset_from_array(synthetic_volume((8, 8, 5), seed=3))
    cfg = dict(batch_size=32, epochs=1, lr=1e-3, weight_decay=1e-5, shuffle=False)
    jres = JaxTrainer(JaxTrainConfig(**cfg)).fit(jm, ds.coords[:320], ds.values[:320], params=params, state=state)
    tres = Trainer(TrainConfig(**cfg)).fit(tm, ds.coords[:320], ds.values[:320], device="cpu")
    assert tres.steps == jres.steps == 10
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-4)
    for key, value in params_from_jax({}, jax.device_get(jres.state)).items():
        _close(tm.state_dict()[key].numpy(), value.numpy(), 1e-3, key)


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vol") / "synthetic_16x16x8.nii.gz")
    nifti.save(synthetic_volume(SHAPE, seed=7), path)
    return path


# model_class -> (JAX factory, port factory, RunConfig fields): the launcher passes each factory what it takes
LAUNCHED = {
    "mlp": (jmlp.make_mlp, make_mlp, dict(dim_hidden=16, n_layers=3, lr=1e-3)),
    "rff_net": (jmlp.make_rff_net, make_rff_net, dict(dim_hidden=16, n_layers=3, n_frequencies=16, sigma=2.0,
                                                      lr=1e-3)),
    "gabor": (jgabor.make_gabor_net, make_gabor_net, dict(dim_hidden=16, n_layers=3, lr=3e-4)),
    "freq_mlp": (jfreq.make_freq_mlp, make_freq_mlp, dict(dim_hidden=16, n_layers=3, encoder_type="siren",
                                                          skip_connections=(2,), lr=1e-3, weight_decay=1e-5,
                                                          **FREQ)),
}


@pytest.mark.parametrize("name", sorted(LAUNCHED))
def test_zoo_through_both_launchers(volume, tmp_path, name):
    """Each zoo model through both launchers from one init (their
    checkpoints), 10 one-batch epochs on (16, 16, 8): steps, PSNR and SSIM."""
    jmake, tmake, run = LAUNCHED[name]
    cfg = RunConfig(**run)
    kw = {k: v for k, v in cfg.model_kwargs().items()
          if k in inspect.signature(jmake).parameters and k not in ("dim_in", "lr")}
    jm = jmake(dim_in=3, **kw)
    params, state = jax.device_get(jm.init(jax.random.key(0)))
    tm = tmake(3, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params, state))
    jax_ckpt, port_ckpt = str(tmp_path / "jax_init"), str(tmp_path / "port_init")
    jax_save_checkpoint(jax_ckpt, 0, params, state)
    save_checkpoint(port_ckpt, 0, tm.state_dict())
    common = dict(model_class=name, epochs=10, batch_size=int(np.prod(SHAPE)), save_checkpoint=False,
                  interp_shapes=((16, 16, 12),), image_path=volume, **run)
    want = jlauncher.run(jconfigs.RunConfig(**common, checkpoint_path=jax_ckpt, output_root=str(tmp_path / "jax")))
    got = launcher.run(RunConfig(**common, checkpoint_path=port_ckpt, output_root=str(tmp_path / "port")),
                       device="cpu")
    assert got["steps"] == want["steps"] == 10 and got["model"] == want["model"]
    assert abs(got["psnr"] - want["psnr"]) < 0.05 and abs(got["ssim"] - want["ssim"]) < 5e-3
    assert os.path.exists(os.path.join(got["run_dir"], "interpolation(16, 16, 12).nii.gz"))


@pytest.mark.parametrize("name", ["mlp", "rff_net", "gabor", "freq_mlp", "warp_inr"])
def test_zoo_through_the_cli(volume, tmp_path, name, capsys):
    """``launcher.main --model_class <name>`` on the CPU: one epoch, the
    summary printed, the model the registry names."""
    extra = {"freq_mlp": ["--encoder_type", "rff", "--n_frequencies", "8", "--skip_connections", "1"],
             "warp_inr": ["--warp_hidden", "8", "--n_features_per_level", "2"]}.get(name, [])
    summary = launcher.main(["--image_path", volume, "--model_class", name, "--epochs", "1", "--batch_size", "512",
                             "--dim_hidden", "8", "--n_layers", "2", "--interp_shapes", "()", "--output_root",
                             str(tmp_path), "--device", "cpu", *extra])
    assert json.loads(capsys.readouterr().out)["steps"] == summary["steps"] == 4
    assert summary["model"].startswith(name if name != "gabor" else "gabor_real") and np.isfinite(summary["psnr"])


def test_skip_connections_flag_takes_an_int_or_a_tuple():
    parser = launcher.build_parser()
    for flag, want in (("2", (2,)), ("1,3", (1, 3)), ("(2,)", (2,))):
        cfg = override_from_args(RunConfig(), parser.parse_args(["--skip_connections", flag]))
        assert cfg.skip_connections == want
    assert RunConfig().model_kwargs()["weight_decay"] == 0.0
