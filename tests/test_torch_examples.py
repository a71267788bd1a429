"""Port parity: the examples (``mri_interpolation_tpu_torch.examples``)
against ``examples/``, which are imported by file path and not edited.

- **The tutorial's demo**, model by model: both ``main``s run with ``demo``
  recording what it is given (the same five models, parameter counts and
  configs), then each pair is fitted by its package's own ``demo`` on the
  tutorial's (24, 24, 12) volume from the JAX init (``convert.
  params_from_jax``), batch = n in order (JAX's permutations cannot be drawn
  in torch), 3 epochs: final loss rtol 1e-4, PSNR within 0.05 dB, SSIM within
  5e-3 (the pipeline's tolerances, ``test_torch_pipeline.py``).
- **The motion example's sequence** bit for bit.
- **smoke_mlp** on a small synthetic NIfTI: it runs, its loss is finite and
  its prediction is written as NIfTI of the slice's shape.
"""

import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from mri_interpolation_tpu.metrics import param_count as jax_param_count
from mri_interpolation_tpu_torch import io
from mri_interpolation_tpu_torch.convert import params_from_jax
from mri_interpolation_tpu_torch.examples import motion_interpolation, smoke_mlp, tutorial
from mri_interpolation_tpu_torch.metrics import param_count

REPO = Path(__file__).resolve().parents[1]
DEMOS = ["ReLU MLP", "RFF + MLP", "SIREN", "modulated SIREN", "hash MLP"]


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def demos():
    """Each package's tutorial run with ``demo`` recording its arguments:
    {name: (model, dataset, config, lo, data_range)} for JAX and the port,
    and the two modules."""
    jtut = load_example("tutorial")
    seen = {"jax": {}, "port": {}}

    def recorder(which):
        def demo(name, model, ds, cfg, lo=0.0, data_range=1.0, device=None):
            seen[which][name] = (model, ds, cfg, lo, data_range)
            return 30.0  # past the tutorial's assertions

        return demo

    real = {"jax": jtut.demo, "port": tutorial.demo}
    jtut.demo, tutorial.demo = recorder("jax"), recorder("port")
    argv = sys.argv
    try:
        sys.argv = ["tutorial.py"]
        jtut.main()
        tutorial.main(["--device", "cpu"])
    finally:
        sys.argv = argv
        jtut.demo, tutorial.demo = real["jax"], real["port"]
    return jtut, seen


def test_tutorial_builds_the_same_models(demos):
    _, seen = demos
    assert list(seen["jax"]) == list(seen["port"]) == DEMOS
    for name in DEMOS:
        jm, jds, jcfg, jlo, jdr = seen["jax"][name]
        tm, tds, tcfg, tlo, tdr = seen["port"][name]
        assert param_count(tm) == jax_param_count(jax.eval_shape(jm.init, jax.random.key(0))[0]), name
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert (tlo, tdr, tds.shape) == (jlo, jdr, jds.shape) == (tlo, tdr, (24, 24, 12)), name
        np.testing.assert_array_equal(tds.coords, jds.coords)
        np.testing.assert_array_equal(tds.values, jds.values)


@pytest.mark.parametrize("name", DEMOS)
def test_tutorial_demo_matches_jax(demos, name):
    jtut, seen = demos
    jm, jds, jcfg, lo, dr = seen["jax"][name]
    tm, tds, tcfg, _, _ = seen["port"][name]
    n = len(tds)
    jcfg = dataclasses.replace(jcfg, batch_size=n, epochs=3, shuffle=False)
    tcfg = dataclasses.replace(tcfg, batch_size=n, epochs=3, shuffle=False)
    _, k_init = jax.random.split(jax.random.key(jcfg.seed))  # the JAX trainer's init draw
    params, state = jax.device_get(jm.init(k_init))
    tm.load_state_dict(params_from_jax(params, state))
    got, want = {}, {}
    for module, out in ((jtut, want), (tutorial, got)):
        trainer, score = module.Trainer, module.evaluate_reconstruction

        class Capture(trainer):
            def fit(self, *args, **kw):
                out["fit"] = super().fit(*args, **kw)
                return out["fit"]

        def capture(*args, **kw):
            out["q"] = score(*args, **kw)
            return out["q"]

        module.Trainer, module.evaluate_reconstruction = Capture, capture
        try:
            if module is jtut:
                jtut.demo(name, jm, jds, jcfg, lo=lo, data_range=dr)
            else:
                tutorial.demo(name, tm, tds, tcfg, lo=lo, data_range=dr, device="cpu")
        finally:
            module.Trainer, module.evaluate_reconstruction = trainer, score
    assert got["fit"].final_loss == pytest.approx(float(want["fit"].final_loss), rel=1e-4)
    assert abs(got["q"]["psnr"] - float(want["q"]["psnr"])) < 0.05
    assert abs(got["q"]["ssim"] - float(want["q"]["ssim"])) < 5e-3


def test_motion_sequence_is_jax_s_bit_for_bit():
    jmotion = load_example("motion_interpolation")
    for n, T in ((32, 9), (17, 4)):
        want = jmotion.make_sequence(n, T)
        got = motion_interpolation.make_sequence(n, T)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_smoke_mlp_runs_and_writes_its_nifti(tmp_path, capsys):
    vol = io.synthetic_volume((12, 12, 6, 5), seed=2)
    path, out = tmp_path / "vol.nii.gz", tmp_path / "pred.nii.gz"
    io.nifti.save(vol, str(path), pixdim=(0.5, 0.5, 8.0, 0.02))
    res = smoke_mlp.main(["--image_path", str(path), "--epochs", "60", "--out", str(out), "--device", "cpu"])
    assert np.isfinite(res["final_loss"]) and np.isfinite(res["psnr"])
    pred = io.nifti.load(str(out))
    assert pred.get_fdata(np.float32).shape == (12, 12, 5)
    assert np.isfinite(pred.get_fdata(np.float32)).all()
    assert "final loss" in capsys.readouterr().out
