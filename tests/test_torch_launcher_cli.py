"""Port parity of the launcher's configuration layer (``configs.py``) and CLI
(``launcher.py``) against the JAX package, plus CPU runs of
``launcher.main``.

The configuration functions are pure Python: every field the port keeps is
compared for equality with the JAX package's result on the same input. The
CLI runs go through ``--device cpu`` on a tiny synthetic volume and check the
run's artifacts and summary (the card runs of the same entry point are in
``chip_smoke.py``).
"""

import argparse
import inspect
import json
import os
from dataclasses import fields

import numpy as np
import pytest

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu_torch import configs, launcher
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume
from mri_interpolation_tpu_torch.models import REGISTRY

PORT_FIELDS = [f.name for f in fields(configs.RunConfig)]

TCNN_JSON = """{
  // tcnn-style config, as the reference's config/hash_config.json
  "loss": {"otype": "RelativeL2"},
  "optimizer": {
    "otype": "Adam",
    "learning_rate": 1e-2, // per step
    "beta1": 0.9,
    "beta2": 0.99,
    "epsilon": 1e-15,
    "l2_reg": 1e-6
  },
  "encoding": {
    "otype": "HashGrid",
    "n_levels": 16,
    "n_features_per_level": 2,
    "log2_hashmap_size": 19,
    "base_resolution": 16,
    "per_level_scale": 1.4
  },
  "network": {
    "otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
    "n_neurons": 128,
    "n_hidden_layers": 2,
    "doc": "https://github.com/NVlabs/tiny-cuda-nn // not a comment"
  }
}
"""


def _same_fields(port_cfg, jax_cfg):
    for name in PORT_FIELDS:
        assert getattr(port_cfg, name) == getattr(jax_cfg, name), name


def test_run_config_fields_and_defaults_match_jax():
    jax_fields = {f.name for f in fields(jconfigs.RunConfig)}
    assert set(PORT_FIELDS) <= jax_fields
    _same_fields(configs.RunConfig(), jconfigs.RunConfig())
    _same_fields(configs.default_hash_config(), jconfigs.default_hash_config())
    _same_fields(configs.default_siren_config(), jconfigs.default_siren_config())
    siren = configs.default_siren_config()
    assert (siren.model_class, siren.batch_size, siren.lr, siren.dim_hidden, siren.n_layers, siren.zero_centered,
            siren.w0, siren.w0_initial, siren.sigma) == ("siren", 4096, 1e-4, 128, 6, True, 30.0, 30.0, 6.0)


@pytest.mark.parametrize("text", ["64,64,5", "(64,64,5)", "16", "(352,352,30),(352,352,60)", "[4, 4]",
                                  " (2,3) ", "5,", "((1,2),)"])
def test_parse_tuple_flag_matches_jax(text):
    assert configs.parse_tuple_flag(text) == jconfigs.parse_tuple_flag(text)


def test_parse_tuple_flag_rejects_what_jax_rejects():
    for mod in (configs, jconfigs):
        with pytest.raises(argparse.ArgumentTypeError):
            mod.parse_tuple_flag("(1,2")


ARGVS = [
    [],
    ["--n_levels", "16", "--n_features_per_level", "2", "--log2_hashmap_size", "19", "--base_resolution", "16",
     "--per_level_scale", "1.4", "--dim_hidden", "128", "--n_layers", "2", "--decoder", "relu_plain",
     "--lr", "1e-2", "--optimizer", "adam_tcnn"],
    ["--batch_size", "4096", "--zero_centered", "true", "--w0", "25", "--w0_initial", "50", "--sigma", "3",
     "--interp_shapes", "(352,352,30)", "--finest_resolution", "64,64,8", "--slice_z", "2"],
    ["--interp_shapes", "(8,8,6),(8,8,12)", "--save_checkpoint", "no", "--model_class", "siren"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["none", "tcnn", "siren_knobs", "shapes"])
def test_flags_override_like_jax(argv):
    port_parser, jax_parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    configs.add_config_flags(port_parser, configs.RunConfig())
    jconfigs.add_config_flags(jax_parser, jconfigs.RunConfig())
    got = configs.override_from_args(configs.RunConfig(), port_parser.parse_args(argv))
    want = jconfigs.override_from_args(jconfigs.RunConfig(), jax_parser.parse_args(argv))
    _same_fields(got, want)


def test_interp_shapes_flag_rejects_a_bare_int():
    parser = argparse.ArgumentParser()
    configs.add_config_flags(parser, configs.RunConfig())
    with pytest.raises(ValueError, match="full shapes"):
        configs.override_from_args(configs.RunConfig(), parser.parse_args(["--interp_shapes", "30"]))


def test_json_config_matches_jax(tmp_path):
    path = tmp_path / "hash_config.json"
    path.write_text(TCNN_JSON)
    enco = configs.load_json_config(str(path))
    assert enco == jconfigs.load_json_config(str(path))
    assert enco["network"]["doc"] == "https://github.com/NVlabs/tiny-cuda-nn // not a comment"
    for base in ("hash", "siren"):
        port_base = configs.default_siren_config() if base == "siren" else configs.default_hash_config()
        jax_base = jconfigs.default_siren_config() if base == "siren" else jconfigs.default_hash_config()
        got = configs.apply_enco_config(port_base, enco)
        _same_fields(got, jconfigs.apply_enco_config(jax_base, enco))
    assert (got.n_levels, got.per_level_scale, got.finest_resolution, got.optimizer, got.loss, got.weight_decay,
            got.dim_hidden, got.lr) == (16, 1.4, None, "adam_tcnn", "relative_l2", 1e-6, 128, 1e-2)


@pytest.mark.parametrize("line", ['"a": 1, // c\n', '"u": "http://x//y" // c\n', '"q": "say \\"//\\"" // c\n',
                                  "// whole line\n", "no comment\n"])
def test_strip_line_comment_matches_jax(line):
    assert configs._strip_line_comment(line) == jconfigs._strip_line_comment(line)


def test_parser_has_the_jax_flags():
    port = {a.dest for a in launcher.build_parser()._actions}
    assert {"config_preset", "enco_config_path", "config_yaml", "plan", "device"} <= port
    assert set(PORT_FIELDS) - {"skip_connections"} <= port


def test_build_model_drops_what_the_factory_does_not_take():
    seen = {}

    def factory(dim_in, dim_hidden=8, w0=1.0, device=None):
        seen.update(dim_in=dim_in, dim_hidden=dim_hidden, w0=w0, device=device)
        return "model"

    REGISTRY["_spy"] = factory
    try:
        cfg = configs.RunConfig(model_class="_spy", dim_hidden=12, w0=3.0)
        assert launcher.build_model(cfg, 4, "cpu") == "model"
    finally:
        del REGISTRY["_spy"]
    assert seen == {"dim_in": 4, "dim_hidden": 12, "w0": 3.0, "device": "cpu"}
    siren = launcher.build_model(configs.default_siren_config(), 3, "cpu")  # n_levels etc. dropped
    assert siren.name == "siren" and siren.n_layers == 6 and siren.w0 == 30.0
    assert "n_levels" in configs.RunConfig().model_kwargs()
    assert "n_levels" not in inspect.signature(REGISTRY["siren"]).parameters


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    path = tmp_path_factory.mktemp("vol") / "synthetic_16x12x6.nii.gz"
    nifti.save(synthetic_volume((16, 12, 6), seed=5), str(path))
    return str(path)


def _main(volume, out, *extra):
    return launcher.main(["--image_path", volume, "--output_root", str(out), "--device", "cpu", "--epochs", "2",
                          "--interp_shapes", "(16,12,12)", *extra])


def test_main_runs_the_siren_preset_on_the_cpu(volume, tmp_path, capsys):
    summary = _main(volume, tmp_path, "--config_preset", "siren", "--batch_size", "256", "--dim_hidden", "16",
                    "--n_layers", "2")
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(summary))
    assert summary["model"] == "siren" and summary["device"] == "cpu"
    assert summary["steps"] == 2 * (16 * 12 * 6 // 256) and summary["batch_size"] == 256
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"]) and np.isfinite(summary["final_loss"])
    run_dir = summary["run_dir"]
    interp = nifti.load(os.path.join(run_dir, "interpolation(16, 12, 12).nii.gz")).get_fdata(np.float32)
    assert interp.shape == (16, 12, 12) and np.isfinite(interp).all()
    # zero-centred: the outputs live on the [-1, 1] scale of the values
    assert interp.min() < 0.0
    text = open(os.path.join(run_dir, "config.txt")).read()
    assert "model_class : siren" in text and "zero_centered : True" in text and "w0 : 30.0" in text


def test_main_runs_the_tcnn_flags_on_the_cpu(volume, tmp_path):
    summary = _main(volume, tmp_path, "--n_levels", "4", "--n_features_per_level", "2", "--log2_hashmap_size", "10",
                    "--base_resolution", "4", "--per_level_scale", "1.5", "--dim_hidden", "16", "--n_layers", "2",
                    "--decoder", "relu_plain", "--lr", "1e-2", "--optimizer", "adam_tcnn", "--batch_size", "300")
    assert summary["model"] == "hash_mlp" and summary["steps"] == 2 * (16 * 12 * 6 // 300)
    assert np.isfinite(summary["psnr"]) and summary["param_count"] > 0
    text = open(os.path.join(summary["run_dir"], "config.txt")).read()
    assert "decoder : relu_plain" in text and "optimizer : adam_tcnn" in text


def test_main_reads_a_json_config(volume, tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text('{"encoding": {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,\n'
                    '  "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 2.0}, // tiny\n'
                    ' "network": {"n_neurons": 8, "n_hidden_layers": 2},\n'
                    ' "optimizer": {"learning_rate": 1e-2, "beta2": 0.99}}\n')
    summary = _main(volume, tmp_path / "runs", "--enco_config_path", str(path), "--decoder", "relu_plain",
                    "--batch_size", "500")
    text = open(os.path.join(summary["run_dir"], "config.txt")).read()
    assert "n_levels : 2" in text and "optimizer : adam_tcnn" in text and "finest_resolution : None" in text


@pytest.mark.parametrize("flag", [["--config_yaml", "x.yaml"], ["--plan"]])
def test_unported_cli_options_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launcher.main(flag + ["--device", "cpu", "--output_root", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
