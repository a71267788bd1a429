"""Port parity: the YAML run config (``configs.parse_yaml``,
``load_yaml_config``, ``launcher.main --config_yaml``) and ``config.txt``'s
reader (``parse_config_txt``) against the JAX package and PyYAML.

Exact: the reader returns what ``yaml.safe_load`` returns on the documents
of the JAX package's own YAML tests and on a hypothesis-generated set within
the subset (nested mappings, ints, floats written with a dot, booleans,
nulls, quoted and plain strings, flow lists and nested flow lists,
comments); ``load_yaml_config`` gives the JAX package's ``RunConfig`` field
for field. Outside the subset the reader raises. The one documented
difference: ``1e-3`` (a float without a dot) is the float of YAML 1.2's core
schema, where PyYAML (YAML 1.1) reads the string ``"1e-3"``.
"""

import os
import string
from dataclasses import fields

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mri_interpolation_tpu import configs as jconfigs
from mri_interpolation_tpu_torch import configs, launcher
from mri_interpolation_tpu_torch.io import nifti, synthetic_volume

# the documents of tests/test_launcher.py:55-113
REFERENCE_SCHEMA = """
training:
  epochs: 3
siren:
  cls: SirenNet
  dim_in: 3
  dim_hidden: 256
  dim_out: 1
  n_layers: 5
  w0: 30.0
  w0initial: 30.0
encoding:
  otype: "HashGrid"
  n_levels: 16
  n_features_per_level: 2
  log2_hashmap_size: 16
  base_resolution: 16
  per_level_scale: 2
datamodule:
  _target_: MriDataModule
  mri_path: "data/t2_111.nii.gz"
  output_path: "results_siren/"
  batch_size: 1
optimizer:
  _target_: FakeOptimizer
"""
RUN_SECTION = ("run:\n  model_class: hash_mlp\n  batch_size: 2048\n"
               "  base_resolution: [8, 8, 2]\n  interp_shapes: [[16, 16, 8]]\n")
CLI_FLAG = "run:\n  epochs: 9\n"
MORE = """# a run config with comments and every scalar form
run:   # the flat section
  model_class: 'hash_mlp'   # quoted
  lr: 0.01
  weight_decay: 1.0e-05
  zero_centered: false
  save_latents: True
  checkpoint_path: null
  lr_schedule: ~
  slice_z:
  interp_shapes: [[352, 352, 30], [352, 352, 60]]
  skip_connections: []
  output_root: runs/yaml # a comment after a plain string
optimizer:
  _target_: Adam
  lr: 0.003
"""
DOCUMENTS = {"reference_schema": REFERENCE_SCHEMA, "run_section": RUN_SECTION, "cli_flag": CLI_FLAG, "more": MORE}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_reader_equals_safe_load(name):
    assert configs.parse_yaml(DOCUMENTS[name]) == yaml.safe_load(DOCUMENTS[name])


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_load_yaml_config_matches_jax(tmp_path, name):
    path = tmp_path / "c.yaml"
    path.write_text(DOCUMENTS[name])
    for base in (None, "siren"):
        got = configs.load_yaml_config(str(path), configs.default_siren_config() if base else None)
        want = jconfigs.load_yaml_config(str(path), jconfigs.default_siren_config() if base else None)
        for f in fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_yaml_1_2_floats():
    assert configs.parse_yaml("a: 1e-3\nb: -2E+4\nc: .5\n") == {"a": 1e-3, "b": -2e4, "c": 0.5}


_AMBIGUOUS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}
KEYS = st.from_regex(r"[a-z_][a-z0-9_]{0,8}", fullmatch=True).filter(lambda s: s not in _AMBIGUOUS)
PLAIN = st.from_regex(r"[A-Za-z][A-Za-z0-9_./-]{0,12}", fullmatch=True).filter(
    lambda s: s.lower() not in _AMBIGUOUS)
QUOTED = st.text(alphabet=string.ascii_letters + string.digits + " _-./:#,[]", max_size=12)
FLOATS = st.floats(allow_nan=False, allow_infinity=False, width=32)
SCALARS = st.one_of(st.integers(-10**6, 10**6), FLOATS, st.booleans(), st.none(), PLAIN,
                    st.tuples(st.just("quoted"), QUOTED))
FLOW_ITEMS = st.one_of(st.integers(-999, 999), FLOATS, PLAIN)
FLOW = st.recursive(st.lists(FLOW_ITEMS, max_size=4), lambda inner: st.lists(inner, max_size=3), max_leaves=8)
DOCS = st.recursive(st.dictionaries(KEYS, st.one_of(SCALARS, FLOW), min_size=1, max_size=4),
                    lambda inner: st.dictionaries(KEYS, st.one_of(SCALARS, FLOW, inner), min_size=1, max_size=4),
                    max_leaves=12)


def _scalar_text(v):
    if isinstance(v, tuple):  # a double-quoted string
        return '"' + v[1] + '"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, float):
        return f"{v:.17e}"  # exact, with a dot and a signed exponent: a float in YAML 1.1 and 1.2
    if isinstance(v, list):
        return "[" + ", ".join(_scalar_text(x) for x in v) + "]"
    return str(v)


def _dump(doc, indent=0):
    lines = []
    for k, v in doc.items():
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:  # section")
            lines.extend(_dump(v, indent + 2))
        else:
            lines.append(" " * indent + f"{k}: {_scalar_text(v)}")
    return lines


def _plain(v):
    if isinstance(v, tuple):
        return v[1]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(DOCS)
def test_reader_equals_safe_load_on_generated_documents(doc):
    text = "\n".join(_dump(doc)) + "\n"
    got = configs.parse_yaml(text)
    assert got == yaml.safe_load(text)
    assert got == _plain(doc)


@pytest.mark.parametrize("text", [
    "a: &anchor 1\n", "a: *anchor\n", "a: !!str 1\n", "a:\n  - 1\n  - 2\n", "- 1\n", "a: |\n  text\n",
    "a: >\n  text\n", "a: {b: 1}\n", "a: 1\na: 2\n", "a: 1\n b: 2\n", "a:\n\tb: 1\n", "---\na: 1\n",
    "a: [1, 2\n", "a: [1, , 2]\n", "a: \"open\n", "a: yes\n", "a: off\n", "a: 0x1f\n", "a: 017\n",
    "a: 1_000\n", "a: .inf\n", "a: 1:30\n", "on: 1\n", "just text\n", "a: b: c\n", "a: 'x' y\n", "%YAML 1.2\na: 1\n",
], ids=lambda t: repr(t)[:24])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(configs.YamlSubsetError):
        configs.parse_yaml(text)


def test_parse_config_txt_matches_jax(tmp_path):
    cfg = configs.RunConfig(interp_shapes=((352, 352, 30), (16, 16, 8)), lr_schedule="cosine", slice_z=3)
    configs.export_to_txt(cfg, str(tmp_path) + os.sep)
    path = str(tmp_path / "config.txt")
    assert configs.parse_config_txt(path) == jconfigs.parse_config_txt(path)
    assert configs.parse_config_txt(path)["interp_shapes"] == "((352, 352, 30), (16, 16, 8))"


def test_main_runs_a_yaml_config(tmp_path):
    """``--config_yaml`` sits between the preset and the flags: the YAML's
    epochs and widths, the flag's batch size."""
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(synthetic_volume((12, 10, 6), seed=0), path)
    yml = tmp_path / "run.yaml"
    yml.write_text("run:\n  epochs: 2\n  dim_hidden: 8\n  n_levels: 2\n  base_resolution: [2, 2, 2]\n"
                   "  finest_resolution: [12, 10, 6]\n  interp_shapes: []\n  save_checkpoint: false\n"
                   "optimizer:\n  lr: 1.0e-2\n")
    summary = launcher.main(["--config_yaml", str(yml), "--image_path", path, "--batch_size", "240", "--device", "cpu",
                             "--output_root", str(tmp_path / "runs")])
    assert summary["steps"] == 2 * 3 and summary["batch_size"] == 240
    text = open(os.path.join(summary["run_dir"], "config.txt")).read()
    assert "dim_hidden : 8" in text and "lr : 0.01" in text and "interp_shapes : ()" in text
