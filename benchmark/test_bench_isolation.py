"""The benchmark stands apart and is driven by data, on the CPU:

- no module under ``benchmark/`` imports JAX or the JAX package (the
  top-level name compared whole: the port's name begins with the JAX
  package's); the reference, the roofline counts and the data they are fed
  import nothing of the port;
- ``BENCHMARK.json`` keeps to the benchmark's contract's shapes, every cell
  has its workload file naming an existing config, and every per-layer
  metric has a reader and is read only in cells that report its ``moves``;
- a configuration, a cell, a per-layer metric and a kernel family added as
  new files are found by name, and the new cell runs.
"""

import ast
import functools
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run, spec, tiny, trace

BENCH = spec.BENCH_DIR
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mri_interpolation_tpu")
STANDALONE = ("reference.py", "roofline.py", "data.py")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
_ORIGINAL_LOAD = spec.load_cell


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((alias.name, 0) for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "", node.level)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH.parent)))
def test_no_jax_import(path):
    for module, level in _imports(path):
        assert level or module.split(".")[0] not in FORBIDDEN, f"{path.name} imports {module}"


@pytest.mark.parametrize("name", STANDALONE)
def test_reference_side_imports_nothing_of_the_port(name):
    for module, level in _imports(BENCH / name):
        if level:
            assert module in ("reference",), f"{name} imports .{module}"
        else:
            assert module.split(".")[0] in ("__future__", "math", "dataclasses", "typing", "numpy", "torch"), \
                f"{name} imports {module}"


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((BENCH.parent / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["name"] == f"{w['config']}.{w['traffic']}"
        cell = spec.load_cell(w["name"])
        assert [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"], w["name"]
        assert cell.per_layer, w["name"]


def test_workloads_name_existing_configs():
    configs = {p.stem for p in (BENCH / "configs").glob("*.json")}
    for path in (BENCH / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        assert wl["config"] in configs, path.name
        assert (BENCH / "entries" / f"{wl['entry']}.py").exists(), path.name


@pytest.mark.parametrize("metric", spec.load_benchmark()["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_have_readers_and_move_a_reported_metric(metric):
    bench = spec.load_benchmark()
    assert spec.metric_reader(metric["name"]) is not None
    moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
    assert len(moved) == 1
    cells = metric.get("workloads", [w["name"] for w in bench["workloads"]])
    assert all(c in moved[0].get("workloads", cells) for c in cells)


def test_a_cell_added_as_files_is_found_and_runs(tmp_path, monkeypatch, capsys):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    config = json.loads((BENCH / "configs" / "full4d.json").read_text())
    config.update(name="tiny4d", encoder=tiny.SIZES["full4d"]["encoder"], volume=[4, 4, 3, 4])
    config["train"]["batch_size"] = 16
    config["decoder"]["dim_hidden"] = 8
    (root / "benchmark" / "configs" / "tiny4d.json").write_text(json.dumps(config))
    workload = json.loads((BENCH / "workloads" / "full4d.fit.json").read_text())
    workload["config"] = "tiny4d"
    (root / "benchmark" / "workloads" / "tiny4d.fit.json").write_text(json.dumps(workload))
    (root / "benchmark" / "metrics" / "steps_traced.py").write_text("def read(ctx):\n    return ctx.units\n")
    (root / "benchmark" / "kernels" / "probe.json").write_text(json.dumps({"work": "probe", "patterns": ["probe_double_kernel"]}))
    bench["configs"].append({"name": "tiny4d", "source": "https://arxiv.org/abs/2201.05989",
                             "file": "benchmark/configs/tiny4d.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny4d.fit", "config": "tiny4d", "traffic": "fit", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny4d.fit")
    bench["per_layer"].append({"name": "steps_traced.fit", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "trainer", "moves": "fit_voxels_per_s",
                               "workloads": ["tiny4d.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny4d.fit", root)
    assert cell.config["name"] == "tiny4d" and "steps_traced.fit" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("steps_traced.fit", root / "benchmark") is not None
    assert "probe" in trace.kernel_families(root / "benchmark" / "kernels")

    monkeypatch.setattr(spec, "load_cell", functools.partial(_ORIGINAL_LOAD, root=root))
    monkeypatch.setattr(run, "require_chips", lambda n: torch.device("cpu"))
    assert run.main(["--workload", "tiny4d.fit", "--seed", "5", "--seconds", "0.2", "--trace", "0"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {"fit_voxels_per_s", "setup_s"}
