"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's root
lists the cells and metrics; ``workloads/<cell>.json`` names the cell's
config, entry and traffic parameters and the limits of its comparison;
``configs/<config>.json`` holds the model's sizes and recipe;
``entries/<entry>.py`` and ``models/<model>.py`` are the code paths;
``metrics/<metric>.py`` reads a per-layer metric (``<metric>`` is the whole
name, or the part before its first dot, so that ``mfu_pct.fit`` and
``mfu_pct.interp`` share ``mfu_pct.py``). Adding a cell, a config, a metric
or a kernel family adds files and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    workload: Dict
    end_to_end: List[Dict]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict]  # and with --trace 1


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its workload and config."""
    bench = load_benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    bench_dir = root / BENCH_DIR.name
    workload = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entries[0]["config"] or workload["traffic"] != entries[0]["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json on its config or traffic")
    config = json.loads((bench_dir / "configs" / f"{workload['config']}.json").read_text())
    return Cell(name=name, chips=int(entries[0]["chips"]), config=config, workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def entry(cell: Cell) -> ModuleType:
    """``entries/<entry>.py``: ``run(cell, seed, seconds, trace, device, t_start)``."""
    return importlib.import_module(f"{__package__}.entries.{cell.workload['entry']}")


def model_builder(config: Dict) -> Callable:
    """``models/<model>.py``'s ``build(config, device)``: the port's model."""
    return importlib.import_module(f"{__package__}.models.{config['model']}").build


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Optional[Callable]:
    """``read(ctx)`` of ``metrics/<name>.py``, else of ``metrics/<stem>.py``
    where the stem is the name before its first dot; None if neither."""
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    return None
