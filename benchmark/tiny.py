"""Tiny stand-ins of the benchmark's cells, for the tests on the CPU.

Each keeps its cell's config kind, entry, traffic parameters and limits
and shrinks only the sizes: a 4-D grid of two levels, one of them hashed,
and a 3-D all-dense grid, on volumes and grids of a few hundred voxels.
"""

from __future__ import annotations

import copy
from pathlib import Path

from . import spec

SIZES = {
    "full4d": {"encoder": {"dim": 4, "n_levels": 2, "n_features_per_level": 2, "log2_hashmap_size": 6,
                           "base_resolution": [2, 2, 2, 2], "finest_resolution": [4, 4, 3, 3], "growth": "paper"},
               "dim_hidden": 8, "volume": [6, 6, 3, 4], "batch_size": 64, "grid": [6, 6, 3, 7], "chunk_size": 100},
    "flagship": {"encoder": {"dim": 3, "n_levels": 2, "n_features_per_level": 1, "log2_hashmap_size": 23,
                             "base_resolution": [4, 4, 3], "finest_resolution": [8, 8, 5], "growth": "reference"},
                 "dim_hidden": 8, "volume": [9, 9, 6], "batch_size": 81, "grid": [9, 9, 6], "chunk_size": 128},
}


def shrink(cell: spec.Cell) -> spec.Cell:
    """``cell`` at its config's tiny sizes."""
    cell = copy.deepcopy(cell)
    size = SIZES[cell.config["name"]]
    cell.config["encoder"] = dict(size["encoder"])
    cell.config["decoder"]["dim_hidden"] = size["dim_hidden"]
    cell.config["volume"] = list(size["volume"])
    cell.config["train"]["batch_size"] = size["batch_size"]
    if "grid" in cell.workload:
        cell.workload["grid"] = list(size["grid"])
        cell.workload["chunk_size"] = size["chunk_size"]
    return cell


def tiny_cell(name: str, root: Path = spec.ROOT) -> spec.Cell:
    return shrink(spec.load_cell(name, root))
