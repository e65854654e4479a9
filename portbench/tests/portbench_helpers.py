"""Shared by the benchmark's CPU tests: the repository root on the path, and
cells of BENCHMARK.json cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402

TINY = {"n_base": 4000, "n_queries": 2000, "n_clusters": 32}


def tiny_cell(name: str, batch: int = 500, **data) -> spec.Cell:
    """The cell `name` with its data and calls cut to a CPU test's size
    (its configuration, mix and metrics as BENCHMARK.json gives them)."""
    cell = spec.find_cell(spec.load_benchmark(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    params = {**TINY, **data}
    cell.config["data"]["params"].update(params)
    kwargs = cell.config["index"].get("kwargs", {})
    if "capacity" in kwargs:
        kwargs["capacity"] = params["n_base"]
    if "yardstick" in cell.config:
        cell.config["yardstick"]["partition_cells"] = params["n_base"] // 128
    cell.traffic["batch"] = batch
    return cell
