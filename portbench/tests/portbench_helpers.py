"""Shared by the benchmark's tests: the repository root on the path, cells
of BENCHMARK.json cut to a size the CPU runs in seconds, and a checkout
whose benchmark grew by new files and entries alone."""

from __future__ import annotations

import copy
import json
import shutil
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


def ingest_mix(kwargs: dict, **over) -> dict:
    """An ingest traffic mix through `search` at `kwargs`."""
    return {"why": "a test", "loop": "ingest", "clients": 1, "batch": 250, "k": 10,
            "entry": "search", "kwargs": kwargs, "prepare": [], "recall_floor": 0.95,
            "stream": 1216, "wave": 4, "readback_floor": 0.99, **over}


def grow(root: Path, configs: dict, mixes: dict, cells: dict, per_layer=()) -> Path:
    """A checkout at `root` whose BENCHMARK.json a later change grew by
    configurations ({name: file body}), mixes ({name: body}), cells
    ({name: (config, mix)}) and per-layer entries: new files and entries
    alone, the harness as it is."""
    shutil.copytree(ROOT / "portbench", root / "portbench")
    bench = spec.load_benchmark()
    for name, body in configs.items():
        body = {"name": name, **body}
        (root / f"portbench/configs/{name}.json").write_text(json.dumps(body))
        bench["configs"].append({"name": name, "source": body["source"],
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
    for name, body in mixes.items():
        (root / f"portbench/traffic/{name}.json").write_text(json.dumps(body))
    for name, (config, mix) in cells.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                   "why": "a test"})
    bench["per_layer"].extend(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def store(index: dict, **params) -> dict:
    """A configuration of the clustered pool under `index` ({class, kwargs})."""
    data = {"generator": "make_pool",
            "params": {"n_base": 3000, "n_queries": 1000, "dim": 16, "n_clusters": 16,
                       "store_seed": 10 ** 12, **params}}
    return {"source": "a test", "metric": "l2", "data": data, "index": index,
            "checks": {"dist_rel_err": 1e-3}, "reduced": []}
