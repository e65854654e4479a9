"""The benchmark's description, found by name.

`BENCHMARK.json` at the root of the checkout lists the cells, the
configurations and the metrics. A cell names a configuration (its file is
the configuration's `file`), a traffic mix (`portbench/traffic/<name>.json`)
and the chips it needs. A per-layer metric is read by
`portbench/metrics/<name>.py`, whose `read(run)` returns a number or None.
A data generator is `portbench/generators/<name>.py`, whose
`generate(gen, device, **params)` returns (base, queries). So a new cell,
configuration, mix, metric or generator is a new file and a new entry, and
no file here changes.

A mix's `loop` is the kind of traffic: `closed` (queries alone, the
default) or `ingest` (each call inserts the next wave of the base's last
`stream` rows, then queries: `harness/ingest.py`). `find_cell` refuses
any other kind (`cell_run.LOOPS` holds them), and an ingest mix whose
stream cannot feed the warm-up and every try of a traced run, or leaves
nothing to build from, before a run does any work.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """An end-to-end metric with no `workloads` key is every cell's; a
    per-layer one is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, mix and metrics loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"], root)
    check_traffic(traffic, config)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def check_traffic(mix: dict, config: dict) -> None:
    """Raise unless the harness can run `mix` on `config`: a known `loop`;
    for `ingest`, a `wave` of at least one row, a `readback_floor`, and a
    `stream` that holds the warm-up's waves and those of every try of a
    traced run (`trace.TRACE_TRIES`), and is shorter than the
    configuration's base."""
    from portbench.harness.cell_run import LOOPS
    from portbench.harness.loop import WARMUP_CALLS
    from portbench.harness.trace import TRACE_CALLS, TRACE_TRIES

    kind = mix.get("loop", "closed")
    if kind not in LOOPS:
        raise ValueError(f"traffic loop {kind!r}: the harness runs {sorted(LOOPS)}")
    if kind != "ingest":
        return
    for key in ("stream", "wave", "readback_floor"):
        if key not in mix:
            raise ValueError(f"an ingest mix needs {key!r}")
    stream, wave = int(mix["stream"]), int(mix["wave"])
    need = (WARMUP_CALLS + TRACE_TRIES * TRACE_CALLS) * wave
    n_base = config["data"]["params"]["n_base"]
    if wave < 1 or stream < need:
        raise ValueError(f"an ingest stream of {stream} rows in waves of {wave}: the warm-up "
                         f"and every try of a traced run take {need}")
    if stream >= n_base:
        raise ValueError(f"an ingest stream of {stream} rows leaves none of the base's "
                         f"{n_base} to build from")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "portbench" / "traffic" / f"{name}.json").read_text())


def _load_module(kind: str, name: str, root: Path):
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}__{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """`read(run) -> float | None` of the per-layer metric `name`."""
    return _load_module("metrics", name, root).read


def generator(name: str, root: Path = ROOT):
    """`generate(gen, device, **params) -> (base, queries)` of a data generator."""
    return _load_module("generators", name, root).generate
