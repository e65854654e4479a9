"""BENCHMARK.json and the files it names: every cell, configuration, mix,
metric and generator is found by name, and a new one is found as new files
and entries alone."""

import json
import re
import shutil

import pytest
from portbench_helpers import ROOT, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = spec.find_cell(BENCH, cell)
    assert c.name == cell and c.chips == 1
    assert c.config["name"] == c.config_name
    assert c.traffic["k"] == 10 and c.traffic["batch"] > 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert callable(spec.generator(c.config["data"]["generator"]))


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "no-such-cell")


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_config_files_lie_under_paths_and_match_their_entries():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"] and len(c["source"]) <= 200


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """What a later PR adds: a mix file, a metric reader and entries in
    BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    mix = json.loads((ROOT / "portbench/traffic/r95-b10k.json").read_text())
    mix["kwargs"] = {"nprobe": 6}
    (tmp_path / "portbench/traffic/r97-b10k.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/calls_traced.py").write_text(
        "def read(run):\n    return run.trace.calls if run.trace else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sift1m-ivf.r97-b10k", "config": "sift1m-ivf",
                               "traffic": "r97-b10k", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "qps",
                               "workloads": ["sift1m-ivf.r97-b10k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(spec.load_benchmark(tmp_path), "sift1m-ivf.r97-b10k", root=tmp_path)
    assert cell.traffic["kwargs"] == {"nprobe": 6}
    assert [m["name"] for m in cell.per_layer] == ["device_idle_pct", "index_build_s",
                                                    "calls_traced"]
    assert spec.metric_reader("calls_traced", root=tmp_path)(
        type("Run", (), {"trace": None})()) is None
