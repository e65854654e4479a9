"""The ingest cell `sift1m-hnsw.insert-waves` and the readers of its
insert path: the spec accepts its mix (its stream feeds the warm-up and
every try of a traced run); `insert_share_pct`, `insert_ms_per_krow` and
`insert_idle_pct` read known answers off hand-built traces, None off a
closed cell's trace; and on a tiny traced ingest run of a bulk-built
HNSW graph, with the profiler's device spans faked on the CPU, each
reads a number."""

import json
from types import SimpleNamespace

import pytest
import torch
from portbench_helpers import grow, ingest_mix, spec, store

from portbench.harness import spans, trace
from portbench.harness.cell_run import run_cell
from portbench.harness.loop import WARMUP_CALLS

CELL = "sift1m-hnsw.insert-waves"
READERS = ("insert_share_pct", "insert_ms_per_krow", "insert_idle_pct")
INSERT = "turdb.hnsw.insert"


def _read(name, tr):
    return spec.metric_reader(name)(SimpleNamespace(trace=tr))


def test_the_spec_takes_the_cells_mix():
    cell = spec.find_cell(spec.load_benchmark(), CELL)
    mix = cell.traffic
    assert mix["loop"] == "ingest" and mix["entry"] == "search" and cell.chips == 1
    least = (WARMUP_CALLS + trace.TRACE_TRIES * trace.TRACE_CALLS) * mix["wave"]
    assert least <= mix["stream"] < cell.config["data"]["params"]["n_base"]
    assert mix["readback_floor"] >= 0.90 and mix["recall_floor"] == 0.95
    assert [m["name"] for m in cell.per_layer if m["layer"] == "ingest"] == list(READERS)


# two calls of a 1,000 µs window: waves 0-300 and 500-600 inside the calls
# 0-400 and 500-1000; the device busy 100-200 and 250-300 in the first
# wave, 550-600 in the second, 700-900 in the query
HOST = [(0.0, 400.0, trace.CALL), (0.0, 300.0, trace.INSERT), (10.0, 300.0, INSERT),
        (500.0, 1000.0, trace.CALL), (500.0, 600.0, trace.INSERT), (510.0, 600.0, INSERT),
        (650.0, 950.0, "turdb.hnsw.search")]
DEVICE = [(100.0, 200.0, "k"), (250.0, 300.0, "k"), (550.0, 600.0, "k"), (700.0, 900.0, "k")]


def _trace(host=HOST, device=DEVICE):
    return trace.Trace(window=(0.0, 1000.0), device=device, host=host, calls=2, queries=20,
                       sets=[0, 1])


def test_the_readers_by_hand(monkeypatch):
    # a retried trace: the counters hold three waves of 200 rows, the kept trace two
    monkeypatch.setattr(spans, "program_counters",
                        lambda: {f"{INSERT}.rows": 600, f"{INSERT}.waves": 3})
    tr = _trace()
    assert _read("insert_share_pct", tr) == pytest.approx(100.0 * 400 / 900)
    # 0.2 ms of device time over 400 rows
    assert _read("insert_ms_per_krow", tr) == pytest.approx(0.2 / 0.4)
    # idle 10-100, 200-250 and 510-550 inside the program's spans
    assert _read("insert_idle_pct", tr) == pytest.approx(100.0 * 180 / 1000)


def test_a_closed_cell_or_an_older_port_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: {})
    closed = _trace(host=[h for h in HOST if h[2] not in (trace.INSERT, INSERT)])
    for name in READERS:
        assert _read(name, closed) is None, name
        assert _read(name, None) is None, name
    # the parent's program: the harness's waves, none of the program's spans
    older = _trace(host=[h for h in HOST if h[2] != INSERT])
    assert _read("insert_share_pct", older) == pytest.approx(100.0 * 400 / 900)
    assert _read("insert_ms_per_krow", older) is None
    assert _read("insert_idle_pct", older) is None


def test_a_traced_ingest_run_of_a_bulk_graph_reads_each(tmp_path, monkeypatch):
    """The profiler on the CPU keeps no device span: one is faked over the
    first half of each of the program's insert spans. Five traced calls
    (the CPU profiler's events of a hundred take minutes to read)."""
    from turdb_tpu_torch.utils import timing

    monkeypatch.setattr(trace, "TRACE_CALLS", 5)
    wave = 2
    least = (WARMUP_CALLS + trace.TRACE_TRIES * trace.TRACE_CALLS) * wave
    root = grow(tmp_path, configs={"tiny-hnsw": store({"class": "HnswIndex", "kwargs": {
                    "capacity": 4096, "bulk_threshold": 1024}})},
                mixes={"tiny-insert": ingest_mix({"ef": 32}, stream=least, wave=wave, batch=10,
                                                 readback_floor=0.9)},
                cells={"tiny-hnsw.insert": ("tiny-hnsw", "tiny-insert")})
    bench = spec.load_benchmark(root)
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("tiny-hnsw.insert")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    real = trace.from_events

    def device_in_the_waves(events, *args):
        tr = real(events, *args)
        tr.device = [(s, (s + e) / 2, "k") for s, e, name in tr.host if name == INSERT]
        return tr
    monkeypatch.setattr(trace, "from_events", device_in_the_waves)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    timing.reset()
    out, checks = run_cell(spec.find_cell(bench, "tiny-hnsw.insert", root=root), 2 ** 33 + 9,
                           60.0, True, "cpu", 0.0)
    timing.reset()
    assert out["correct"] is True, {n: c["value"] for n, c in checks.items()}
    got = {name: out["metrics"][name]["value"] for name in READERS}
    assert 0 < got["insert_share_pct"] < 100
    assert got["insert_ms_per_krow"] > 0
    assert 0 < got["insert_idle_pct"] < 100
