"""The readers of the program's spans and counters on hand-built traces and
counter sets with known answers: idle time split exactly between the
staging spans and the rest of the entry (idle straddling a span's edge,
staging nested in the entry), the work a query and the beams' rooflines
from the counters, and None where the program left nothing to read."""

from types import SimpleNamespace

import pytest
from portbench_helpers import spec

from portbench.harness import roofline, spans, trace


def _trace(device, host, window=(0.0, 1000.0), queries=1000):
    return trace.Trace(window=window, device=device, host=host, calls=1, queries=queries,
                       sets=[0])


def _run(tr, dim=4):
    cell = SimpleNamespace(config={"data": {"params": {"dim": dim}}})
    return SimpleNamespace(trace=tr, cell=cell)


def _read(name, run):
    return spec.metric_reader(name)(run)


# device busy 200-400 and 600-700 of a 1,000 µs window: idle 0-200, 400-600, 700-1000
DEVICE = [(200.0, 300.0, "k"), (250.0, 400.0, "k"), (600.0, 700.0, "k")]
HOST = [
    (0.0, 900.0, "turdb.hnsw.search"),
    (100.0, 250.0, "turdb.stage_in"),       # idle 100-200 inside it, its tail busy
    (350.0, 450.0, "turdb.hnsw.descent"),   # not staging: idle 400-450 is the entry's
    (650.0, 800.0, "turdb.stage_out"),      # straddles the busy span's end: idle 700-800
    (700.0, 750.0, "aten::copy_"),          # nested inside staging: counted once
    (950.0, 990.0, "portbench.client"),
]


def test_interval_arithmetic():
    a = spans.union([(5, 7), (0, 2), (1, 3), (8, 8)])
    assert a == [[0, 3], [5, 7]]
    assert spans.intersect(a, [[2, 6]]) == [[2, 3], [5, 6]]
    assert spans.subtract([[0, 10]], [[2, 3], [5, 6], [9, 12]]) == [[0, 2], [3, 5], [6, 9]]
    assert spans.subtract([[0, 3], [5, 7]], [[-1, 1], [6, 6.5]]) == [[1, 3], [5, 6], [6.5, 7]]
    assert spans.length([[0, 2], [3, 5]]) == 4


def test_idle_split_between_staging_entry_and_client():
    tr = _trace(DEVICE, HOST)
    assert spans.idle(tr) == [[0.0, 200.0], [400.0, 600.0], [700.0, 1000.0]]
    staging = _read("idle_staging_pct", _run(tr))
    entry = _read("idle_entry_pct", _run(tr))
    # staging: 100-200 and 700-800
    assert staging == pytest.approx(20.0)
    # the entry less staging over idle: 0-100, 400-600, 800-900
    assert entry == pytest.approx(40.0)
    idle = _read("device_idle_pct", _run(tr))
    assert idle == pytest.approx(70.0) and staging + entry <= idle


def test_staging_outside_the_window_is_clipped():
    tr = _trace(DEVICE, [(-50.0, 50.0, "turdb.stage_in"), (-60.0, 60.0, "turdb.ivf.search")])
    assert _read("idle_staging_pct", _run(tr)) == pytest.approx(5.0)
    assert _read("idle_entry_pct", _run(tr)) == pytest.approx(1.0)


def test_a_trace_without_the_programs_spans_reads_none():
    tr = _trace(DEVICE, [(0.0, 900.0, "portbench.call"), (10.0, 20.0, "cudaMemcpyAsync")])
    assert _read("idle_staging_pct", _run(tr)) is None
    assert _read("idle_entry_pct", _run(tr)) is None
    assert _read("idle_staging_pct", _run(None)) is None


def _counters(monkeypatch, counts):
    monkeypatch.setattr(spans, "program_counters", lambda: dict(counts))


def test_counter_readers_without_counters_read_none(monkeypatch):
    _counters(monkeypatch, {})
    tr = _trace([(0.0, 500.0, "graph_beam_kernel"), (0.0, 500.0, "serve_beam_kernel")], [])
    for name in ("probe_lanes_per_q", "graph_beam_rows_per_q", "graph_beam_roofline_pct",
                 "graph_descent_ms_per_kq", "serve_beam_rows_per_q", "serve_beam_roofline_pct"):
        assert _read(name, _run(tr)) is None, name


def test_an_older_port_without_counters_reads_none(monkeypatch):
    import turdb_tpu_torch.utils.timing as timing

    monkeypatch.delattr(timing, "counters")
    assert spans.program_counters() == {}


def test_probe_lanes_and_rows_a_query(monkeypatch):
    _counters(monkeypatch, {
        "turdb.ivf.probe.lanes": 3000, "turdb.ivf.probe.queries": 10,
        "turdb.hnsw.descent.scored": 500, "turdb.hnsw.beam.scored": 1500,
        "turdb.hnsw.beam.queries": 4,
        "turdb.serve.beam.scored": 900, "turdb.serve.beam.queries": 3})
    run = _run(_trace([], []))
    assert _read("probe_lanes_per_q", run) == 300
    assert _read("graph_beam_rows_per_q", run) == 500
    assert _read("serve_beam_rows_per_q", run) == 300


K8 = "void graph_beam_kernel<GraphScorer>(BeamArgs)"


def test_graph_descent_is_each_calls_k8_launches_but_the_last():
    host = [(0.0, 400.0, "turdb.hnsw.search"), (10.0, 380.0, "turdb.hnsw.descent"),
            (500.0, 900.0, "turdb.hnsw.search"), (950.0, 990.0, "portbench.client")]
    device = [
        (20.0, 60.0, K8), (70.0, 130.0, K8), (140.0, 220.0, K8),   # the descent: 180 µs
        (150.0, 160.0, "memcpy"),                                  # not K8
        (230.0, 330.0, K8),                                        # level 0
        (520.0, 540.0, K8), (600.0, 700.0, K8),                    # 20 µs, then level 0
        (920.0, 940.0, K8),                                        # in no entry span
    ]
    tr = _trace(device, host, queries=2000)
    # 200 µs of the descent over 2,000 queries
    assert _read("graph_descent_ms_per_kq", _run(tr)) == pytest.approx(0.1)
    assert _read("graph_descent_ms_per_kq", _run(tr)) < _read("graph_beam_ms_per_kq", _run(tr))


def test_graph_descent_without_entry_spans_or_k8_reads_none():
    device = [(20.0, 60.0, K8), (70.0, 130.0, K8)]
    assert _read("graph_descent_ms_per_kq", _run(_trace(device, []))) is None
    host = [(0.0, 400.0, "turdb.hnsw.search")]
    assert _read("graph_descent_ms_per_kq", _run(_trace([(20.0, 60.0, "k")], host))) is None
    # a greedy descent: one K8 launch a call, level 0's
    assert _read("graph_descent_ms_per_kq", _run(_trace(device[:1], host))) == 0.0


GRAPH = {f"turdb.hnsw.{p}.{u}": v for p, vals in
         (("descent", (100, 300, 3000, 310)), ("beam", (200, 700, 1000, 3200)))
         for u, v in zip(("list_entries", "scored", "queries", "seeds"), vals)}


def test_graph_beam_roofline(monkeypatch):
    _counters(monkeypatch, GRAPH)
    d = 4
    # 4 B a list entry, (4d + 4) a row scored and a query a launch, 8 B a seed
    nbytes = 4 * 300 + 20 * 1000 + 20 * 4000 + 8 * 3510
    tr = _trace([(0.0, 1.0, "void graph_beam_kernel<GraphScorer>"), (1.0, 3.0, "other")], [],
                queries=1000)
    want = roofline.bound(nbytes, 2 * d * 1000, roofline.FP32_OPS)["bound_ms"] / 1e-3 * 100
    assert _read("graph_beam_roofline_pct", _run(tr, d)) == pytest.approx(want)
    # a trace taken again: the counters hold both windows' calls, the kept
    # trace half of them, so the bound is taken for the kept trace's queries
    tr.queries = 500
    assert _read("graph_beam_roofline_pct", _run(tr, d)) == pytest.approx(want / 2)


def test_serve_beam_roofline_counts_k6_alone(monkeypatch):
    _counters(monkeypatch, {"turdb.serve.beam.list_entries": 6400,
                            "turdb.serve.beam.scored": 3000, "turdb.serve.beam.reranked": 320,
                            "turdb.serve.beam.queries": 10, "turdb.serve.beam.seeds": 320})
    d = 8
    nbytes = 16 * 6400 + d * 3000 + (4 * d + 4) * 320 + (5 * d + 12) * 10 + 8 * 320
    b = roofline.bound(nbytes, [(2 * d * 3000, roofline.INT8_OPS),
                                (2 * d * 320, roofline.FP32_OPS)])
    tr = _trace([(0.0, 2.0, "serve_beam_kernel<ServeScorer>"),
                 (2.0, 50.0, "void probe_chunk_kernel<Sq8Groups>")], [], queries=10)
    got = _read("serve_beam_roofline_pct", _run(tr, d))
    assert got == pytest.approx(100.0 * b["bound_ms"] / 2e-3)
    assert 0 < got


def test_rooflines_without_their_kernel_read_none(monkeypatch):
    _counters(monkeypatch, GRAPH)
    tr = _trace([(0.0, 1.0, "other")], [])
    assert _read("graph_beam_roofline_pct", _run(tr)) is None
    assert _read("serve_beam_roofline_pct", _run(tr)) is None
