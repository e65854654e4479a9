"""Spans and work counters inside the search entries (utils/timing.py).

- with no profiler running a search records nothing: no range, no counter,
  no TIMERS entry, no CUDA event;
- under `torch.profiler` each entry's spans nest as the layers do;
- the beams' counters equal the sums of the `stats` the plain beams return,
  and the probe's lanes the live lanes of the cells the plain selection
  picks;
- the probe's per-cell live lanes follow deletes and inserts;
- the cell selection counts its queries and those K12 takes;
- an insert wave's spans nest as its phases, its rows and waves are
  counted, and on a bulk graph the descent's beams count their work; no
  profiler, nothing recorded;
- `counters` resolves ints, tensors and callables once; `profile_trace`
  hands back its block's counters; `device_summary` takes its window from
  the host's range, not from the device's first and last spans.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turdb_tpu_torch import kernels
from turdb_tpu_torch.models import HnswIndex, IvfIndex
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.models import hnsw_serve as ths
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.utils import timing

torch.set_num_threads(1)

DIM, K = 16, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    c = rng.standard_normal((16, DIM)).astype(np.float32) * 4.0
    x = (c[rng.integers(0, 16, 3000)] + rng.standard_normal((3000, DIM))).astype(np.float32)
    q = (c[rng.integers(0, 16, 40)] + rng.standard_normal((40, DIM))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def graph(data):
    """A bulk-built graph (so its descent runs K8 beams) and its serving pack."""
    idx = HnswIndex(dim=DIM, capacity=3000, bulk_threshold=1024, device="cpu")
    idx.add(data[0])
    idx.pack_serving()
    assert idx._descent_ef > 1
    return idx


@pytest.fixture(scope="module")
def ivf(data):
    idx = IvfIndex(dim=DIM, device="cpu")
    idx.add(data[0])
    return idx


@pytest.fixture(autouse=True)
def _clean():
    timing.reset()
    yield
    timing.reset()


ENTRIES = {
    "ivf": lambda idx, q: idx["ivf"].search(q, K, nprobe=4),
    "graph": lambda idx, q: idx["graph"].search(q, K, ef=32),
    "serve": lambda idx, q: idx["graph"].search_serve(q, K, ef=32),
}

NESTING = {
    "ivf": {("turdb.ivf.search", None), ("turdb.stage_in", "turdb.ivf.search"),
            ("turdb.ivf.select", "turdb.ivf.search"), ("turdb.ivf.probe", "turdb.ivf.search"),
            ("turdb.stage_out", "turdb.ivf.search")},
    "graph": {("turdb.hnsw.search", None), ("turdb.stage_in", "turdb.hnsw.search"),
              ("turdb.hnsw.descent", "turdb.hnsw.search"),
              ("turdb.hnsw.beam", "turdb.hnsw.search"), ("turdb.hnsw.merge", "turdb.hnsw.search"),
              ("turdb.stage_out", "turdb.hnsw.search")},
    "serve": {("turdb.hnsw.search_serve", None), ("turdb.stage_in", "turdb.hnsw.search_serve"),
              ("turdb.serve.seed", "turdb.hnsw.search_serve"),
              ("turdb.serve.beam", "turdb.hnsw.search_serve"),
              ("turdb.stage_out", "turdb.hnsw.search_serve")},
}


@pytest.fixture(scope="module")
def indexes(graph, ivf):
    return {"graph": graph, "ivf": ivf}


def _refuse(*a, **kw):
    raise AssertionError("built while no profiler runs")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_profiler_records_nothing(indexes, data, entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(timing, "_Range", _refuse)
    assert not timing.tracing()
    d, i = ENTRIES[entry](indexes, data[1])
    assert i.shape == (len(data[1]), K)
    assert timing.counters() == {}
    assert dict(timing.TIMERS) == {}


def _turdb_events(prof):
    return {(e.name, e.cpu_parent.name if e.cpu_parent is not None else None)
            for e in prof.events() if e.name.startswith("turdb.")}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_nest_as_the_layers(indexes, data, entry):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ENTRIES[entry](indexes, data[1])
    assert _turdb_events(prof) == NESTING[entry]


def test_ivf_rerank_span_under_the_search(data):
    idx = IvfIndex(dim=DIM, sq8=True, device="cpu")
    idx.add(data[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(data[1], K, nprobe=4, out="torch")
    got = _turdb_events(prof)
    assert ("turdb.ivf.rerank", "turdb.ivf.search") in got
    assert not any(name == "turdb.stage_out" for name, _ in got)   # out="torch" stays put


def _recording(plain, calls):
    def beam(*a, **kw):
        out = plain(*a, **kw)
        calls.append((a[0].shape[1], a[5].shape[1], out))
        return out
    return beam


def _expected(calls):
    out = {"queries": 0, "seeds": 0, "scored": 0, "list_entries": 0}
    for deg, s, stats in calls:
        tot = stats.long().sum(0)
        out["queries"] += stats.shape[0]
        out["seeds"] += stats.shape[0] * s
        out["scored"] += int(tot[1])
        out["list_entries"] += int(tot[0]) * deg
    return out


def test_graph_beam_counters_equal_the_plain_beams_stats(graph, data, monkeypatch):
    calls = []
    monkeypatch.setattr(th, "hnsw_graph_beam", _recording(kernels.hnsw_graph_beam_plain, calls))
    with profile(activities=[ProfilerActivity.CPU]):
        graph.search(data[1], K, ef=32)
    stats = [(deg, s, r.stats) for deg, s, r in calls]
    level0 = [c for c in stats if c[0] == graph.state.adj0.shape[1]]
    upper = [c for c in stats if c[0] != graph.state.adj0.shape[1]]
    assert len(level0) == 1 and len(upper) == graph.cfg.max_levels - 1
    got = timing.counters()
    for prefix, part in (("turdb.hnsw.beam", level0), ("turdb.hnsw.descent", upper)):
        want = _expected(part)
        assert {u: got[f"{prefix}.{u}"] for u in want} == want
        assert want["scored"] > 0


def test_serve_beam_counters_equal_the_plain_beams_stats(graph, data, monkeypatch):
    calls = []

    def beam(*a, **kw):
        out = kernels.hnsw_serve_beam_plain(*a, **kw)
        calls.append((a[0].shape[1], a[9].shape[1], out[2], kw))
        return out

    monkeypatch.setattr(ths, "hnsw_serve_beam", beam)
    with profile(activities=[ProfilerActivity.CPU]):
        graph.search_serve(data[1], K, ef=32, rerank=16)
        graph.search_serve(data[1][:7], K, ef=24)
    got = timing.counters()
    want = _expected([c[:3] for c in calls])
    want["reranked"] = sum(st.shape[0] * min(kw["rerank"] or kw["ef"], kw["ef"])
                           for _, _, st, kw in calls)
    assert want["reranked"] == 40 * 16 + 7 * 24
    assert {u: got[f"turdb.serve.beam.{u}"] for u in want} == want
    assert want["scored"] <= want["list_entries"]


def test_probe_lanes_are_the_live_lanes_of_the_selected_cells(ivf, data):
    with profile(activities=[ProfilerActivity.CPU]):
        ivf.search(data[1], K, nprobe=4)
    st = ivf.state
    q = torch.as_tensor(data[1])
    dist = (q * q).sum(1, keepdim=True) + st.cnorms[None, :] - 2.0 * (q @ st.centroids.T)
    cells = torch.topk(dist, 4, dim=1, largest=False).indices
    want = int(st.alive.sum(1)[cells].sum())
    got = timing.counters()
    assert got["turdb.ivf.probe.queries"] == len(data[1])
    assert got["turdb.ivf.probe.lanes"] == want > 0


@pytest.fixture(scope="module")
def dense(data):
    idx = IvfIndex(dim=DIM, dense_pack=True, nblocks=2, device="cpu")
    idx.add(data[0])
    return idx


@pytest.mark.parametrize("entry, fused", [("ivf", False), ("ivf", True), ("serve", False),
                                          ("serve", True), ("dense", True), ("graph", True)])
def test_select_counters_count_the_queries_and_the_fused_ones(indexes, dense, data, entry,
                                                              fused, monkeypatch):
    """`turdb.ivf.select.{queries, fused}`: every query of a cell selection
    (IVF search, serve's seeding), and those K12 takes (on the CPU none: the
    route is patched to say it would); never the dense path's (K10 inside
    K2); the graph search selects no cells."""
    if fused:
        monkeypatch.setattr(tivf, "cell_select_fused", lambda *a: True)
    search = (lambda q: dense.search(q, K, nprobe=4)) if entry == "dense" else \
        (lambda q: ENTRIES[entry](indexes, q))
    with profile(activities=[ProfilerActivity.CPU]):
        search(data[1])
        search(data[1][:7])
    got = timing.counters()
    if entry == "graph":
        assert not any(name.startswith("turdb.ivf.select") for name in got)
        return
    n = len(data[1]) + 7
    assert got["turdb.ivf.select.queries"] == n
    assert got["turdb.ivf.select.fused"] == (n if fused and entry != "dense" else 0)


def test_probe_lanes_follow_deletes_and_inserts(data):
    idx = IvfIndex(dim=DIM, device="cpu")
    idx.add(data[0])
    st = idx.state
    assert torch.equal(st.lanes, st.alive.sum(1))
    idx.delete(np.arange(0, 3000, 7))
    assert torch.equal(st.lanes, st.alive.sum(1))
    idx.add(data[1])
    assert torch.equal(idx.state.lanes, idx.state.alive.sum(1))


INSERT_NESTING = {("turdb.hnsw.insert", None),
                  ("turdb.hnsw.insert.descent", "turdb.hnsw.insert"),
                  ("turdb.hnsw.insert.connect", "turdb.hnsw.insert"),
                  ("turdb.hnsw.insert.reverse", "turdb.hnsw.insert")}


def _graph_to_grow(graph, data, kind):
    """A copy of the bulk graph, or a small graph built by waves."""
    if kind == "waves":
        idx = HnswIndex(dim=DIM, bulk_threshold=10**9, device="cpu")
        idx.add(data[0][:200])
        return idx
    idx = copy.copy(graph)
    st = graph.state
    idx.state = st._replace(vectors=st.vectors.clone(), norms=st.norms.clone(),
                            adj0=st.adj0.clone(), adj_hi=tuple(a.clone() for a in st.adj_hi),
                            levels=st.levels.clone())
    idx._alive = graph._alive.copy()
    return idx


@pytest.mark.parametrize("kind", ("bulk", "waves"))
def test_insert_spans_nest_and_count_the_rows(graph, data, kind):
    idx = _graph_to_grow(graph, data, kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.add(data[1])
    assert _turdb_events(prof) == INSERT_NESTING
    got = timing.counters()
    assert got["turdb.hnsw.insert.rows"] == len(data[1])
    assert got["turdb.hnsw.insert.waves"] == 1
    assert got["turdb.hnsw.insert.connect.scored"] > 0
    assert got["turdb.hnsw.insert.connect.list_entries"] > 0
    if kind == "bulk":
        assert idx._descent_ef > 1
        assert got["turdb.hnsw.insert.descent.scored"] > 0
        assert got["turdb.hnsw.insert.descent.list_entries"] > 0
    else:   # the greedy walk (K9) counts nothing
        assert not any(name.startswith("turdb.hnsw.insert.descent") for name in got)


def test_an_insert_without_the_profiler_records_nothing(graph, data, monkeypatch):
    idx = _graph_to_grow(graph, data, "bulk")
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(timing, "_Range", _refuse)
    np.testing.assert_array_equal(idx.add(data[1]), np.arange(3000, 3000 + len(data[1])))
    assert timing.counters() == {}
    assert dict(timing.TIMERS) == {}


def test_counters_resolve_ints_tensors_and_callables_once():
    with profile(activities=[ProfilerActivity.CPU]):
        timing.count("a", 3)
        timing.count("a", torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
        t = torch.tensor([5, 6])
        timing.count("b", lambda: t * 2)
    timing.count("a", 100)   # the profiler has stopped: not counted
    assert timing.counters() == {"a": 13, "b": 22}
    t.zero_()                # resolved once, kept as the total
    assert timing.counters() == {"a": 13, "b": 22}
    timing.reset()
    assert timing.counters() == {}


def test_timed_keeps_its_timers_and_opens_a_range_while_tracing():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.timed("parse"):
            pass
    assert timing.TIMERS["parse"]["count"] == 1
    assert any(e.name == "parse" for e in prof.events())


def test_profile_trace_holds_its_blocks_counters(graph, data, tmp_path, monkeypatch):
    """On the CPU with the card faked: the block's counters come back in the
    dict, those counted before it do not."""
    real = torch.profiler.profile

    class CpuProfile(real):
        def __init__(self, activities=None, **kw):
            super().__init__(activities=[ProfilerActivity.CPU], **kw)

        def events(self):
            return list(super().events()) + [
                SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA)]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", CpuProfile)
    with real(activities=[ProfilerActivity.CPU]):
        timing.count("turdb.hnsw.beam.queries", 1000)
    with timing.profile_trace(tmp_path / "trace") as info:
        graph.search(data[1], K, ef=32)
    assert info["counters"]["turdb.hnsw.beam.queries"] == len(data[1])
    assert info["counters"]["turdb.hnsw.beam.scored"] > 0
    assert info["device_spans"] == 1


def _ev(name, s, e, device="CPU", annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type=f"DeviceType.{device}", is_user_annotation=annotation)


def test_device_summary_takes_the_hosts_window():
    events = [
        _ev(timing.PROFILE_WINDOW, 100.0, 1100.0),
        _ev("launch", 120.0, 130.0),
        _ev("k1", 50.0, 150.0, "CUDA"),     # before the window: clipped to 100-150
        _ev("k2", 300.0, 400.0, "CUDA"),
        _ev("k2", 350.0, 500.0, "CUDA"),    # overlaps: the union counts 300-500 once
        _ev("turdb.x", 100.0, 1100.0, "CUDA", annotation=True),   # an annotation: left out
        _ev("k3", 1200.0, 1300.0, "CUDA"),  # after the window: left out
    ]
    got = timing.device_summary(events)
    assert got["traced"] and got["window_ms"] == pytest.approx(1.0)
    assert got["busy_ms"] == pytest.approx(0.25)
    # first-to-last device span (100-500 inside the window) would read 0.375
    assert got["idle_share"] == pytest.approx(0.75)
    assert [t["name"] for t in got["top"]] == ["k2", "k1"]
    assert got["top"][0]["calls"] == 2 and got["top"][0]["ms"] == pytest.approx(0.25)


def test_device_summary_without_device_spans_or_window():
    assert timing.device_summary([_ev(timing.PROFILE_WINDOW, 0.0, 10.0)]) == {"traced": False}
    assert timing.device_summary([_ev("k", 0.0, 1.0, "CUDA")]) == {"traced": False}
