"""The arithmetic of the measurements: the window's rate and tail over all
calls, the trace's idle share, kernel times and breakdown, and the probe's
bound on a hand-worked case."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from portbench_helpers import spec  # noqa: F401  (puts the repository on the path)

from portbench.harness import judge, loop, roofline, trace


def test_qps_and_p95_are_taken_over_every_call():
    lat = [0.001] * 90 + [0.010] * 10
    w = loop.Window(calls=100, queries=100 * 500, seconds=2.0, latencies=lat)
    assert w.qps() == 25_000.0
    assert w.p95_ms() == pytest.approx(float(np.percentile(lat, 95)) * 1e3)
    # ten slow calls of a hundred move the tail; a median of chunks would not
    assert w.p95_ms() > 5.0


def test_closed_loop_keeps_every_call_and_cycles_the_sets():
    seen = []

    def call(q):
        seen.append(int(q[0, 0]))
        time.sleep(0.002)
        return np.zeros((2, 1), np.float32), np.zeros((2, 1), np.int32) + int(q[0, 0])

    sets = [np.full((2, 3), j, np.float32) for j in range(3)]
    answers = judge.Answers()
    w = loop.closed_loop(call, sets, 0.05, answers, np.ones(1 << 10, bool))
    assert w.calls == len(w.latencies) == len(seen) == answers.calls
    assert seen[:6] == [0, 1, 2, 0, 1, 2]
    assert w.queries == 2 * w.calls
    assert w.seconds >= 0.05 and w.seconds >= sum(w.latencies)
    # equal answers are kept once, with their count
    assert sum(v[2] for kept in answers.by_set.values() for v in kept) == w.calls
    assert all(len(kept) == 1 for kept in answers.by_set.values())


def test_checked_calls_are_a_seeded_sample_over_a_first_full_pass():
    a = loop.checked_calls(2 ** 40 + 3, 10)
    assert a[:10].all() and a.sum() == pytest.approx(loop.CHECK_SHARE * len(a), rel=0.02)
    assert np.array_equal(a, loop.checked_calls(2 ** 40 + 3, 10))
    assert not np.array_equal(a, loop.checked_calls(2 ** 40 + 4, 10))


def _ev(name, s, e, device="CPU", annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type=f"DeviceType.{device}", is_user_annotation=annotation)


def test_trace_idle_share_kernel_times_and_breakdown():
    events = [
        _ev(trace.WINDOW, 100.0, 1100.0),
        _ev(trace.CALL, 100.0, 600.0), _ev("cudaMemcpyAsync", 100.0, 200.0),
        _ev(trace.CLIENT, 600.0, 700.0),
        _ev(trace.CALL, 700.0, 1100.0),
        _ev(trace.CALL, 100.0, 600.0, device="CUDA", annotation=True),   # no device work
        _ev("Memcpy HtoD (Pageable -> Device)", 150.0, 250.0, device="CUDA"),
        _ev("sm90_xmma_gemm_f32f32", 250.0, 400.0, device="CUDA"),
        _ev("void probe_chunk_kernel<F32Scorer>(ProbeArgs, F32Scorer)", 350.0, 500.0,
            device="CUDA"),
        _ev("topk_seg_kernel(float const*)", 800.0, 1000.0, device="CUDA"),
        _ev("before the window", 0.0, 90.0, device="CUDA"),
    ]
    tr = trace.from_events(events, calls=2, queries=2000, sets=[0, 1])
    assert tr.window_s == pytest.approx(1e-3)
    # busy: [150, 500] and [800, 1000] = 550 µs of 1,000
    assert tr.busy_s() == pytest.approx(550e-6)
    assert tr.kernel_ms(("GEMM", "topk_seg_kernel")) == pytest.approx(0.35)
    assert tr.kernel_ms(("probe_chunk_kernel<F32Scorer>",)) == pytest.approx(0.15)
    gaps = {}
    for sec, name in tr.idle_gaps(samples=6):
        gaps[name] = gaps.get(name, 0.0) + sec
    # [100, 150] in the copy's host call; [500, 800]: the first call until
    # 600, the client to 700, the next call after; [1000, 1100] that call
    assert gaps["cudaMemcpyAsync"] == pytest.approx(50e-6)
    assert gaps[trace.CLIENT] == pytest.approx(100e-6)
    assert gaps[trace.CALL] == pytest.approx(300e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["topk_seg_kernel(float const*)", pytest.approx(200e-6)]
    assert len(bd["device_ops"]) == 4 and len(bd["idle_gaps"]) <= 10
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(450e-6)


def test_idle_metric_reads_nothing_without_a_trace():
    read = spec.metric_reader("device_idle_pct")
    assert read(SimpleNamespace(trace=None)) is None
    for name in ("cellsel_ms_per_kq", "probe_ms_per_kq", "probe_roofline_pct",
                 "serve_beam_ms_per_kq", "graph_beam_ms_per_kq"):
        assert spec.metric_reader(name)(SimpleNamespace(trace=None)) is None


def test_bound_by_hand():
    b = roofline.bound(3.35e9, 67e9, roofline.FP32_OPS)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = roofline.bound(3.35e6, 134e9, roofline.FP32_OPS)
    assert b["bound_ms"] == pytest.approx(2.0) and b["bound_by"] == "operations"


def test_probe_bound_by_hand():
    # 3 cells of 2, 3 and 4 rows, d = 2, k = 5; queries probe cells (0, 1)
    # and (1, 2): cells 0-2 read once each, 9 rows x (4d + 8) B, 2 queries
    # x (4d + 4) B, 4 cell ids x 4 B, 2 outputs x 5 x 8 B
    sizes = torch.tensor([2, 3, 4])
    probes = torch.tensor([[0, 1], [1, 2]])
    b = roofline.probe_bound(probes, sizes, 2, 5)
    nbytes = 9 * 16 + 2 * 12 + 4 * 4 + 2 * 40
    assert b["bound_bytes"] == nbytes
    # rows a query probes: (2 + 3) and (3 + 4); 2·d ops each
    assert b["bound_ops"] == 2 * 2 * (5 + 7)
    assert b["bound_ms"] == pytest.approx(max(nbytes / 3.35e12, 48 / 67e12) * 1e3)
    # a cell probed by both queries is read once
    once = roofline.probe_bound(torch.tensor([[1, 1], [1, 1]]), sizes, 2, 5)
    assert once["bound_bytes"] == 3 * 16 + 2 * 12 + 4 * 4 + 2 * 40


def test_plain_partition_is_the_rows_nearest_centroid():
    g = torch.Generator().manual_seed(5)
    base = torch.randn(400, 6, generator=g)
    cent, cn, sizes = roofline.plain_partition(base, 16, block=64)
    assert torch.equal(cent, base[::25])
    near = torch.cdist(base.double(), cent.double()).argmin(1)
    assert torch.equal(sizes, torch.bincount(near, minlength=16))
    q = torch.randn(7, 6, generator=g)
    want = torch.cdist(q.double(), cent.double()).topk(3, largest=False).indices
    assert torch.equal(roofline.probed_cells(q, cent, cn, 3), want)


def test_probe_roofline_counts_from_the_benchmarks_rows_not_the_index():
    """The reader needs no index: the bound comes from the rows, the query
    sets and the configuration's partition; without that partition the run
    fails instead of falling silent."""
    g = torch.Generator().manual_seed(9)
    base = torch.randn(2048, 8, generator=g).numpy()
    sets = [torch.randn(64, 8, generator=g).numpy() for _ in range(2)]
    tr = SimpleNamespace(kernel_ms=lambda pats: 1.0, sets=[0, 1, 0])
    cell = SimpleNamespace(config={"yardstick": {"partition_cells": 16}},
                           traffic={"kwargs": {"nprobe": 2}, "k": 10})
    run = SimpleNamespace(trace=tr, cell=cell, base=base, query_sets=sets)
    read = spec.metric_reader("probe_roofline_pct")
    cent, cn, sizes = roofline.plain_partition(torch.as_tensor(base), 16)
    want = sum(roofline.probe_bound(roofline.probed_cells(torch.as_tensor(sets[j]), cent, cn, 2),
                                    sizes, 8, 10)["bound_ms"] for j in tr.sets)
    assert read(run) == pytest.approx(100.0 * want)
    del cell.config["yardstick"]
    with pytest.raises(KeyError):
        read(run)


def test_the_seed_changes_the_queries_and_not_the_store():
    gen = spec.generator("make_pool")
    p = {"n_base": 300, "n_queries": 40, "dim": 8, "n_clusters": 4, "store_seed": 10 ** 12}

    def draw(seed):
        return gen(torch.Generator().manual_seed(seed), "cpu", **p)
    b1, q1 = draw(1)
    b2, q2 = draw(2 ** 31 + 1)
    assert torch.equal(b1, b2) and not torch.equal(q1, q2)
    assert torch.equal(q1, draw(1)[1])
    assert b1.shape == (300, 8) and q1.shape == (40, 8)
