"""Ingest cells (`"loop": "ingest"`): a wave inserted before each query
call, each call judged against the rows acknowledged before it, and the
acknowledged rows read back. The cells are new files and entries alone,
in a temporary root: a configuration, a mix and a BENCHMARK.json entry,
no file of the harness changed. An exact index holds every check; each
fault planted under the timed path fails the check that targets it; the
closed loop reads what it read before ingest runs existed; a traced run
that takes its trace again still has waves to insert."""

import json
import numpy as np
import pytest
import torch
from portbench_helpers import grow, ingest_mix, spec, store, tiny_cell

from portbench.harness import judge, trace
from portbench.harness.cell_run import run_cell
from portbench.harness.loop import WARMUP_CALLS

SEED = 2 ** 33 + 7
N_BASE, STREAM, WAVE, BATCH = 3000, 1216, 4, 250   # ingest_mix's stream, wave and batch
N_BULK = N_BASE - STREAM
STEPS = STREAM // WAVE - WARMUP_CALLS   # the window's calls, after the warm-up's waves
LEAST = (WARMUP_CALLS + trace.TRACE_TRIES * trace.TRACE_CALLS) * WAVE   # the spec's least stream


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose benchmark a later change grew by two ingest cells."""
    return grow(tmp_path_factory.mktemp("ingest"),
                configs={"tiny-flat": store({"class": "FlatIndex", "kwargs": {"capacity": 4096}}),
                         "tiny-ivf": store({"class": "IvfIndex", "kwargs": {}})},
                mixes={"ingest-exact": ingest_mix({}), "ingest-ivf": ingest_mix({"nprobe": 4}),
                       "ingest-least": ingest_mix({}, stream=LEAST)},
                cells={"tiny-flat.ingest": ("tiny-flat", "ingest-exact"),
                       "tiny-ivf.ingest": ("tiny-ivf", "ingest-ivf"),
                       "tiny-flat.least": ("tiny-flat", "ingest-least")})


def _cell(root, name):
    return spec.find_cell(spec.load_benchmark(root), name, root=root)


def _values(checks):
    return {name: c["value"] for name, c in checks.items()}


@pytest.fixture(scope="module")
def exact(root):
    return run_cell(_cell(root, "tiny-flat.ingest"), SEED, 60.0, False, "cpu", 0.0)


def test_an_exact_index_holds_every_check(exact):
    out, checks = exact
    assert out["correct"] is True and out["failed"] == 0
    assert list(out["checks"]) == ["recall_at_10", "dist_rel_err", "bad_rows", "readback"]
    assert checks["readback"]["value"] == 1.0 and checks["recall_at_10"]["value"] == 1.0
    assert set(out["metrics"]) == {"qps", "call_p95_ms", "recall_at_10", "setup_s"}


def test_the_window_ends_at_the_streams_last_wave(exact):
    out, _ = exact
    assert out["attempted"] == STEPS * BATCH


def test_an_ivf_index_takes_the_stream(root):
    out, checks = run_cell(_cell(root, "tiny-ivf.ingest"), SEED, 60.0, False, "cpu", 0.0)
    assert out["correct"] is True, _values(checks)
    assert checks["readback"]["value"] >= 0.99


def _drop_half(insert):
    """Acknowledges every row of a wave and inserts only its first half;
    the ids of the rest are ones the index never gives."""
    lost = iter(range(10 ** 9, 2 * 10 ** 9))

    def half(rows):
        h = len(rows) // 2
        return np.concatenate([insert(rows[:h]), [next(lost) for _ in rows[h:]]])
    return half


def _later_row(call):
    """Names, in each call's first answer, the first row of the wave after
    the call's (the flat index's ids are its rows)."""
    calls = iter(range(1, 1 << 20))

    def ahead(q):
        d, i = call(q)
        i = i.copy()
        i[0, 0] = N_BULK + next(calls) * WAVE
        return d, i
    return ahead


def _altered_distance(call):
    def altered(q):
        d, i = call(q)
        d = d.copy()
        d[:, -1] *= 1.01
        return d, i
    return altered


@pytest.mark.parametrize("fault,target", [("drop_half", "readback"), ("later_row", "bad_rows"),
                                          ("altered_distance", "dist_rel_err")])
def test_a_planted_fault_fails_its_check(root, fault, target):
    wrap = {"wrap_insert": _drop_half} if fault == "drop_half" else {
        "wrap_call": _later_row if fault == "later_row" else _altered_distance}
    out, checks = run_cell(_cell(root, "tiny-flat.ingest"), SEED + 1, 60.0, False, "cpu", 0.0,
                           **wrap)
    assert out["correct"] is False
    assert not checks[target]["holds"], _values(checks)


# The parent harness's readings (before ingest runs existed) of two tiny
# closed-loop cells at this seed, one call each (`--seconds 0`): the
# closed loop has to read them still.
PARENT = [("sift1m-ivf.r95-b10k", None,
           {"recall_at_10": 1.0, "dist_rel_err": 4.0095019520604136e-05, "bad_rows": 0}),
          ("sift1m-hnsw.graph-b10k", {"ef": 10},
           {"recall_at_10": 0.9908, "dist_rel_err": 4.0095019520604136e-05, "bad_rows": 0})]


@pytest.mark.parametrize("name,kwargs,want", PARENT)
def test_a_closed_cell_reads_what_the_parent_read(name, kwargs, want):
    cell = tiny_cell(name)
    if kwargs:
        cell.traffic["kwargs"] = kwargs
    out, checks = run_cell(cell, 2 ** 33 + 5, 0.0, False, "cpu", 0.0)
    assert out["correct"] is True and out["attempted"] == 500 and out["failed"] == 0
    assert _values(checks) == want


@pytest.mark.parametrize("over,match", [({"loop": "open"}, "loop"),
                                        ({"stream": LEAST - 1}, "traced run"),
                                        ({"stream": N_BASE}, "build from"),
                                        ({"wave": 0}, "waves of 0")])
def test_spec_refuses_a_mix_it_cannot_run(root, over, match):
    (root / "portbench/traffic/bad.json").write_text(json.dumps(ingest_mix({}, **over)))
    bench = spec.load_benchmark(root)
    bench["workloads"].append({"name": "tiny-flat.bad", "config": "tiny-flat",
                               "traffic": "bad", "chips": 1, "why": "a test"})
    with pytest.raises(ValueError, match=match):
        spec.find_cell(bench, "tiny-flat.bad", root=root)


def test_an_unknown_loop_raises_before_any_work(root):
    cell = _cell(root, "tiny-flat.ingest")
    cell.traffic = {**cell.traffic, "loop": "open"}

    def never(call):
        raise AssertionError("the entry was reached")
    with pytest.raises(KeyError, match="open"):
        run_cell(cell, 5, 0.1, False, "cpu", 0.0, wrap_call=never)


def test_acked_maps_ids_to_the_rows_acknowledged_for_them():
    acked = judge.Acked()
    acked.add(np.array([10, 11, 12]), 3)
    acked.add(np.array([40, 11]), 2)            # 11 acknowledged twice: no row
    assert acked.n == 5
    got = acked.rows(torch.tensor([[10, 12, 40], [11, -1, 99]]))
    assert got.tolist() == [[0, 2, 3], [-1, -1, -1]]
    assert acked.ids_of(np.array([3, 0])).tolist() == [40, 10]
    with pytest.raises(ValueError):
        acked.add(np.array([1, 2]), 3)


def test_an_insert_is_named_whole_in_the_idle_gaps():
    host = [(0.0, 600.0, trace.CALL), (0.0, 400.0, trace.INSERT), (100.0, 200.0, "aten::copy_"),
            (600.0, 1000.0, trace.CALL), (600.0, 700.0, trace.INSERT)]
    tr = trace.Trace(window=(0.0, 1000.0), device=[(400.0, 600.0, "k"), (900.0, 1000.0, "k")],
                     host=host, calls=2, queries=500, sets=[0, 1])
    gaps = {}
    for sec, name in tr.idle_gaps(samples=4):
        gaps[name] = gaps.get(name, 0.0) + sec
    # idle 0-400, all in the first wave (aten::copy_ inside it too), and
    # 600-900 in quarters: the first quarter's midpoint in the second wave
    assert gaps == {trace.INSERT: pytest.approx(475e-6), trace.CALL: pytest.approx(225e-6)}


def test_a_traced_ingest_run_taken_again_has_waves_left(root, monkeypatch):
    """The profiler keeps no device span in the first tries, as it now and
    then does on the card: at the spec's least stream the last try still
    has its waves, and every try's calls are judged against the rows
    acknowledged before them."""
    real, tries = trace.from_events, []

    def device_on_the_last_try(events, *args):
        tr = real(events, *args)
        tries.append(len(tr.device))
        if len(tries) == trace.TRACE_TRIES:
            tr.device = [(tr.window[0], tr.window[1], "k")]
        return tr
    monkeypatch.setattr(trace, "from_events", device_on_the_last_try)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out, checks = run_cell(_cell(root, "tiny-flat.least"), SEED + 2, 60.0, True, "cpu", 0.0)
    assert tries == [0] * trace.TRACE_TRIES
    assert out["correct"] is True, _values(checks)
    assert checks["readback"]["value"] == 1.0 and out["attempted"] == trace.TRACE_CALLS * BATCH
