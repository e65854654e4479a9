"""The wide forms on one card: two builds side by side.

A is compiled from the `csrc/` of another checkout of the repository (an
older commit, unpacked with `git archive`; its own `build.py` builds it and
gives its argtypes), B from this one. Where A's library has no cluster
form of K2 or K7 (no `topk_rows_wide_ctas`, no `hnsw_select_wide_ctas`),
this checkout's wrappers take the global route while A is in use (the
launch the older wrappers made), and where it has no claim table for K5
wide or no stage query for K8-SQ wide, they make the older launches, so A
is the older kernels throughout. Each case runs A B B A;
each time is `ms` (one call between CUDA events, the host's launch path
included), `loop_ms` (ten calls back to back, a tenth of the time) and
`device_ms` (a trace's device time of the kernel, a call). Every output of
B must equal A's bit for bit; K2's must equal the plain version's too.
Where a kernel's sum order changed on one side (K6 wide's rerank, K9
wide's sums: `ORDER_CHANGED`), an output that differs from A's must agree
with the plain version as chip_smoke's wide_check holds it (distances
within DOT_RTOL, ids apart only inside that band, at most 1 % of them), and
K6 wide's beam work (expansions, scored neighbours) must equal A's.

1. K2 past SEL_MAX at [64, 5000] k = 3000 (chip_smoke width_check's, the L2
   epilogue), [1, 76,800] k = 4,800 and 2,400 (the wide probes' distances),
   [1, 2400] k = 2400 (K5 wide's) and [256, 131,072] k = 3000 (a flat
   oracle chunk, L2 clamped), each beside `torch.topk` of the same values
   (ms and device ms) and its bound;
2. the wide beams on chip_smoke's emb rows (emb_pool 500k x 384, cosine,
   the bulk graph and its serving pack): K8 wide at the SQL LIMIT 200
   shape (B = 1, ef 1,600, k_res 800, every row allowed), K6 wide at the
   same on the pack, K8 wide at B = 1,024 and ef 1,500 (width_check's
   search at a full batch), K8 wide over the 768-d f32 rows at ef 1,600
   (B = 32: K8-SQ wide's yardstick, the same loop with K8's lane-group
   scorer) and K8-SQ wide over the 768-d SQ8 store at the same shape, each
   call captured from the index's own search (chip_smoke._WideCalls);
   then K8-SQ wide over the SQ16 store made from the yardstick call's rows
   (its seeds), and over the SQ8 store at B = 8 with an ef whose state
   lies in the global scratch (`SQ_GLOBAL_EF`); K9 wide on chip_smoke's
   rows past DIM_MAX (emb_pool 4,096 x 4,608, cosine, waves from empty):
   the waves' first call (B = 1), the largest wave's descent and the
   search's descent (B = 256, descent_ef 1), each with the steps a query
   took and the device µs a step of its longest chain; and the 768-d SQ8
   index's search of 256 queries in batches of 32 (chip_smoke _emb_768's),
   its wall seconds with A and B in turns. A library built with K6 wide's
   phase clocks (an `hnsw_beam_wide_clocks` entry point: cycles of thread
   0 a block in the selection and claims, the scoring, the merges, the
   rerank's distances, its sort and output) reports them for one call of
   the K6 case;
3. unless `--no-sql`: the emb path's deep SQL statements (chip_smoke
   _emb_sql's table and statement text, N_SQL a store) with A and B in
   turns: p50 / p99 ms of HNSW graph LIMIT 200, IVF LIMIT 600 and IVF WITH
   (sq8, rerank = 2400) LIMIT 600;
4. the probes' and the selection's wide forms: K1 wide at the SQL LIMIT
   600 statement's own call on USING IVF (B = 1, P = 600, L = 128, d =
   384, m = 4,800) and K4 wide at the WITH (sq8, rerank = 2400) one, each
   with its launches' device times apart (the distance pass, K2, the
   tail); K7 wide at the 384-d bulk build's level-1 call (U = 16,384, W =
   128, deg 16) and the 768-d build's level-0 call (W = 64), K7s wide at
   the 768-d wave's U = 512, W = 100 call, each captured from the index's
   own build, with the CTAs of a target on each side and, for B, at
   `FORCE_CTAS` forced as well (outputs bit-equal to the routed ones);
   K5 wide at the WITH (sq8, rerank = 2400) LIMIT 600 statement's own
   call (B = 1, r = 2,400, d = 384, f32 rows) with its launches' device
   times apart (the distance pass with its dedup, K2, the id gather);
   and the 384-d bulk build's seconds with A and B in turns;
5. only with `--k4-query`: K4 wide's query-major pass on chip_smoke's
   3,072-d SQL store (`emb_3072_store`: 65,536 emb_pool rows, USING IVF
   WITH (sq8 = true, rerank = 2400)) at its own calls: the LIMIT 50 and
   LIMIT 600 statements' (B = 1, P = 50 / 600, L = 128, m = 2,400,
   candidates, replicas, `allowed`), an `IvfIndex.search` of 256 queries
   at nprobe 50 on the same index, and a 100-d store's (GloVe-100's
   width: rows that are no 16-byte words) at B = 1, nprobe 50, each with
   its launches' device times apart (the pass, K2, the tail), its bound
   and the bytes the query-major order streams (`stream_ms`); then
   N_SQL statements of each LIMIT with A and B in turns (p50 / p99 ms).

Run on a CUDA card (about seven minutes on an H100):

    python3 scripts/exp_torch_wide_kernels.py OTHER_CHECKOUT [--no-sql | --k2-only |
        --beams-only | --probe-select-only | --k4-query]

`--k2-only` runs part 1 (about a minute), `--beams-only` part 2 (about
three minutes), `--probe-select-only` part 4 (about three minutes),
`--k4-query` part 5 (about two minutes); given together, the parts they
name. It prints one JSON object and writes it to
chiprun_out/exp_torch_wide_kernels.json; ptxas reports land in
chiprun_out/ptxas_A.txt / ptxas_B.txt. Exits 1 unless every output of B
equals A's or (`ORDER_CHANGED`) holds to the plain version (K7's cluster
form is bit for bit A's K7 wide, at every CTA count forced too) and K2's
equals the plain version's.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from exp_torch_graph_kernels import build_module  # noqa: E402
from turdb_tpu_torch import kernels  # noqa: E402
from turdb_tpu_torch.kernels import build  # noqa: E402
from turdb_tpu_torch.ops.quantize import sq_rows_encode  # noqa: E402

N_SQL = 16          # deep statements a store and turn
TURNS = ("A", "B", "B", "A")
FORCE_CTAS = (1, 2, 4)   # K7 wide's CTAs a target, forced beside the routed ones
SQ_GLOBAL_EF = 5_600     # K8-SQ wide with its state in the global scratch (B = 8)
N_K9_SEARCH = 256        # queries of the 4,608-d search's descent
# the wide kernels whose sums may come in another order on the two sides
ORDER_CHANGED = ("hnsw_serve_beam_wide", "hnsw_greedy_wide")
K6_PHASES = ("select_claims", "score", "merge", "rerank_dist", "sort_out")


def _old_tail_scratch(rows, m, replicated, mode, device):
    return tuple(torch.empty((2, rows, m), dtype=torch.int32, device=device))


class Libraries:
    """The two kernel libraries and the switch between them."""

    def __init__(self, other: Path):
        self.b = build.library()
        self.other_build = build_module(other)
        self.a = self.other_build.library()
        # K9's levels go by value as this checkout's structure (the same layout)
        for name in ("hnsw_greedy", "hnsw_greedy_wide"):
            fn = getattr(self.a, name)
            fn.argtypes = [build.GreedyLevels, *fn.argtypes[1:]]
        self.ctas = kernels.topk_wide_ctas
        self.sel_ctas = kernels.select_wide_ctas
        self.tail_scratch = kernels._tail_scratch
        self.rerank_table = kernels._rerank_table
        self.sq_bytes = kernels._beam_sq_wide_bytes
        self.serve_bytes = kernels._serve_wide_bytes

    def use(self, name):
        a = name == "A"
        build._lib = self.a if a else self.b
        kernels._entry.clear()
        old_k2 = a and not hasattr(self.a, "topk_rows_wide_ctas")
        old_k7 = a and not hasattr(self.a, "hnsw_select_wide_ctas")
        kernels.topk_wide_ctas = (lambda n, k: 0) if old_k2 else self.ctas
        kernels.select_wide_ctas = (lambda w, d, s: 0) if old_k7 else self.sel_ctas
        # an older tail keeps its winners in a [2, rows, m] global scratch
        old_tail = a and not hasattr(self.a, "ivf_probe_tail_wide_words")
        kernels._tail_scratch = (_old_tail_scratch if old_tail else self.tail_scratch)
        # an older K5 wide takes no claim table; an older K8-SQ wide's state
        # lies in shared memory by the beams' common rule
        if a and not hasattr(self.a, "ivf_rerank_dist_table_words"):
            kernels._rerank_table = lambda *x: None
            kernels._entry["ivf_rerank_dist"] = (
                lambda *args: self.a.ivf_rerank_dist(*args[:14], *args[15:]))
        else:
            kernels._rerank_table = self.rerank_table
        old_sq = a and not hasattr(self.a, "hnsw_beam_sq_wide_bytes")
        kernels._beam_sq_wide_bytes = (
            (lambda deg, ef, it, ex, kr, d, bits:
             self.a.hnsw_beam_wide_bytes(deg, ef, it, ex, kr, 0)) if old_sq else self.sq_bytes)
        # an older K6 wide stages nothing: its state lies in shared memory by
        # the beams' common rule
        old_serve = a and not hasattr(self.a, "hnsw_serve_beam_wide_bytes")
        kernels._serve_wide_bytes = (
            (lambda deg, ef, it, ex, r, d: self.a.hnsw_beam_wide_bytes(deg, ef, it, ex, 0, r))
            if old_serve else self.serve_bytes)


def _times(fn, kernel, calls=20):
    return {"ms": cs._median_ms(fn), "loop_ms": cs._loop_ms(fn),
            "device_ms": cs._trace_ms(fn, kernel, calls=calls)}


def _equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def k2_cases(dev):
    """(name, x, k, kwargs) of the K2 shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    out = []
    for name, b, n, k, l2, clamp in (("[64, 5000] k=3000", 64, 5000, 3000, True, False),
                                     ("[1, 76800] k=4800", 1, 76_800, 4_800, False, False),
                                     ("[1, 76800] k=2400", 1, 76_800, 2_400, False, False),
                                     ("[1, 2400] k=2400", 1, 2_400, 2_400, False, False),
                                     ("[256, 131072] k=3000", 256, 131_072, 3_000, True, True)):
        x = torch.randn(b, n, device=dev, generator=gen)
        kw = {}
        if l2:
            kw = dict(rown=torch.rand(b, device=dev, generator=gen) * n,
                      coln=torch.rand(n, device=dev, generator=gen) * n,
                      epilogue=kernels.EPI_L2, clamp=clamp)
        out.append((name, x, k, kw))
    return out


def k2_run(libs, cases):
    runs, outs = {}, {}
    for turn, name in enumerate(TURNS):
        libs.use(name)
        for case, x, k, kw in cases:
            fn = lambda: kernels.topk_rows(x, k, **kw)  # noqa: E731
            outs.setdefault(case, {})[name] = [t.clone() for t in fn()]
            runs.setdefault(case, {}).setdefault(name, []).append(_times(fn, "topk_"))
    libs.use("B")
    out = {}
    for case, x, k, kw in cases:
        plain = kernels.topk_rows_plain(x, k, **kw)
        vals = kernels._row_values(x, kw.get("rown"), kw.get("coln"), None,
                                   kw.get("epilogue", kernels.EPI_NONE), kw.get("clamp", False))
        lib = lambda: torch.topk(vals, k, dim=1, largest=False, sorted=True)  # noqa: E731
        b, n = x.shape
        side = 4 * (b + n) if kw else 0
        out[case] = {"A": runs[case]["A"], "B": runs[case]["B"],
                     "ctas": kernels.topk_wide_ctas(n, k),
                     "equal_A_B": _equal(outs[case]["A"], outs[case]["B"]),
                     "equal_plain": _equal(outs[case]["B"], plain),
                     "torch_topk": {"ms": cs._median_ms(lib),
                                    "device_ms": cs._trace_ms(lib, None, calls=20)},
                     **cs._bound(4 * b * n + side + 8 * b * k, 3 * b * n, cs.FP32_OPS)}
        cs.log(f"K2 {case}: {json.dumps(out[case])}")
    return out


def beam_calls(dev):
    """The wide beams' calls, each captured from an index's own search."""
    from turdb_tpu_torch.models.hnsw import HnswIndex
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.utils.datasets import emb_pool

    t = time.perf_counter()
    xe, qe = emb_pool(np.random.default_rng(0), cs.N_EMB, n_queries=2048)
    idx = HnswIndex(dim=cs.EMB_DIM, metric=Metric.COSINE, ef_construction=100, build_batch=512,
                    capacity=cs.N_EMB, device=dev)
    idx.add(xe)
    idx.pack_serving()
    torch.cuda.synchronize()
    setup = {"emb_build_s": time.perf_counter() - t}
    allowed = np.ones(idx.size, bool)
    calls = {}

    def capture(case, name, fn):
        with cs._WideCalls() as wide:
            fn()
        cs.check(name in wide.calls, f"{case}: no {name} call")
        calls[case] = (name, *wide.calls[name])

    capture("K8 wide LIMIT 200 (B=1, ef 1600, k_res 800)", "hnsw_graph_beam_wide",
            lambda: idx.search(qe[:1], 4 * cs.EMB_DEEP_HNSW, ef=8 * cs.EMB_DEEP_HNSW,
                               allowed=allowed))
    capture("K6 wide LIMIT 200 (B=1, ef 1600)", "hnsw_serve_beam_wide",
            lambda: idx.search_serve(qe[:1], 4 * cs.EMB_DEEP_HNSW, ef=8 * cs.EMB_DEEP_HNSW,
                                     allowed=allowed))
    capture("K8 wide B=1024 ef 1500", "hnsw_graph_beam_wide",
            lambda: idx.search(qe[:1024], cs.K, ef=1500))
    x7, q7 = emb_pool(np.random.default_rng(1), cs.N_768, n_queries=cs.N_ORACLE, dim=768)
    i7 = HnswIndex(dim=768, metric=Metric.COSINE, ef_construction=100, build_batch=512,
                   capacity=len(x7), device=dev)
    i7.add(x7)
    yard = "K8 wide f32 768-d (B=32, ef 1600): K8-SQ's yardstick"
    capture(yard, "hnsw_graph_beam_wide", lambda: i7.search(q7[:32], cs.K, ef=cs.EMB_DEEP_EF))
    i7.quantize_sq8()
    sq8 = "K8-SQ wide SQ8 768-d (B=32, ef 1600)"
    capture(sq8, "hnsw_graph_beam_sq_wide", lambda: i7.search(q7[:32], cs.K, ef=cs.EMB_DEEP_EF))
    _, fn, a, kw = calls[yard]
    calls["K8-SQ wide SQ16 768-d (B=32, ef 1600)"] = (
        "hnsw_graph_beam_sq_wide", fn, (a[0], sq_rows_encode(a[1], 16), *a[2:]), kw)
    _, fn, a, kw = calls[sq8]
    deg = a[0].shape[1]
    glob = dict(kw, ef=SQ_GLOBAL_EF, iters=SQ_GLOBAL_EF * 3 // 2)
    cs.check(build.library().hnsw_beam_wide_bytes(deg, glob["ef"], glob["iters"],
                                                  glob.get("expand", 4), 0, 0) > 0,
             f"ef {SQ_GLOBAL_EF}: the beam's state fits shared memory")
    calls[f"K8-SQ wide SQ8 768-d global state (B=8, ef {SQ_GLOBAL_EF})"] = (
        "hnsw_graph_beam_sq_wide", fn, (*a[:3], *(t[:8] for t in a[3:7]), *a[7:]), glob)
    setup["search_768"] = (i7, q7)
    del i7
    calls.update(k9_calls(dev, setup))
    return calls, setup


class _GreedyCalls:
    """Every K9 call past DIM_MAX that the model module makes, in order,
    kept (wrapper, arguments)."""

    def __enter__(self):
        from turdb_tpu_torch.models import hnsw as mh

        self.mod, self.saved, self.calls = mh, mh.hnsw_greedy, []

        def wrapped(*a, **kw):
            if a[3].shape[1] > kernels.DIM_MAX:
                self.calls.append((self.saved, a, kw))
            return self.saved(*a, **kw)
        mh.hnsw_greedy = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.hnsw_greedy = self.saved


def k9_calls(dev, setup):
    """K9 wide's calls on chip_smoke's rows past DIM_MAX: the waves' first
    call, the largest wave's descent, the search's descent at B = 256."""
    from turdb_tpu_torch.models.hnsw import HnswIndex
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.utils.datasets import emb_pool

    x, q = emb_pool(np.random.default_rng(2), cs.N_WIDE_ROWS, n_queries=N_K9_SEARCH,
                    dim=cs.WIDE_ROWS_DIM)
    idx = HnswIndex(dim=cs.WIDE_ROWS_DIM, metric=Metric.COSINE, capacity=len(x), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _GreedyCalls() as waves:
        idx.add(x)
    torch.cuda.synchronize()
    setup["wide_rows_wave_s"] = time.perf_counter() - t
    with _GreedyCalls() as search:
        idx.search(q, cs.K, ef=cs.HNSW_GRAPH_EF)
    cs.check(len(waves.calls) > 1 and len(search.calls) == 1,
             f"K9 wide calls: {len(waves.calls)} in the waves, {len(search.calls)} in the search")
    first = waves.calls[0]
    largest = max(waves.calls, key=lambda c: c[1][3].shape[0])
    out = {}
    for case, (fn, a, kw) in ((f"K9 wide first wave call (B={first[1][3].shape[0]})", first),
                              (f"K9 wide largest wave (B={largest[1][3].shape[0]})", largest),
                              (f"K9 wide search descent (B={N_K9_SEARCH})", search.calls[0])):
        out[case] = ("hnsw_greedy_wide", fn, a, kw)
    return out


def _in_shared_memory(kernel, a, kw):
    """Whether this checkout's library runs the call with its state in
    shared memory (its scratch query gives 0 bytes; K8-SQ's and K6's count
    their stages too)."""
    ef, iters, expand = kw["ef"], kw["iters"], kw.get("expand", 4)
    deg = a[0].shape[1]
    if kernel == "hnsw_serve_beam_wide":
        d = a[0].shape[2]
        return kernels._serve_wide_bytes(deg, ef, iters, expand, min(kw.get("rerank") or ef, ef),
                                         d + (-d % 4)) == 0
    allowed = a[7] if len(a) > 7 else kw.get("allowed")
    k_res = (kw.get("k_res") or ef) if allowed is not None else 0
    if kernel == "hnsw_graph_beam_sq_wide":
        d = a[3].shape[1]
        return kernels._beam_sq_wide_bytes(deg, ef, iters, expand, k_res, d + (-d % 4),
                                           a[1].bits) == 0
    return build.library().hnsw_beam_wide_bytes(deg, ef, iters, expand, k_res, 0) == 0


def search_768_run(libs, i7, q7):
    """Wall seconds of the 768-d SQ8 index's search of its queries in
    batches of 32 (chip_smoke _emb_768's), A B B A, and whether the ids
    are the same."""
    out, ids = {}, {}
    for name in TURNS:
        libs.use(name)
        i7.search(q7[:32], cs.K, ef=cs.EMB_DEEP_EF)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = [i7.search(q7[s:s + 32], cs.K, ef=cs.EMB_DEEP_EF)[1]
               for s in range(0, len(q7), 32)]
        torch.cuda.synchronize()
        out.setdefault(name, []).append(time.perf_counter() - t)
        ids[name] = np.concatenate(got)
    libs.use("B")
    out["queries"] = len(q7)
    out["same_ids_A_B"] = bool(np.array_equal(ids["A"], ids["B"]))
    cs.log(f"768-d SQ8 search: {json.dumps(out)}")
    return out


def _k6_clocks(call):
    """K6 wide's phase cycles (thread 0 of each block, summed) in one call,
    where the library in use was built with them; else None."""
    import ctypes

    lib = build.library()
    if not hasattr(lib, "hnsw_beam_wide_clocks"):
        return None
    buf = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    lib.hnsw_beam_wide_clocks(buf)
    call()
    torch.cuda.synchronize()
    lib.hnsw_beam_wide_clocks(buf)
    total = sum(buf[:5])
    return {"cycles": dict(zip(K6_PHASES, buf[:5])), "steps": buf[5], "queries": buf[6],
            "seeds": buf[7], "share": {k: v / total for k, v in zip(K6_PHASES, buf[:5])}}


def _greedy_steps(times, stats):
    """Steps a query and device µs a step of the longest chain."""
    steps = stats[:, 0].double()
    longest = int(steps.max())
    return {"steps_a_query": float(steps.mean()), "longest_chain": longest,
            "us_a_step": 1000.0 * times["device_ms"] / max(longest, 1)}


def _near_plain(kernel, fn, a, kw, got):
    """The wide call against its plain version as wide_check holds it."""
    with cs._PlainVersions():
        want = fn(*a, **kw)
    torch.cuda.synchronize()
    row = {}
    try:
        if kernel == "hnsw_serve_beam_wide":
            cs.check(torch.equal(got[2], want[2]), f"{kernel}: the beam's work differs")
        err, id_diff = cs._near_equal(*cs._wide_outputs(kernel, got),
                                      *cs._wide_outputs(kernel, want), cs.DOT_RTOL, kernel)
        cs.check(id_diff <= 0.01, f"{kernel}: {id_diff} of the ids differ")
        row.update(ok=True, max_abs_err=err, id_diff=id_diff)
    except cs.SmokeFailure as e:
        row.update(ok=False, error=str(e))
    return row


def beam_run(libs, calls):
    runs, outs, clocks = {}, {}, {}
    for name in TURNS:
        libs.use(name)
        for case, (kernel, fn, a, kw) in calls.items():
            call = lambda: fn(*a, **kw)  # noqa: E731
            got = call()
            outs.setdefault(case, {})[name] = [t.clone() if isinstance(t, torch.Tensor) else t
                                               for t in got]
            times = _times(call, cs.WIDE_TRACED.get(kernel, "graph_beam_wide"), calls=5)
            if kernel == "hnsw_greedy_wide":
                times.update(_greedy_steps(times, got[2]))
            runs.setdefault(case, {}).setdefault(name, []).append(times)
            ck = _k6_clocks(call) if kernel == "hnsw_serve_beam_wide" else None
            if ck is not None:
                clocks.setdefault(case, {}).setdefault(name, []).append(ck)
    libs.use("B")
    out = {}
    for case, (kernel, fn, a, kw) in calls.items():
        got = fn(*a, **kw)
        same = _equal(outs[case]["A"], outs[case]["B"])
        out[case] = {"A": runs[case]["A"], "B": runs[case]["B"], "equal_A_B": same,
                     **cs._wide_bound(kernel, fn, a, kw, got)}
        if kernel != "hnsw_greedy_wide":
            out[case]["state_in_shared_memory"] = _in_shared_memory(kernel, a, kw)
        if case in clocks:
            out[case]["phase_clocks"] = clocks[case]
        if kernel == "hnsw_serve_beam_wide":
            out[case]["work_equal_A_B"] = torch.equal(outs[case]["A"][2], outs[case]["B"][2])
        if kernel in ORDER_CHANGED and not same:
            out[case]["plain"] = _near_plain(kernel, fn, a, kw, got)
        cs.log(f"{case}: {json.dumps(out[case])}")
    return out


def _beam_ok(row):
    """B's output equals A's, or (a changed sum order) holds to the plain
    version with K6's beam work equal to A's."""
    if row["equal_A_B"]:
        return True
    return row.get("plain", {}).get("ok", False) and row.get("work_equal_A_B", True)


def _sql_turns(libs, db, sqls):
    """The statements with A and B in turns: p50 / p99 ms a turn, and
    whether A's rows equal B's."""
    res = {}
    for name in TURNS:
        libs.use(name)
        db.query(sqls[0])
        rows, ms = cs._sql_timed(db, sqls)
        res.setdefault(name, []).append(cs._pcts(ms))
        res.setdefault("rows", {})[name] = [[r[0] for r in rr] for rr in rows]
    libs.use("B")
    return {"A": res["A"], "B": res["B"], "same_rows_A_B": res["rows"]["A"] == res["rows"]["B"]}


def sql_run(libs, dev):
    """The deep statements with A and B in turns."""
    import shutil
    import tempfile

    from turdb_tpu_torch import Database
    from turdb_tpu_torch.utils.datasets import emb_pool

    xe, qe = emb_pool(np.random.default_rng(0), cs.N_EMB, n_queries=cs.N_QUERIES)
    lits = [cs._sql_vec(v) for v in cs._parsed(qe[:N_SQL])]
    out = {}
    tmp = tempfile.mkdtemp(prefix="turdb_wide_sql_")
    try:
        db = Database.create(f"{tmp}/db")
        db.execute(f"CREATE TABLE docs (id BIGINT PRIMARY KEY, emb VECTOR({cs.EMB_DIM}))")
        db.bulk_insert("docs", {"id": np.arange(len(xe)), "emb": xe})
        stores = (("hnsw_graph LIMIT 200", "CREATE INDEX ix ON docs USING HNSW (emb)",
                   cs.EMB_DEEP_HNSW),
                  ("ivf LIMIT 600", "CREATE INDEX ix ON docs USING IVF (emb)", cs.EMB_DEEP_IVF),
                  ("ivf_sq8 LIMIT 600", "CREATE INDEX ix ON docs USING IVF (emb) WITH "
                   f"(sq8 = true, rerank = {4 * cs.EMB_DEEP_IVF})", cs.EMB_DEEP_IVF))
        for store, create, limit in stores:
            db.execute(create)
            out[store] = _sql_turns(libs, db, [cs._sql_ann(s, limit) for s in lits])
            cs.log(f"sql {store}: {json.dumps(out[store])}")
            db.execute("DROP INDEX ix")
            torch.cuda.empty_cache()
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


PROBE_PARTS = (("tail", "probe_tail"), ("select", "topk"), ("dist", "probe"))
RERANK_PARTS = (("select", "topk"), ("dist", "rerank"), ("gather", "gather"))


def _split(fn, parts=PROBE_PARTS, calls=20):
    """Device ms a call of each launch of a wide form, by the first of
    `parts` (name, key) whose key its kernel's name holds: a probe's
    distance pass (`dist`), K2 (`select`), the tail (`tail`); K5's distance
    pass with its dedup (`dist`), K2, the id gather (`gather`); anything
    else (`other`)."""
    prof = cs._traced(fn, calls, top=16)
    out = dict.fromkeys([p for p, _ in parts] + ["other"], 0.0)
    for t in prof["top"]:
        part = next((p for p, key in parts if key in t["name"]), "other")
        out[part] += t["ms"] / t["calls"]
    return out


class _SelectCalls:
    """The first K7 / K7s call of each (U, W, d) past the fast form's
    widths, kept (wrapper, arguments) from the model module's calls."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from turdb_tpu_torch.models import hnsw as mh

        self.mod, self.saved = mh, (mh.hnsw_select, mh.hnsw_select_sorted)
        mh.hnsw_select = self._wrapped("K7 wide", mh.hnsw_select, 3)
        mh.hnsw_select_sorted = self._wrapped("K7s wide", mh.hnsw_select_sorted, 1)
        return self

    def _wrapped(self, name, fn, at):
        def wrapped(*a, **kw):
            (u, w), d = a[at].shape, a[0].shape[1]
            if not kernels.select_fast(w, d):
                self.calls.setdefault((name, u, w, d), (fn, a, kw))
            return fn(*a, **kw)
        return wrapped

    def __exit__(self, *exc):
        self.mod.hnsw_select, self.mod.hnsw_select_sorted = self.saved


def probe_select_run(libs, dev, out):
    """Part 4: K1 / K4 / K5 wide at the deep SQL statements' own calls, K7 /
    K7s wide at the emb builds' own calls, and the 384-d bulk build's
    seconds, A B B A, into `out` as they come."""
    import shutil
    import tempfile

    from turdb_tpu_torch import Database
    from turdb_tpu_torch.utils.datasets import emb_pool

    xe, qe = emb_pool(np.random.default_rng(0), cs.N_EMB, n_queries=cs.N_QUERIES)
    out.update(probes={}, select={})
    tmp = tempfile.mkdtemp(prefix="turdb_wide_probe_")
    try:
        db = Database.create(f"{tmp}/db")
        db.execute(f"CREATE TABLE docs (id BIGINT PRIMARY KEY, emb VECTOR({cs.EMB_DIM}))")
        db.bulk_insert("docs", {"id": np.arange(len(xe)), "emb": xe})
        lit = cs._sql_vec(cs._parsed(qe[:1])[0])
        for name, opts in (("ivf_probe_f32_wide", ""),
                           ("ivf_probe_sq8_wide",
                            f" WITH (sq8 = true, rerank = {4 * cs.EMB_DEEP_IVF})")):
            db.execute(f"CREATE INDEX ix ON docs USING IVF (emb){opts}")
            with cs._WideCalls() as wide:
                db.query(cs._sql_ann(lit, cs.EMB_DEEP_IVF))
            names = [name] + (["ivf_rerank_wide"] if opts else [])
            for wname in names:
                cs.check(wname in wide.calls,
                         f"the LIMIT {cs.EMB_DEEP_IVF} statement made no {wname}")
                out["probes"][wname] = _probe_ab(libs, wname, *wide.calls[wname])
            del wide
            db.execute("DROP INDEX ix")
            torch.cuda.empty_cache()
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    calls, out["build_s"] = select_calls(libs, dev, xe)
    for case, (key, (fn, a, kw)) in _select_cases(calls).items():
        kind, _, w, d = key
        sorted_mode = kind == "K7s wide"
        call = lambda: fn(*a, **kw)  # noqa: E731
        runs, outs = {}, {}
        for turn in TURNS:
            libs.use(turn)
            outs[turn] = [t.clone() for t in call()]
            runs.setdefault(turn, []).append(_times(call, "select", calls=5))
        libs.use("B")
        routed = kernels.select_wide_ctas(w, d, sorted_mode)
        forced = {}
        for ctas in FORCE_CTAS:
            kernels.select_wide_ctas = lambda w_, d_, s_, c=ctas: c  # noqa: E731
            try:
                got = [t.clone() for t in call()]
                forced[ctas] = {**_times(call, "select", calls=5),
                                "equal_routed": _equal(got, outs["B"])}
            except RuntimeError as e:   # a CTA count whose share passes shared memory
                forced[ctas] = {"refused": str(e)}
            kernels.select_wide_ctas = libs.sel_ctas
        got = call()
        plain = kernels.hnsw_select_sorted_plain if sorted_mode else kernels.hnsw_select_plain
        pi = plain(*a, **kw)[0]
        out["select"][case] = {"U": key[1], "A": runs["A"], "B": runs["B"], "ctas": routed,
                               "forced": forced, "equal_A_B": _equal(outs["A"], outs["B"]),
                               "rows_equal_plain": float((got[0] == pi).all(1).float().mean()),
                               "options": {k: v for k, v in kw.items()
                                           if isinstance(v, (int, float))},
                               **cs._wide_bound("hnsw_select_sorted_wide" if sorted_mode
                                                else "hnsw_select_wide", fn, a, kw, got)}
        cs.log(f"{case}: {json.dumps(out['select'][case])}")
    del calls
    torch.cuda.empty_cache()


def _probe_ab(libs, name, fn, a, kw):
    """One captured wide probe or rerank call, A B B A, with its launches'
    device times apart."""
    call = lambda: fn(*a, **kw)  # noqa: E731
    parts = RERANK_PARTS if name == "ivf_rerank_wide" else PROBE_PARTS
    runs, outs = {}, {}
    for turn in TURNS:
        libs.use(turn)
        outs[turn] = [t.clone() for t in call()]
        runs.setdefault(turn, []).append({**_times(call, None, calls=20),
                                          "split": _split(call, parts)})
    libs.use("B")
    got = call()
    row = {"A": runs["A"], "B": runs["B"], "equal_A_B": _equal(outs["A"], outs["B"]),
           "options": {k: v for k, v in kw.items() if isinstance(v, (int, bool))},
           **cs._wide_bound(name, fn, a, kw, got)}
    if name == "ivf_rerank_wide":
        row["route"] = cs._rerank_form(a, kw)
    cs.log(f"{name}: {json.dumps(row)}")
    return row


K4Q_B, K4Q_NPROBE = 256, 50   # the 3,072-d index searched by a batch
K4Q_SMALL_DIM = 100           # GloVe-100's width


def k4_query_calls(dev, db, idx, q):
    """The query-major wide pass's calls, kept (wrapper, arguments) from
    the 3,072-d store's own statements and search and from a 100-d store's
    search."""
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.utils.datasets import emb_pool

    name = "ivf_probe_sq8_wide_query"
    lit = cs._sql_vec(cs._parsed(q[:1])[0])
    calls = {}

    def capture(case, fn):
        with cs._WideCalls() as wide:
            fn()
        cs.check(name in wide.calls, f"{case}: no query-major wide pass")
        calls[case] = wide.calls[name]

    for limit in cs.EMB_3072_LIMITS:
        capture(f"LIMIT {limit}", lambda: db.query(cs._sql_ann(lit, limit)))
    capture(f"B={K4Q_B} nprobe {K4Q_NPROBE}",
            lambda: idx.search(q[:K4Q_B], cs.K, nprobe=K4Q_NPROBE))
    x1, q1 = emb_pool(np.random.default_rng(4), cs.N_3072, n_queries=1, dim=K4Q_SMALL_DIM)
    small = IvfIndex(dim=K4Q_SMALL_DIM, sq8=True, rerank=cs.EMB_3072_RERANK, device=dev)
    small.add(x1)
    capture(f"d={K4Q_SMALL_DIM} nprobe {K4Q_NPROBE}",
            lambda: small.search(q1, 50, nprobe=K4Q_NPROBE))
    return calls


def k4_query_run(libs, dev, out):
    """Part 5: the query-major wide pass at its four calls A B B A, then
    the 3,072-d statements with A and B in turns, into `out` as they come."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="turdb_wide_k4q_")
    try:
        db, _, q, out["setup"] = cs.emb_3072_store(dev, f"{tmp}/db",
                                                   n_queries=max(K4Q_B, N_SQL))
        idx = db.catalog["main"]["docs"].hnsw["iv"].index
        out["calls"] = {}
        for case, (fn, a, kw) in k4_query_calls(dev, db, idx, q).items():
            qc, cells, codes, members, alive = a[0], a[4], a[5], a[9], a[10]
            allowed = a[11] if len(a) > 11 else kw.get("allowed")
            d, m = codes.shape[-1], kw["m"]
            row = _probe_ab(libs, "ivf_probe_sq8_wide_query", fn, a, kw)
            row["shape"] = {"B": qc.shape[0], "P": cells.shape[1], "L": codes.shape[1], "d": d,
                            "m": m, "allowed": allowed is not None}
            row["stream_ms"] = cs._stream_ms("query", cells, members, alive, allowed, d, 16,
                                             d + 12, 12 * m)
            out["calls"][case] = row
            torch.cuda.empty_cache()
        lits = [cs._sql_vec(v) for v in cs._parsed(q[:N_SQL])]
        out["sql"] = {}
        for limit in cs.EMB_3072_LIMITS:
            key = f"LIMIT {limit}"
            out["sql"][key] = _sql_turns(libs, db, [cs._sql_ann(s, limit) for s in lits])
            cs.log(f"3072-d sql {key}: {json.dumps(out['sql'][key])}")
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SELECT_CASES = {"K7 wide U=16384 W=128 d=384": ("K7 wide", 16_384, 128, 384),
                "K7 wide W=64 d=768": ("K7 wide", None, 64, 768),
                "K7s wide U=512 W=100 d=768": ("K7s wide", 512, 100, 768)}


def _select_cases(calls):
    """{case: (key, call)} of SELECT_CASES among the captured calls."""
    out = {}
    for case, (kind, u, w, d) in SELECT_CASES.items():
        key = next((k for k in calls if k[0] == kind and k[2:] == (w, d)
                    and (u is None or k[1] == u)), None)
        cs.check(key is not None, f"{case}: no such call in the builds")
        out[case] = (key, calls[key])
    return out


def select_calls(libs, dev, xe):
    """The 384-d bulk build's seconds in TURNS, the K7 / K7s calls past
    the fast form's widths of its last B build, and those of a 768-d bulk
    build and wave add (with B)."""
    from turdb_tpu_torch.models.hnsw import HnswIndex
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.utils.datasets import emb_pool

    def hnsw(x, dim):
        return HnswIndex(dim=dim, metric=Metric.COSINE, ef_construction=100, build_batch=512,
                         capacity=len(x), device=dev)

    build_s, calls = {}, {}
    for turn in TURNS:
        libs.use(turn)
        idx = hnsw(xe, cs.EMB_DIM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _SelectCalls() as sel:
            idx.add(xe)
        torch.cuda.synchronize()
        build_s.setdefault(turn, []).append(time.perf_counter() - t)
        if turn == "B":
            calls = sel.calls
    libs.use("B")
    x7, _ = emb_pool(np.random.default_rng(1), cs.N_768 + cs.N_768_WAVE, n_queries=1, dim=768)
    i7 = hnsw(x7, 768)
    with _SelectCalls() as sel7:
        i7.add(x7[:cs.N_768])
        i7.add(x7[cs.N_768:])
    calls.update(sel7.calls)
    cs.log(f"K7 wide calls captured: {sorted(k[:4] for k in calls)}")
    return calls, build_s


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    libs = Libraries(other)
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "ptxas_B.txt").write_text(build.build_log)
    (cs.OUT / "ptxas_A.txt").write_text(libs.other_build.build_log)
    out = {"card": card, "other": str(other)}
    flags = set(sys.argv[2:])
    only = {"--k2-only", "--beams-only", "--probe-select-only", "--k4-query"} & flags

    def part(flag):
        return not only or flag in only

    out.update(k2={}, beams={}, probe_select={}, k4_query={})
    try:   # the parts done so far are written out whatever stops a later one
        if part("--k2-only"):
            out["k2"] = k2_run(libs, k2_cases(dev))
        if part("--beams-only"):
            calls, setup = beam_calls(dev)
            i7, q7 = setup.pop("search_768")
            out["setup"] = setup
            out["beams"] = beam_run(libs, calls)
            out["search_768"] = search_768_run(libs, i7, q7)
            del calls, i7
            torch.cuda.empty_cache()
        if not only and "--no-sql" not in flags:
            out["sql"] = sql_run(libs, dev)
        if part("--probe-select-only"):
            probe_select_run(libs, dev, out["probe_select"])
        if "--k4-query" in flags:
            k4_query_run(libs, dev, out["k4_query"])
    finally:
        print(json.dumps(out))
        (cs.OUT / "exp_torch_wide_kernels.json").write_text(json.dumps(out, indent=1))
    part4 = out["probe_select"]
    ok = (all(v["equal_A_B"] and v["equal_plain"] for v in out["k2"].values())
          and all(_beam_ok(v) for v in out["beams"].values())
          and out.get("search_768", {}).get("same_ids_A_B", True)
          and all(v["equal_A_B"] for v in part4.get("probes", {}).values())
          and all(v["equal_A_B"] for v in out["k4_query"].get("calls", {}).values())
          and all(v["same_rows_A_B"] for v in out["k4_query"].get("sql", {}).values())
          and all(v["equal_A_B"] and all(f.get("equal_routed", True)
                                         for f in v["forced"].values())
                  for v in part4.get("select", {}).values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
