"""K2's wide form and the wide beams on one card: two builds side by side.

A is compiled from the `csrc/` of another checkout of the repository (an
older commit, unpacked with `git archive`; its own `build.py` builds it and
gives its argtypes), B from this one. While A is in use this checkout's K2
wrapper takes its global route (`topk_wide_ctas` gives 0: `topk_rows` with
the rows' keys in a global scratch, the launch the older wrapper made past
SEL_MAX), so A is the older kernels throughout. Each case runs A B B A;
each time is `ms` (one call between CUDA events, the host's launch path
included), `loop_ms` (ten calls back to back, a tenth of the time) and
`device_ms` (a trace's device time of the kernel, a call). Every output of
B must equal A's bit for bit; K2's must equal the plain version's too.

1. K2 past SEL_MAX at [64, 5000] k = 3000 (chip_smoke width_check's, the L2
   epilogue), [1, 76,800] k = 4,800 and 2,400 (the wide probes' distances),
   [1, 2400] k = 2400 (K5 wide's) and [256, 131,072] k = 3000 (a flat
   oracle chunk, L2 clamped), each beside `torch.topk` of the same values
   (ms and device ms) and its bound;
2. the wide beams on chip_smoke's emb rows (emb_pool 500k x 384, cosine,
   the bulk graph and its serving pack): K8 wide at the SQL LIMIT 200
   shape (B = 1, ef 1,600, k_res 800, every row allowed), K6 wide at the
   same on the pack, K8 wide at B = 1,024 and ef 1,500 (width_check's
   search at a full batch), and K8-SQ wide over the 768-d SQ8 store at ef
   1,600 (B = 32), each call captured from the index's own search
   (chip_smoke._WideCalls);
3. unless `--no-sql`: the emb path's deep SQL statements (chip_smoke
   _emb_sql's table and statement text, N_SQL a store) with A and B in
   turns: p50 / p99 ms of HNSW graph LIMIT 200, IVF LIMIT 600 and IVF WITH
   (sq8, rerank = 2400) LIMIT 600.

Run on a CUDA card (about five minutes on an H100):

    python3 scripts/exp_torch_wide_kernels.py OTHER_CHECKOUT [--no-sql | --k2-only | --beams-only]

`--k2-only` runs part 1 alone (about a minute), `--beams-only` part 2
alone (about two minutes). It prints one JSON
object and writes it to
chiprun_out/exp_torch_wide_kernels.json; ptxas reports land in
chiprun_out/ptxas_A.txt / ptxas_B.txt. Exits 1 unless every output of B
equals A's (and K2's the plain version's).
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

N_SQL = 16          # deep statements a store and turn
TURNS = ("A", "B", "B", "A")


class Libraries:
    """The two kernel libraries and the switch between them."""

    def __init__(self, other: Path):
        self.b = build.library()
        self.other_build = build_module(other)
        self.a = self.other_build.library()
        self.ctas = kernels.topk_wide_ctas

    def use(self, name):
        build._lib = self.a if name == "A" else self.b
        kernels._entry.clear()
        kernels.topk_wide_ctas = (lambda n, k: 0) if name == "A" else self.ctas


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
    x7, q7 = emb_pool(np.random.default_rng(1), cs.N_768, n_queries=32, dim=768)
    i7 = HnswIndex(dim=768, metric=Metric.COSINE, ef_construction=100, build_batch=512,
                   capacity=len(x7), device=dev)
    i7.add(x7)
    i7.quantize_sq8()
    capture("K8-SQ wide SQ8 768-d (B=32, ef 1600)", "hnsw_graph_beam_sq_wide",
            lambda: i7.search(q7, cs.K, ef=cs.EMB_DEEP_EF))
    return calls, setup


def _in_shared_memory(kernel, a, kw):
    """Whether this library runs the call with its state in shared memory
    (its scratch query gives 0 bytes)."""
    ef, iters, expand = kw["ef"], kw["iters"], kw.get("expand", 4)
    deg = a[0].shape[1]
    if kernel == "hnsw_serve_beam_wide":
        k_res, rerank = 0, min(kw.get("rerank") or ef, ef)
    else:
        allowed = a[7] if len(a) > 7 else kw.get("allowed")
        k_res, rerank = ((kw.get("k_res") or ef) if allowed is not None else 0), 0
    return build.library().hnsw_beam_wide_bytes(deg, ef, iters, expand, k_res, rerank) == 0


def beam_run(libs, calls):
    runs, outs = {}, {}
    for name in TURNS:
        libs.use(name)
        for case, (kernel, fn, a, kw) in calls.items():
            call = lambda: fn(*a, **kw)  # noqa: E731
            got = call()
            outs.setdefault(case, {})[name] = [t.clone() if isinstance(t, torch.Tensor) else t
                                               for t in got]
            trace = "serve_beam_wide" if kernel == "hnsw_serve_beam_wide" else "graph_beam_wide"
            runs.setdefault(case, {}).setdefault(name, []).append(_times(call, trace, calls=5))
    libs.use("B")
    out = {}
    for case, (kernel, fn, a, kw) in calls.items():
        got = fn(*a, **kw)
        out[case] = {"A": runs[case]["A"], "B": runs[case]["B"],
                     "equal_A_B": _equal(outs[case]["A"], outs[case]["B"]),
                     "state_in_shared_memory": _in_shared_memory(kernel, a, kw),
                     **cs._wide_bound(kernel, fn, a, kw, got)}
        cs.log(f"{case}: {json.dumps(out[case])}")
    return out


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
            sqls = [cs._sql_ann(s, limit) for s in lits]
            res = {}
            for name in TURNS:
                libs.use(name)
                db.query(sqls[0])
                rows, ms = cs._sql_timed(db, sqls)
                res.setdefault(name, []).append(cs._pcts(ms))
                res.setdefault("rows", {})[name] = [[r[0] for r in rr] for rr in rows]
            libs.use("B")
            out[store] = {"A": res["A"], "B": res["B"],
                          "same_rows_A_B": res["rows"]["A"] == res["rows"]["B"]}
            cs.log(f"sql {store}: {json.dumps(out[store])}")
            db.execute("DROP INDEX ix")
            torch.cuda.empty_cache()
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
    out["k2"] = {} if "--beams-only" in flags else k2_run(libs, k2_cases(dev))
    out["beams"] = {}
    if "--k2-only" not in flags:
        calls, out["setup"] = beam_calls(dev)
        out["beams"] = beam_run(libs, calls)
        del calls
        torch.cuda.empty_cache()
    if not {"--no-sql", "--k2-only", "--beams-only"} & flags:
        out["sql"] = sql_run(libs, dev)
    print(json.dumps(out))
    (cs.OUT / "exp_torch_wide_kernels.json").write_text(json.dumps(out, indent=1))
    ok = (all(v["equal_A_B"] and v["equal_plain"] for v in out["k2"].values())
          and all(v["equal_A_B"] for v in out["beams"].values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
