"""The IVF probe kernels (K1, K4) on one card: builds side by side, and
K4's two orders on the hard row's own probes.

1. builds kernel libraries from the `csrc/` of another checkout of the
   repository (A: an older commit, unpacked with `git archive`), from this
   checkout's (B), and from this checkout's with extra nvcc flags
   (`--variant NAME=FLAGS`, flags split on commas, e.g.
   `clk=-DPROBE_PHASE_CLOCKS`; to try other constants, edit a copy of
   `csrc/` and pass its checkout as OTHER_CHECKOUT); the C entry points
   keep their signatures from one commit to the next, so all run under the
   same wrappers (an older library lacks the cell-major entry points: its
   K4 runs query-major);
2. at every shape of chip_smoke.py's kernel phase (K1: P = 5, 64, 128,
   metrics 0 / 1 / 2, replicas, `allowed`, candidates, k = 300; K4: P = 8,
   64, 256, 512 in both modes, the COSINE and IP seeding; K4 in each of
   its two orders as well as by the shape rule) holds every other
   library's outputs bit-equal to A's;
3. times K1 (P = 5, 128), K4 in candidate mode (P = 8, 64, 256) and K5
   (r = 40 over the f32 and the SQ16 store, its outputs held equal to A's)
   with each library in turns A B V.. B A: `ms` (one call between CUDA
   events), `loop_ms` (ten calls back to back, a tenth of the time) and `device_ms`
   (a call's device time in a trace); K4 at P >= 64 also with B's
   query-major order (`B/query`). A variant built with
   -DPROBE_PHASE_CLOCKS adds the cycles a block spends in each phase of
   K1 / K4, one built with -DRERANK_PHASE_CLOCKS those of K5 and the
   span of its launch;
4. times B's query-major and cell-major K4 (candidates) at P = 8 to 64
   on the synthetic store: the crossover of the two orders;
5. builds the bench's ivf_hard index as chip_smoke.py does (make_pool,
   then hard_pool 1M x 128 from one generator; sq8, rerank 40), takes the
   index's own probes of 1024 hard queries at nprobe 256 and 512, and
   times K4 there: A, B's query-major and B's cell-major order.

Run on a CUDA card:

    python3 scripts/exp_torch_probe_kernels.py OTHER_CHECKOUT [--variant NAME=FLAGS ...] [--k5-only | --k11-only]

`--k5-only` runs K5's part of 3 alone (a minute, most of it the builds).
`--k11-only` runs K11 `sq8_scan` and the dense path's K2 + K10 pair alone
(about two minutes): on the bench's make_pool 1M x 128 as u8 codes (its
first 96 columns for d = 96) and 1024 of its held-out queries, K11 at
(k, d) = (10, 128), (100, 128), (10, 96), A B V.. B A: `ms` of the whole
`sq8_search` (K11 and its K2 merge), `loop_ms`, `device_ms` with its
parts, each library's ids and distances against the plain version (the
share of ids apart, the largest relative error, and whether every id
apart lies where the plain distances of the two ids are within DOT_RTOL
of the distance scale: a near-tie); A's K11 (an older commit's entry
point) takes k <= 32 only. A variant built with -DSQ8_PHASE_CLOCKS adds
the cycles a block spends in each phase of K11. Then the K2 + K10 pair at
the dense path's shape (B = 1024, C = 7936 cells, P = 16, u = 8): A's two
launches (K2, then its standalone K10) against B's one fused launch, A B B
A, the blocks bit-equal to `dense_blocks_plain`.

It prints one JSON object and writes it to exp_torch_probe_kernels.json
in chip_smoke.py's output directory (`chip_smoke.OUT`).
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from turdb_tpu_torch import kernels  # noqa: E402
from turdb_tpu_torch.kernels import build  # noqa: E402

HARD_PROBES = (256, 512)
CROSSOVER_PROBES = (8, 16, 24, 32, 40, 48, 64)


def load(name, csrc: Path, flags=()):
    """The kernel library compiled from `csrc` with extra nvcc flags (its
    ptxas report to ptxas_NAME.txt in `chip_smoke.OUT`); entry points it
    lacks are left out."""
    base = list(build.NVCC_FLAGS)
    build.CSRC, build.NVCC_FLAGS = csrc, base + list(flags)
    build.build_log = ""
    try:
        lib = ctypes.CDLL(str(build.build()))
    finally:
        build.NVCC_FLAGS = base
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / f"ptxas_{name}.txt").write_text(
        build.build_log or f"{build.library_path()} was built before this run: no report\n")
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for name in ("ivf_probe_clocks", "ivf_rerank_clocks"):
        clocks = getattr(lib, name, None)
        if clocks is not None:
            clocks.argtypes, clocks.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def has_cells(lib) -> bool:
    return getattr(lib, "ivf_probe_sq8_cells", None) is not None


ROUTE = kernels.probe_route


def use(lib, route=None):
    """Run the wrappers on `lib`; `route` forces K4's order ("query" /
    "cell"), None keeps the shape rule (query-major for a library without
    the cell-major pass)."""
    build._lib = lib
    kernels._entry.clear()
    if route is None and not has_cells(lib):
        route = "query"
    kernels.probe_route = ROUTE if route is None else (lambda *a, **kw: route)


PHASES = ("query+cells", "scoring", "selection", "outputs", "blocks",
          "cell metadata", "cell tiles", "cell blocks")
K5_PHASES = ("candidates", "rows", "dots", "duplicates", "selection", "outputs")


def k5_clocks(fn, lib):
    """A build with -DRERANK_PHASE_CLOCKS: K5's cycles a block in each phase
    and the launch's span from its first block's start to its last one's
    end (ns, %globaltimer)."""
    read = getattr(lib, "ivf_rerank_clocks", None)
    if read is None:
        return {}
    clocks = (ctypes.c_ulonglong * 9)()
    torch.cuda.synchronize()
    read(clocks)
    fn()
    torch.cuda.synchronize()
    read(clocks)
    c = list(clocks)
    return {"cycles_per_block": {**{p: c[i] / max(c[6], 1) for i, p in enumerate(K5_PHASES)},
                                 "blocks": c[6]},
            "span_ms": c[8] / 1e6}


def timing(fn, lib):
    dev_ms, parts = cs._device_parts(fn)
    out = {"ms": cs._median_ms(fn), "loop_ms": cs._loop_ms(fn), "device_ms": dev_ms,
           "device_parts": parts}
    read = getattr(lib, "ivf_probe_clocks", None)
    if read is not None:
        # a build with -DPROBE_PHASE_CLOCKS: cycles a block in each phase
        clocks = (ctypes.c_ulonglong * 8)()
        torch.cuda.synchronize()
        read(clocks)
        fn()
        torch.cuda.synchronize()
        read(clocks)
        c = list(clocks)
        out["cycles_per_block"] = {
            **{PHASES[i]: c[i] / max(c[4], 1) for i in range(4)},
            **{PHASES[i]: c[i] / max(c[7], 1) for i in (5, 6)},
            "blocks": c[4], "cell blocks": c[7]}
    return out


def cases(dev):
    """(kernel, shape, fn args, kwargs, what) at chip_smoke's shapes."""
    from turdb_tpu_torch.kernels import MODE_CAND, MODE_TOPK

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    st = cs.synthetic_f32_store(dev, gen)
    for p in cs.K1_PROBES:
        top = torch.rand(cs.BATCH, cs.CELLS, device=dev, generator=gen).topk(p).indices
        top = top.to(torch.int32)
        out += [("K1", p, args, kw, what) for args, kw, what in cs.k1_cases(st, p, top)]
        if p == cs.K1_PROBE:
            args = (st["q"], st["qn"], top, st["pvecs"], st["pnorms"], st["members"],
                    st["alive"], None)
            for k, m, mode in ((cs.RERANK, cs.RERANK, MODE_CAND), (300, 600, MODE_TOPK)):
                out.append(("K1", p, args, dict(metric=0, k=k, m=m, replicated=True, mode=mode),
                            f"K1 P={p} k={k} m={m} mode={mode}"))
    sq = cs.synthetic_sq8_store(dev, gen)
    for p in cs.K4_PROBES:
        cells = cs._paired_cells(dev, gen, p, sq["members"].shape[0], cs.BATCH)
        q = cs._queries_near(sq, cells, dev, gen)
        out += [("K4", p, args, kw, what) for args, kw, what in cs.k4_cases(sq, p, cells, q)]
    return out


def timed(kernel, p, args, kw):
    """The timed cases: chip_smoke's timed shapes (no `allowed`)."""
    from turdb_tpu_torch.kernels import MODE_CAND

    if args[-1] is not None:
        return False
    if kernel == "K1":
        return p in (cs.K1_PROBE, 128) and kw["metric"] == 0 and kw["replicated"] and \
            kw["k"] == cs.K and kw["m"] == 2 * cs.K
    return kw["mode"] == MODE_CAND and p in (cs.SQ8_PROBE, 64, cs.HARD_PROBE)


def run_case(kernel, args, kw):
    fn = kernels.ivf_probe_f32 if kernel == "K1" else kernels.ivf_probe_sq8
    return fn(*args, **kw)


def k5_cases(dev):
    """K5 (whose selection shares select.cuh with K1 and K4) at chip_smoke's
    timed shape, B = 1024, r = 40, d = 128, over the f32 and the SQ16 store,
    on K4's candidates at P = 8: {store: args}."""
    from turdb_tpu_torch.kernels import MODE_CAND

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    sq = cs.synthetic_sq8_store(dev, gen)
    cells = cs._paired_cells(dev, gen, cs.SQ8_PROBE, sq["members"].shape[0], cs.BATCH)
    q = cs._queries_near(sq, cells, dev, gen)
    args, kw, _ = next(c for c in cs.k4_cases(sq, cs.SQ8_PROBE, cells, q)
                       if c[1]["mode"] == MODE_CAND)
    cd, ci, cpos = kernels.ivf_probe_sq8(*args, **kw)
    head = (q, args[3], cd, ci, cpos)
    return {"f32": (*head, sq["pvecs"], sq["pnorms"]),
            "sq16": (*head, sq["u16"], sq["pnorms"], sq["mins"], sq["scales"])}


def hard_probes(dev):
    """The ivf_hard index's own probes: (name, args, kwargs) of K4 at
    HARD_PROBES for the first 1024 hard queries."""
    from turdb_tpu_torch.kernels import EPI_L2, MODE_CAND, topk_rows
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.ops.distance import prep_norms
    from turdb_tpu_torch.ops.quantize import quantize_queries
    from turdb_tpu_torch.utils.datasets import hard_pool, make_pool

    rng = np.random.default_rng(0)
    make_pool(rng, cs.N + cs.N_QUERIES, cs.DIM)
    xh, qh = hard_pool(rng, cs.N, cs.DIM, n_queries=cs.N_QUERIES)
    t = time.perf_counter()
    idx = IvfIndex(dim=cs.DIM, device=dev, sq8=True, rerank=cs.RERANK)
    idx.add(xh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    st, cfg = idx.state, idx.cfg
    q = torch.as_tensor(qh[:cs.BATCH], device=dev).float().contiguous()
    qn = prep_norms(q)
    qc, qs, qsum = quantize_queries(q)
    out = []
    for p in HARD_PROBES:
        _, top = topk_rows(q @ st.centroids.T, p, rown=qn, coln=st.cnorms, epilogue=EPI_L2)
        per_cell = torch.bincount(top.reshape(-1).long(), minlength=st.members.shape[0])
        args = (qc, qs, qsum, qn, top, st.codes, st.mins, st.scales, st.pnorms, st.members,
                st.alive, None)
        kw = dict(k=cs.RERANK, m=cs.RERANK, replicated=cfg.replicated, mode=MODE_CAND)
        out.append((f"hard P={p}", args, kw, {
            "cells": int(st.members.shape[0]), "L": int(st.members.shape[1]),
            "probed_cells": int((per_cell > 0).sum()),
            "queries_per_probed_cell": float(per_cell[per_cell > 0].float().mean()),
            "max_queries_a_cell": int(per_cell.max())}))
    return build_s, out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--k5-only", action="store_true")
    ap.add_argument("--k11-only", action="store_true")
    opts = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    mine = build.CSRC
    t = time.perf_counter()
    libs = {"A": load("A", Path(opts.other).resolve() / "turdb_tpu_torch" / "kernels" / "csrc"),
            "B": load("B", mine)}
    for v in opts.variant:
        name, flags = v.split("=", 1)
        libs[name] = load(name, mine, flags.split(","))
    build.CSRC = mine
    build_s = time.perf_counter() - t
    variants = [n for n in libs if n not in ("A", "B")]
    order = ["A", "B", *variants, "B", "A"]
    if opts.k11_only:
        out = {"card": card, "other": opts.other, "build_s": build_s, "variants": opts.variant,
               "order": order, **k11_ab(libs, order, dev)}
        use(libs["B"])
        text = json.dumps(out)
        print(text)
        cs.OUT.mkdir(exist_ok=True)
        (cs.OUT / "exp_torch_probe_kernels_k11.json").write_text(json.dumps(out, indent=1))
        return 1 if out["mismatches"] else 0

    all_cases = [] if opts.k5_only else cases(dev)
    # equality: every library against A at every case
    mismatches = []
    for kernel, p, args, kw, what in all_cases:
        use(libs["A"])
        want = run_case(kernel, args, kw)
        for name in libs:
            if name == "A":
                continue
            routes = [None] + (["query", "cell"] if kernel == "K4" and has_cells(libs[name])
                               else [])
            for route in routes:
                use(libs[name], route)
                got = run_case(kernel, args, kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    mismatches.append(f"{name}/{route or 'rule'}: {what}")
    # times, A B V.. V.. B A
    ab: dict = {}
    for name in order:
        lib = libs[name]
        for kernel, p, args, kw, what in all_cases:
            if not timed(kernel, p, args, kw):
                continue
            routes = [None]
            use(lib)
            if kernel == "K4" and has_cells(lib) and ROUTE(p, args[5].shape[1], cs.DIM) == "cell":
                routes.append("query")
            for route in routes:
                use(lib, route)
                key = f"{kernel} P={p}" + (f" {route}" if route else "")
                tag = name + (f"/{route}" if route else "")
                ab.setdefault(key, {}).setdefault(tag, []).append(
                    timing(lambda: run_case(kernel, args, kw), lib))
    n_cases = len(all_cases)
    del all_cases
    # K5, A B V.. B A, each library's outputs equal to A's
    use(libs["B"])
    k5 = k5_cases(dev)
    k5_want = {}
    for name in order:
        use(libs[name])
        for store, args in k5.items():
            got = kernels.ivf_rerank(*args, k=cs.K, replicated=True)
            want = k5_want.setdefault(store, got)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                mismatches.append(f"{name}: K5 {store}")
            def run():
                return kernels.ivf_rerank(*args, k=cs.K, replicated=True)

            ab.setdefault(f"K5 {store}", {}).setdefault(name, []).append(
                {**timing(run, libs[name]), **k5_clocks(run, libs[name])})
    del k5, k5_want
    torch.cuda.empty_cache()
    crossover, hard_build_s, hard_out = {}, None, {}
    if not opts.k5_only:
        crossover, hard_build_s, hard_out = k4_orders(libs, mismatches)
    use(libs["B"])
    out = {"card": card, "other": opts.other, "build_s": build_s, "variants": opts.variant,
           "order": order, "cases": n_cases, "mismatches": mismatches, "ab": ab,
           "crossover": crossover, "hard_build_s": hard_build_s, "hard": hard_out}
    text = json.dumps(out)
    print(text)
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "exp_torch_probe_kernels.json").write_text(json.dumps(out, indent=1))
    return 1 if mismatches else 0


K11_CASES = ((10, 128), (100, 128), (10, 96))   # (k, d) at B = 1024, N = 1M
K11_PHASES = ("product", "epilogue+selection", "copy wait", "barrier", "outputs")
# the older commits' C entry point of K11: q, qn, qsum, B, codes, mins, scales, valid,
# N, d, chunk, k (<= 32), out_d, out_i, stream
_OLD_SQ8 = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
# the older commits' K2 and (standalone) K10 entry points
_OLD_TOPK = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
_OLD_DENSE = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _old_sq8(lib, q, qn, qsum, codes, mins, scales, valid, k):
    """An older library's K11 (one launch, a [B, k] list a chunk of 8192
    rows) and this checkout's K2 merge of the chunks."""
    fn = lib.sq8_scan
    fn.argtypes, fn.restype = _OLD_SQ8, ctypes.c_int
    b, d = q.shape
    n = codes.shape[0]
    nch = -(-n // kernels.SQ8_CHUNK)
    part_d = torch.empty((b, nch * k), device=q.device)
    part_i = torch.empty((b, nch * k), dtype=torch.int32, device=q.device)
    err = fn(q.data_ptr(), qn.data_ptr(), qsum.data_ptr(), b, codes.data_ptr(), mins.data_ptr(),
             scales.data_ptr(), valid.data_ptr(), n, d, kernels.SQ8_CHUNK, k, part_d.data_ptr(),
             part_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other library's sq8_scan failed ({err})")
    dk, pos = kernels.topk_rows(part_d, k)
    ik = torch.gather(part_i, 1, pos.long())
    return dk, torch.where(torch.isinf(dk), -1, ik)


def _agreement(got, want):
    """Share of ids apart, largest relative distance error, and whether
    every id apart is a near-tie: the plain distances at the two ids within
    DOT_RTOL of the distance scale."""
    (dk, ik), (dp, ip) = got, want
    fin = torch.isfinite(dp)
    scale = max(float(dp[fin].abs().max()), 1.0)
    apart = (ik != ip) & fin
    rel = ((dk - dp).abs() / dp.abs().clamp_min(1e-30))[fin]
    return {"ids_apart": float(apart.float().mean()), "max_rel_err": float(rel.max()),
            "max_abs_err": float((dk - dp)[fin].abs().max()),
            "apart_at_near_ties": bool(((dk - dp).abs()[apart] <= cs.DOT_RTOL * scale).all())}


def _k11_clocks(lib, fn):
    read = getattr(lib, "sq8_scan_clocks", None)
    if read is None:
        return {}
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    c = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize()
    read(c)
    fn()
    torch.cuda.synchronize()
    read(c)
    c = list(c)
    return {"cycles_per_block": {**{p: c[i] / max(c[5], 1) for i, p in enumerate(K11_PHASES)},
                                 "blocks": c[5]}}


def k11_ab(libs, order, dev):
    """--k11-only: K11 and the K2 + K10 pair, A B V.. B A (see the module
    docstring)."""
    from turdb_tpu_torch.kernels import EPI_L2, dense_blocks_plain
    from turdb_tpu_torch.ops.quantize import sq8_encode
    from turdb_tpu_torch.utils.datasets import make_pool

    pool = make_pool(np.random.default_rng(0), cs.N + cs.N_QUERIES, cs.DIM)
    xd = torch.as_tensor(pool[:cs.N], device=dev)
    qd = torch.as_tensor(pool[cs.N:cs.N + cs.BATCH], device=dev)
    del pool
    valid = torch.ones(cs.N, dtype=torch.bool, device=dev)
    stores = {}
    for d in sorted({d for _, d in K11_CASES}):
        codes, mins, scales = sq8_encode(xd[:, :d].contiguous())
        q = qd[:, :d].contiguous()
        stores[d] = (q, (q * q).sum(1), q.sum(1), codes, mins, scales, valid)
    del xd
    mismatches, rows = [], {}
    for k, d in K11_CASES:
        args = stores[d]
        use(libs["B"])
        want = kernels.sq8_scan_plain(*args, k)
        plain_ms = cs._median_ms(lambda: kernels.sq8_scan_plain(*args, k), reps=3)
        row = {"plain_ms": plain_ms, **cs._bound(
            cs.N * d + 12 * cs.N + cs.BATCH * (4 * d + 8) + 8 * cs.BATCH * k,
            2 * cs.BATCH * cs.N * d, cs.FP32_OPS)}
        for name in order:
            if name == "A" and k > 32:
                continue
            # A's K11 by its own entry point, its merge by B's K2 (unchanged)
            use(libs["B" if name == "A" else name])
            fn = ((lambda: _old_sq8(libs["A"], *args, k)) if name == "A"
                  else (lambda: kernels.sq8_scan(*args, k)))
            agree = _agreement(fn(), want)
            if not agree["apart_at_near_ties"]:
                mismatches.append(f"{name}: K11 k={k} d={d}")
            row.setdefault(name, []).append({**timing(fn, libs[name]), **agree,
                                             **_k11_clocks(libs[name], fn)})
        rows[f"k={k} d={d}"] = row
    del stores
    torch.cuda.empty_cache()
    # the dense path's cell selection: K2 + K10 (A: two launches) or K2 with
    # K10 fused (B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, c, p, u = cs.BATCH, 7936, 16, 8
    q = torch.randn((b, cs.DIM), device=dev, generator=gen)
    cents = torch.randn((c, cs.DIM), device=dev, generator=gen)
    cnorms, qn = (cents * cents).sum(1), (q * q).sum(1)
    cell_block = torch.randint(0, c // 3, (c,), device=dev, generator=gen, dtype=torch.int32)
    dots = q @ cents.T

    def pair_old():
        lib = libs["A"]
        lib.topk_rows.argtypes, lib.dense_blocks.argtypes = _OLD_TOPK, _OLD_DENSE
        s = torch.cuda.current_stream().cuda_stream
        vals = torch.empty((b, p), device=dev)
        top = torch.empty((b, p), dtype=torch.int32, device=dev)
        out = torch.empty((b, u), dtype=torch.int32, device=dev)
        assert lib.topk_rows(dots.data_ptr(), b, c, qn.data_ptr(), cnorms.data_ptr(), None,
                             EPI_L2, 0, p, vals.data_ptr(), top.data_ptr(), None, None, None,
                             s) == 0
        assert lib.dense_blocks(cell_block.data_ptr(), top.data_ptr(), b, p, u, out.data_ptr(),
                                s) == 0
        return top, out

    def pair_new():
        _, top, out = kernels.topk_rows(dots, p, rown=qn, coln=cnorms, epilogue=EPI_L2,
                                        cell_block=cell_block, u=u)
        return top, out

    use(libs["B"])
    want_top, want = pair_new()
    plain = dense_blocks_plain(cell_block, want_top, u)
    if not torch.equal(want, plain):
        mismatches.append("B: fused K10 differs from dense_blocks_plain")
    pair = {"shape": [b, c], "P": p, "u": u}
    for name in ("A", "B", "B", "A"):
        use(libs["B"])
        fn = pair_old if name == "A" else pair_new
        top, blocks = fn()
        if not (torch.equal(top, want_top) and torch.equal(blocks, plain)):
            mismatches.append(f"{name}: the K2 + K10 pair")
        pair.setdefault(name, []).append(timing(fn, libs[name]))
    return {"k11": rows, "k2_k10": pair, "mismatches": mismatches}


def k4_orders(libs, mismatches):
    """Parts 4 and 5: B's two orders of K4 at the crossover widths, and K4
    on the hard index's own probes (A, B query-major, B cell-major)."""
    dev = torch.device("cuda")
    # the crossover: B's two orders of K4 (candidates, r = 40) at widths
    # around one chunk of lanes
    crossover = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sq = cs.synthetic_sq8_store(dev, gen)
    for p in CROSSOVER_PROBES:
        cells = cs._paired_cells(dev, gen, p, sq["members"].shape[0], cs.BATCH)
        q = cs._queries_near(sq, cells, dev, gen)
        args, kw, _ = next(c for c in cs.k4_cases(sq, p, cells, q) if c[1]["k"] == cs.RERANK)
        for route in ("query", "cell"):
            use(libs["B"], route)
            crossover.setdefault(f"P={p}", {})[route] = timing(
                lambda: kernels.ivf_probe_sq8(*args, **kw), libs["B"])
    del sq
    torch.cuda.empty_cache()
    hard_build_s, hard = hard_probes(dev)
    hard_out = {}
    for name, args, kw, info in hard:
        use(libs["A"])
        want = kernels.ivf_probe_sq8(*args, **kw)
        rows = {"info": info}
        for tag, lib, route in (("A", "A", None), ("B/query", "B", "query"),
                                ("B/cell", "B", "cell"), ("B/cell", "B", "cell"),
                                ("B/query", "B", "query"), ("A", "A", None)):
            use(libs[lib], route)
            got = kernels.ivf_probe_sq8(*args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                mismatches.append(f"{tag}: {name}")
            rows.setdefault(tag, []).append(
                timing(lambda: kernels.ivf_probe_sq8(*args, **kw), libs[lib]))
        hard_out[name] = rows
    return crossover, hard_build_s, hard_out


if __name__ == "__main__":
    sys.exit(main())
