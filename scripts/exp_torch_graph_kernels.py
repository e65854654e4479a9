"""The HNSW graph kernels on one card: two builds side by side, and where
K8's steps spend their cycles.

Builds the bench's hnsw index (make_pool 1M x 128, the bulk build, as
chip_smoke.py does) and, from the first 65,536 rows, a graph built by the
insert waves (chip_smoke's hnsw_wave index), then:

1. times the graph kernels with two kernel libraries in turn, A B B A: A
   compiled from the `csrc/` of another checkout of the repository (an
   older commit, unpacked with `git archive`; its own `build.py` builds it
   and gives its argtypes), B from this one. Each time is `ms` (one call
   between CUDA events, the host's launch path included), `loop_ms` (ten
   calls back to back, a tenth of the time) and, for K6, K8, K8-SQ and
   K9, `device_ms` (a trace's device time a call):
   - K6 at chip_smoke's two shapes (B = 1024 over the 1M serving pack, ef
     32 / iters 24 and ef 192 / iters 160, chip_smoke.k6_cases), with
     `device_ms`: every output (distances, ids, stats) of B must equal
     A's bit for bit;
   - K7 and K8 at chip_smoke's shapes (chip_smoke.k7_check, k8_check,
     which also hold each kernel against its plain version);
   - K8-SQ over the SQ8 and SQ16 stores at chip_smoke's search shape (B =
     1024 through level 0 from the SQ store's upper-level beams, ef 64),
     with `allowed` and with the expanded ids as well: every output buffer
     of B must equal A's bit for bit;
   - K9: a wave of 512 held-out rows through levels 3-1 of the 1M graph
     and the 1024-query descent of the wave-built graph, as one launch
     (B's multi-level call) and as one launch a level (B's one-level call,
     and A's when its entry point takes one level, as older builds' does),
     one level alone both ways, and the wave with each row stopping above its
     own level: every end and every step count of B must equal A's;
2. compiles each checkout's hnsw_beam.cu once more with -DBEAM_PHASE_CLOCKS
   and runs K8 at the search (ef 64), descent (ef 32, expand 2) and refine
   (ef 32, 4096 rows) shapes, K8-SQ at the search shape and K6 at its two
   shapes: the cycles of each phase of a step, summed over blocks, per
   step, and K6's rerank (with its ranks) a block.

Run on a CUDA card (about four minutes on an H100):

    python3 scripts/exp_torch_graph_kernels.py OTHER_CHECKOUT [--phases-only]

`--phases-only` runs part 2 alone. It prints one JSON object and writes
it to chiprun_out/exp_torch_graph_kernels.json.
"""

import ctypes
import importlib.util
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
from turdb_tpu_torch.models.hnsw import (  # noqa: E402
    HnswIndex,
    _beam_level,
    _seed_from_entry,
    select_levels,
)
from turdb_tpu_torch.ops.distance import Metric  # noqa: E402
from turdb_tpu_torch.ops.quantize import Sq8Rows, sq_rows_encode  # noqa: E402
from turdb_tpu_torch.utils.datasets import make_pool  # noqa: E402

PHASES = ("seeds", "select+members", "claims", "score+runs", "merge")
GATE = (32, 24)   # HNSW serve's gate (ef, iters), chip_smoke's K6 shape


def build_module(checkout: Path):
    """A checkout's own kernels/build.py (its sources, flags and argtypes)."""
    path = checkout / "turdb_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"build_{abs(hash(str(checkout)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use(lib):
    build._lib = lib
    kernels._entry.clear()


def _equal(a, b):
    return all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))


def _times(fn, kernel, launches=1):
    """ms, loop_ms, and device_ms: the mean device time of the kernel's
    launches a trace kept, times the launches a call makes."""
    return {"ms": cs._median_ms(fn), "loop_ms": cs._loop_ms(fn),
            "device_ms": cs._trace_ms(fn, kernel) * launches}


def beam_timings(idx, batch, gate):
    gen = torch.Generator(device=batch.device)
    gen.manual_seed(1)
    out = {}
    for name, res in (("K8", cs.k8_check(idx, batch)), ("K7", cs.k7_check(idx, gen))):
        for shape, v in res.items():
            out[f"{name} {shape}"] = {k: v[k] for k in ("ms", "loop_ms", "device_ms") if k in v}
    return out


def k6_run(cases):
    """K6's outputs and times at chip_smoke's shapes."""
    out, bufs = {}, {}
    for ef, args, kw in cases:
        bufs[f"ef{ef}"] = [t.clone() for t in kernels.hnsw_serve_beam(*args, **kw)]
        out[f"K6 ef{ef}"] = _times(lambda: kernels.hnsw_serve_beam(*args, **kw), "serve_beam")
    return out, bufs


def sq_seeds(st, rows, qb, qbn):
    """chip_smoke.k8sq_check's seeds: the SQ store's upper-level beams."""
    si, sd = _seed_from_entry(rows, st.norms, qb, qbn, st.entry, Metric.L2)
    si, sd = si[:, None], sd[:, None]
    for lvl in range(len(st.adj_hi), 0, -1):
        sd, si = _beam_level(st.adj_hi[lvl - 1], rows, st.norms, qb, qbn, si, sd, 32, 64,
                             Metric.L2, expand=2)
    return si.contiguous(), sd.contiguous()


def k8sq_cases(idx, qb):
    """(name, args, kw) of K8-SQ at chip_smoke's search shape, per store."""
    st = idx.state
    qbn = (qb * qb).sum(1)
    allowed = torch.rand(st.vectors.shape[0], device=qb.device,
                         generator=torch.Generator(device=qb.device).manual_seed(2)) < 0.5
    cases = []
    for bits in (8, 16):
        rows = sq_rows_encode(st.vectors, bits)
        si, sd = sq_seeds(st, rows, qb, qbn)
        args = (st.adj0, rows, st.norms, qb, qbn, si, sd)
        base = dict(ef=64, iters=96, metric=0, expand=4)
        cases += [(f"sq{bits}", args, base),
                  (f"sq{bits}_allowed", (*args, allowed), dict(base, k_res=16)),
                  (f"sq{bits}_expanded", args, dict(base, return_expanded=True))]
    return cases


def k8sq_run(cases, timed):
    out, bufs = {}, {}
    for name, args, kw in cases:
        res = kernels.hnsw_graph_beam(*args, **kw)
        bufs[name] = [t.clone() if t is not None else None for t in res]
        if timed or name in ("sq8", "sq16"):
            out[name] = _times(lambda: kernels.hnsw_graph_beam(*args, **kw),
                               "graph_beam")
    return out, bufs


def greedy_one_level(fn):
    """K9 through one level a launch, by an entry point that takes one
    adjacency (an older build's argtypes): adj, vectors, codes, bits, mins, scales,
    norms, q, qn, cur_i, cur_d, B, d, deg, metric, out_i, out_d, out_stats,
    stream."""
    def run(adj, rows, norms, q, qn, cur_i, cur_d):
        b, d = q.shape
        sq = isinstance(rows, Sq8Rows)
        out = (torch.empty(b, dtype=torch.int32, device=q.device),
               torch.empty(b, device=q.device),
               torch.empty((b, 2), dtype=torch.int32, device=q.device))
        err = fn(adj.data_ptr(), None if sq else rows.data_ptr(),
                 rows.codes.data_ptr() if sq else None, rows.bits if sq else 0,
                 rows.mins.data_ptr() if sq else None, rows.scales.data_ptr() if sq else None,
                 norms.data_ptr(), q.data_ptr(), qn.data_ptr(), cur_i.data_ptr(),
                 cur_d.data_ptr(), b, d, adj.shape[1], 0, *(t.data_ptr() for t in out),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run


def greedy_chain(level_fn, adjs, rows, norms, q, qn, cur_i, cur_d, lowest=None):
    """One launch a level, top first; a row walks the levels whose number
    (len(adjs) - 1 for the first) is at least its `lowest`."""
    steps = torch.zeros((q.shape[0], 2), dtype=torch.int32, device=q.device)
    for j, adj in enumerate(adjs):
        ni, nd, ns = level_fn(adj, rows, norms, q, qn, cur_i, cur_d)
        walks = (torch.ones_like(cur_i, dtype=torch.bool) if lowest is None
                 else lowest <= len(adjs) - 1 - j)
        cur_i = torch.where(walks, ni, cur_i).contiguous()
        cur_d = torch.where(walks, nd, cur_d).contiguous()
        steps += torch.where(walks[:, None], ns, 0)
    return cur_i, cur_d, steps


def k9_cases(ins, wave, wave_q, batch):
    """(name, adjs, rows, norms, q, qn, cur_i, cur_d, lowest) at chip_smoke's
    K9 shapes."""
    cases = []
    for name, idx, q in (("wave512", ins, wave_q), ("descent1024", wave, batch)):
        st = idx.state
        q = q.float().contiguous()
        qn = (q * q).sum(1)
        ci, cd = _seed_from_entry(st.vectors, st.norms, q, qn, st.entry, Metric.L2)
        adjs = [st.adj_hi[lvl - 1] for lvl in range(st.max_level, 0, -1)]
        cases.append((name, adjs, st.vectors, st.norms, q, qn, ci, cd, None))
        if name == "wave512":
            slots = np.arange(idx.size, idx.size + len(q), dtype=np.uint64)
            lowest = torch.as_tensor(select_levels(slots, idx.cfg), device=q.device)
            cases.append(("wave512_levels", adjs, st.vectors, st.norms, q, qn, ci, cd, lowest))
            # level 1 alone, from the ends of levels 3-2
            e_i, e_d, _ = greedy_chain(lambda *a: kernels.hnsw_greedy(*a, metric=0), adjs[:-1],
                                       st.vectors, st.norms, q, qn, ci, cd)
            cases.append(("level1", adjs[-1:], st.vectors, st.norms, q, qn, e_i, e_d, None))
    return cases


def k9_run(cases, one_level, fused):
    """Each case's ends and step counts, and its times: one launch a level
    (`one_level`), and, where the library takes several levels, one launch."""
    out, ends = {}, {}
    for name, adjs, rows, norms, q, qn, ci, cd, lowest in cases:
        def chain():
            return greedy_chain(one_level, adjs, rows, norms, q, qn, ci, cd, lowest)
        ends[name] = chain()
        if lowest is None:
            launches = [lambda adj=adj: one_level(adj, rows, norms, q, qn, ci, cd)
                        for adj in adjs]
            out[f"{name} one_level"] = _times(lambda: [f() for f in launches],
                                              "greedy_kernel", len(adjs))
        if fused:
            def once():
                return kernels.hnsw_greedy(adjs, rows, norms, q, qn, ci, cd, metric=0,
                                           lowest=lowest)
            res = once()
            ends[f"{name} fused"] = res
            if lowest is None:
                out[f"{name} fused"] = _times(once, "greedy_kernel")
            out[f"{name} longest_chain"] = int(res[2][:, 0].max())
    return out, ends


def phase_library(csrc: Path, tag: str):
    """A checkout's hnsw_beam.cu alone, with the phase clocks."""
    out = build.BUILD_DIR / f"beam_phase_clocks_{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DBEAM_PHASE_CLOCKS", "-I", str(csrc),
                    "-shared", "-o", str(out), str(csrc / "hnsw_beam.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name in ("hnsw_graph_beam", "hnsw_graph_beam_sq", "hnsw_serve_beam"):
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.hnsw_beam_clocks.argtypes = [ctypes.c_void_p]
    lib.hnsw_beam_clocks.restype = ctypes.c_int
    return lib


def phases(idx, batch, lib, k6):
    """Cycles a step of each phase (summed over blocks, over the steps all
    blocks took) at the search, descent and refine shapes, at the search
    shape over the SQ8 and SQ16 stores, and for K6 (`k6`: chip_smoke's
    cases, seeded with this checkout's K4) at its two shapes, with its
    rerank's cycles a block and their share of a block's cycles."""
    use(lib)
    st = idx.state
    clocks = (ctypes.c_ulonglong * 8)()

    def read():
        torch.cuda.synchronize()
        assert lib.hnsw_beam_clocks(clocks) == 0
        c = list(clocks)
        per = {p: c[i] / max(c[5], 1) for i, p in enumerate(PHASES)}
        loop = sum(per[p] for p in PHASES[1:])
        out = {"steps": c[5], **per, "score_share": per["score+runs"] / max(loop, 1)}
        if c[7]:
            out.update({"blocks": c[7], "rerank": c[6] / c[7],
                        "rerank_share": c[6] / max(sum(c[:5]) + c[6], 1)})
        return out

    qb = batch.float().contiguous()
    qbn = (qb * qb).sum(1)
    si, sd = _seed_from_entry(st.vectors, st.norms, qb, qbn, st.entry, Metric.L2)
    si, sd = si[:, None], sd[:, None]
    for lvl in range(len(st.adj_hi), 1, -1):
        sd, si = _beam_level(st.adj_hi[lvl - 1], st.vectors, st.norms, qb, qbn, si, sd, 32, 64,
                             Metric.L2, expand=2)
    read()
    out = {}
    sd1, si1 = _beam_level(st.adj_hi[0], st.vectors, st.norms, qb, qbn, si, sd, 32, 64,
                           Metric.L2, expand=2)
    out["descent"] = read()
    _beam_level(st.adj0, st.vectors, st.norms, qb, qbn, si1, sd1, 64, 96, Metric.L2)
    out["search"] = read()
    rows = torch.nonzero(st.levels[:idx.size] >= 1)[:4096, 0]
    q1, q1n = st.vectors[rows], st.norms[rows]
    s1, d1 = _seed_from_entry(st.vectors, st.norms, q1, q1n, st.entry, Metric.L2)
    _beam_level(st.adj_hi[0], st.vectors, st.norms, q1, q1n, s1, d1, 32, 48, Metric.L2,
                return_expanded=True)
    out["refine"] = read()
    for bits in (8, 16):
        rows = sq_rows_encode(st.vectors, bits)
        s_i, s_d = sq_seeds(st, rows, qb, qbn)
        read()
        _beam_level(st.adj0, rows, st.norms, qb, qbn, s_i, s_d, 64, 96, Metric.L2)
        out[f"search_sq{bits}"] = read()
        del rows
    for ef, args, kw in k6:
        kernels.hnsw_serve_beam(*args, **kw)
        out[f"serve_ef{ef}"] = read()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    phases_only = "--phases-only" in sys.argv[2:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    lib_b = build.library()
    other_build = None if phases_only else build_module(other)
    lib_a = None if phases_only else other_build.library()
    if lib_a is not None:
        # entry points whose arguments have not changed run under this
        # checkout's wrappers: their argtypes (K9's levels struct) are this
        # build's
        for name, argtypes in build.SIGNATURES.items():
            if len(other_build.SIGNATURES.get(name, ())) == len(argtypes):
                getattr(lib_a, name).argtypes = argtypes
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "ptxas_B.txt").write_text(build.build_log)
    if other_build is not None:
        (cs.OUT / "ptxas_A.txt").write_text(other_build.build_log)
    pool = make_pool(np.random.default_rng(0), cs.N + cs.N_QUERIES, cs.DIM)
    x, queries = pool[:cs.N], pool[cs.N:]
    t = time.perf_counter()
    idx = cs._hnsw_index(dev)
    idx.add(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    batch = torch.as_tensor(queries[:cs.BATCH], device=dev)
    out = {"card": card, "other": str(other), "build_s": build_s}
    idx.pack_serving()
    k6 = cs.k6_cases(idx, batch, GATE)
    if not phases_only:
        wave = HnswIndex(dim=cs.DIM, ef_construction=100, build_batch=512, capacity=cs.N_WAVE,
                         bulk_threshold=cs.N_WAVE + 1, device=dev)
        wave.add(x[:cs.N_WAVE])
        wave_q = torch.as_tensor(queries[cs.BATCH:cs.BATCH + 512], device=dev)
        sq_cases = k8sq_cases(idx, batch.float().contiguous())
        g_cases = k9_cases(idx, wave, wave_q, batch)
        # A's K9 entry point: one level a launch in older builds, else the wrapper's
        a_one_level = len(other_build.SIGNATURES["hnsw_greedy"]) != len(
            build.SIGNATURES["hnsw_greedy"])
        runs, bufs, ends, k6_bufs = [], {}, {}, {}
        for name in ("A", "B", "B", "A"):
            lib = {"A": lib_a, "B": lib_b}[name]
            use(lib)
            one_level = (greedy_one_level(lib_a.hnsw_greedy) if name == "A" and a_one_level
                         else lambda *a: kernels.hnsw_greedy(*a, metric=0))
            r = beam_timings(idx, batch, GATE)
            k6_t, k6_bufs[name] = k6_run(k6)
            sq_t, bufs[name] = k8sq_run(sq_cases, timed=True)
            g_t, ends[name] = k9_run(g_cases, one_level, fused=name == "B" or not a_one_level)
            runs.append((name, {**r, **k6_t, **{f"K8-SQ {k}": v for k, v in sq_t.items()},
                                **{f"K9 {k}": v for k, v in g_t.items()}}))
        use(lib_b)
        keys = list(dict.fromkeys(k for _, r in runs for k in r))
        out["ab"] = {k: {n: [r[k] for m, r in runs if m == n and k in r] for n in ("A", "B")}
                     for k in keys}
        out["k6_equal"] = {c: _equal(k6_bufs["A"][c], k6_bufs["B"][c]) for c in k6_bufs["A"]}
        out["k8sq_equal"] = {c: _equal(bufs["A"][c], bufs["B"][c]) for c in bufs["A"]}
        out["k8sq_stage"] = {bits: kernels.graph_beam_sq_stage(
            cs.BATCH, 1, cs.DIM, idx.cfg.m0, ef=64, iters=96, expand=4, k_res=0, bits=bits)
            for bits in (8, 16)}
        out["k9_equal"] = {c: _equal(ends["A"][c], ends["B"][c]) for c in ends["A"]}
        out["k9_fused_equals_chain"] = {
            c: _equal(ends["B"][c], ends["B"][f"{c} fused"])
            for c in ends["B"] if not c.endswith(" fused")}
        del sq_cases, g_cases, wave
    out["phases"] = {}
    if not phases_only:
        out["phases"]["A"] = phases(idx, batch, phase_library(
            other / "turdb_tpu_torch" / "kernels" / "csrc", "A"), k6)
    out["phases"]["B"] = phases(idx, batch, phase_library(build.CSRC, "B"), k6)
    use(lib_b)
    print(json.dumps(out))
    (cs.OUT / "exp_torch_graph_kernels.json").write_text(json.dumps(out, indent=1))
    ok = all(all(out.get(key, {}).values())
             for key in ("k6_equal", "k8sq_equal", "k9_equal", "k9_fused_equals_chain"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
