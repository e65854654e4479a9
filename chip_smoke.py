#!/usr/bin/env python3
"""Drive the port's IVF, HNSW, mesh and SQL build, insert and query paths once on one CUDA card.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit); exits non-zero at
   once without CUDA;
2. builds the hand-written kernels (K1 ivf_probe_f32, K2 topk_rows,
   K3 kmeans_assign, K4 ivf_probe_sq8, K5 ivf_rerank, K6 hnsw_serve_beam,
   K7 hnsw_select and its presorted mode, K8 hnsw_graph_beam and its SQ
   reader, K9 hnsw_greedy, K10 dense_blocks (inside K2's launch), K11
   sq8_scan) from
   `turdb_tpu_torch/kernels/csrc`, one nvcc
   per source, and prints the build seconds;
3. kernel phase: each kernel against its plain PyTorch version on the same
   CUDA tensors at the main paths' shapes (and K1 / K2 at the widths past
   the old limits: P*L = 32768, k = 300, m = 600; K4's COSINE and IP
   epilogues; K4 in its query-major order at P = 8 and its cell-major
   order at P = 64, 256, 512, the order reported under "paths"), with
   CUDA-event times (K1 and K4 also ten calls back to back, `loop_ms`, a
   trace's `device_ms`, and `stream_ms`, the bytes their order streams at
   the memory rate), the least time the card could take
   (bound), and the one PyTorch call that computes the same function
   where there is one (library). K2 is bit-equal at every case: ties
   planted across its segment boundaries, a width that is no multiple of
   the segment, the short-row path at n = 2, 20, 40, 2048 up to k = n, the
   merge timed by its device time in a trace beside `torch.topk`'s; K3 on
   its tensor cores at d = 32, 128, 384, r = 1..4, with all-+inf rows, and
   the bf16 product alone (`gemm_ms`) beside it;
4. the main paths, each with the launch counts set to 0 just before it
   and read just after:
   - f32 headline: the bench's 1M x 128 `make_pool`, the FlatIndex oracle,
     `IvfIndex.add` (auto-train), a second traced build that must equal
     the first bit for bit, a recall@10 sweep over nprobe up to the 0.95
     gate, QPS at the gate on batches of 1024 held-out queries, then
     delete / `allowed` / append on the 1M index;
   - sq8 headline: `IvfIndex(sq8=True, rerank=40)` on the same pool and
     oracle: build, sweep to the gate, QPS;
   - compact store: `sq8=True, keep_f32=False, rerank=40`: memory, recall
     at the sq8 gate, QPS, 10,000 appends found by their own queries;
   - hard row: `hard_pool` 1M x 128 drawn after `make_pool` from the same
     generator (the bench's order), its own oracle, `sq8=True, rerank=40`,
     the sweep over nprobe 64-512 to the gate, QPS;
   - probe-only store (`sq8=True, keep_f32=False, rerank=0`) at 100k
     rows: a sweep, and an append that must raise;
   - HNSW (the bench's hnsw row): `HnswIndex.add` of the 1M make_pool (the
     bulk build) and a traced rebuild that must equal it, reachability from
     the entry, `pack_serving`, the serve sweep (ef, iters) to the 0.95
     gate, QPS at the gate, the recall@50 sweep against a k = 50 oracle,
     the pack_m=16 sub-row, `search` (the graph path) at ef 64, then
     delete / `allowed` on both searches;
   - HNSW inserts (`HnswTableIndex.insert` / `flush_pending`): a bulk graph
     of the first N - 65,536 rows, 256 single-row `add`s (p50 / p99 ms),
     then the last 65,280 rows in one `add` (waves of 512: seconds, rows/s,
     a traced insert of the same rows into a copy that must equal it);
     the index then holds the pool in slot order: recall@10 of `search` at
     ef 64, the inserted rows as their own queries, reachability, the serve
     sweep to the gate; then the SQ16 and SQ8 stores (recall, QPS, bytes)
     and an `add` into the SQ8 index;
   - HNSW waves from empty (cpu_hnsw_baseline's 65,536 rows, bench.py:498):
     build seconds and rows/s, recall@10 at ef 64 against its own oracle,
     reachability, then a quarter deleted and `vacuum` (the bulk route);
   - the mesh, IVF (`ShardedIvfIndex`, examples/vector_serving.py): the 1M
     pool on `make_mesh(n_db=4)` over four copies of the card, the f32
     store by the mesh build (`_train_mesh`) and the compact store by the
     shards' own builds, each swept to the gate with QPS; the merge's
     share of the search's device time; a 1-shard mesh against the plain
     index on 100k rows (equal ids and distances);
   - the mesh, HNSW (`ShardedHnswIndex`): 4 shards of 250k by the bulk
     route, the serving packs, the serve sweep to the gate and QPS, graph
     search at ef 64, one wave `add` of 4,096 rows found by their own query;
   - dense IVF (`dense_pack=True`): blocks against cells, the sweep and QPS
     at nblocks = nprobe and nblocks = nprobe / 2 (K10 inside K2's launch);
   - `sq8_search` over the pool's u8 codes (K11 and a K2 merge): recall;
   - the SQL database (`Database.create` on its default device, the
     card): the 1M pool bulk-loaded as docs(id, emb VECTOR(128), grp) with
     the WAL on; four exact queries without an index against the oracle;
     `CREATE INDEX ... USING IVF WITH (nprobe = 8)`, EXPLAIN's
     AnnIndexScan, 256 held-out statements (`ORDER BY emb <-> '[...]'
     LIMIT 10`) gated at recall@10 0.95 against the card's FlatIndex, p50 /
     p99 ms a statement, a `WHERE grp = 1` query, a DELETE; the same on
     `WITH (compact = true)`; `USING HNSW` (the bulk build): the graph
     path's answers equal to the top 10 by exact distance of
     `HnswIndex.search(k=40, ef=80)`, 256 INSERTs found by their own
     query, `PRAGMA ann_pack` and the serve path gated at 0.95; then
     checkpoint, close and `Database.open`: the .hnsw snapshot loads and
     the graph and serve answers equal those before the close;
5. checks that each path launched each of its kernels; then, outside the
   counted runs, traces the searches (device time per kernel, idle share),
   and holds K6, K7 and K8 against their plain versions on the built HNSW
   index at the path's shapes, and K9 (a wave of 512 at every level, a
   1024-query descent), K8-SQ (SQ8, SQ16) and K7's presorted mode (W = 100)
   on the inserted and wave-built indexes, K2 at the mesh merge's
   [1024, 40] and at the sq8 index's own cell-selection width, K10 (fused
   into K2) on the dense index's cells (bit-equal to `dense_blocks_plain`),
   K11 at B = 1024 over the 1M store (its ids apart and every one at a
   near-tie, its recall beside its plain version's, which the fp32 kernel
   before it equalled bit for bit); then the widths past the old limits,
   each in its kernel and against its plain version, with its bound and
   the library call: K2's wide form at k = 3000 (and with K10 fused;
   `torch.topk`), K11's distance mode at k = 100 and 2100 and its column
   slices at d = 384 (matmul, epilogue and `torch.topk`), the d = 6 and d = 130 IVF and HNSW stores (rows copied
   zero-padded for the kernels), a 10-level graph (two K9 launches); and
   the widths no kernel holds (IVF rerank 2,500, ef = 1500, K7 at W = 100
   and d = 512) raising on the card before any launch;
6. prints {"kernels": [...]}, the card, and, last, {"ok": true, "device": {...}}.

Any failure exits non-zero without the last line. The full report goes to
chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, N_QUERIES, DIM, K = 1_000_000, 16_384, 128, 10
N_ORACLE = 256
BATCH = 1024
PROBES = (2, 4, 5, 6, 8, 16, 32, 64)
HARD_PROBES = (64, 128, 192, 256, 384, 512)
RECALL_GATE = 0.95
RERANK = 4 * K               # the bench's sq8 rows: rerank=4*K
N_PROBE_ONLY = 100_000
N_APPEND = 10_000            # rows appended to the 1M f32 and compact indexes
# headline shapes of the kernels (C after the 1M split cascade, L = cap)
CELLS, LANES = 24_576, 256
K1_PROBE = 5                 # the gate's nprobe in the headline: kernel timings there
FLAT_CHUNK = 131_072
K3_ROWS, K3_CELLS = 1_000_000, 7_812   # 1M rows, n//128 cells (Lloyd's)
SQ8_CELLS, SQ8_LANES = 16_384, 128      # the sq8 store: n//64 cells of L = 128
SQ8_PROBE = 8                # the sq8 index's gate in the prediction: timings there
HARD_PROBE = 256             # the hard row's gate in the prediction
# Tolerances. K2, K4 and the epilogues round exactly as the plain version
# (K4's int32 dot is exact), so their values should be bit-equal; 1e-6
# relative leaves room for nothing else. K1, K3 and K5 sum the fp32 (or
# bf16-rounded) products in another order than cuBLAS: fp32 keeps that
# within 1e-5 of the distance scale, and ids may differ only inside that band.
K2_RTOL = 1e-6
DOT_RTOL = 1e-5
# K11's recall@10 against its plain version's (the fp32 kernel before it
# was bit-equal to the plain version): the tensor cores' sums may move a near-tie
K11_RECALL_TOL = 0.002
K3_AGREE = 0.995
# the HNSW insert and wave paths
N_INSERT = 65_536            # rows inserted into the bulk graph of N - N_INSERT
N_SINGLE = 256               # of them, one `add` each
N_WAVE = 65_536              # the wave path's index (bench.py:498, cpu_hnsw_baseline)
SQ_RECALL_TOL = 0.005        # the SQ16 store's recall against the f32 store's
SELF_HIT_GATE = 0.95         # rows that find themselves first among their own queries
# The inserted rows of the insert path: the reference's waves descend the
# upper levels greedily, which on a bulk graph sticks (why its search
# takes descent_ef 32), so their level-0 beam starts in the wrong region
# for half of them: 0.4985 found themselves (41.6 % of their edges among
# their 32 nearest) where a beam descent gives 0.9836 (87.6 %) (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md, PR 4). The gate holds that behaviour.
INSERT_SELF_HIT_GATE = 0.45
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s, fp32
# FMA pipes, bf16 and int8 tensor cores
HBM_BPS, FP32_OPS, BF16_OPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12

OUT = Path("chiprun_out")
REPORT: dict = {}


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def _median_ms(fn, reps=5):
    from turdb_tpu_torch.utils.timing import cuda_median_ms

    return cuda_median_ms(fn, reps=reps, warmup=1)


def _loop_ms(fn, n=10):
    """Milliseconds a call with n calls back to back between the events: the
    host's launch path (the wrapper's checks and allocations) then overlaps
    the device's work, which `_median_ms` of one call does not hide."""
    return _median_ms(lambda: [fn() for _ in range(n)], reps=3) / n


def _bound(nbytes, ops, peak=None):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the unit's peak. `ops` may
    instead be a list of (operations, peak) for work on several units."""
    work = [(ops, peak)] if peak is not None else ops
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, sum(o / pk for o, pk in work) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": float(nbytes), "bound_ops": float(sum(o for o, _ in work))}


def _probe_bound(cells, members, alive, allowed, lane_bytes, query_bytes, out_bytes, d, peak):
    """Bound of a probe (K1, K4) on this run's inputs: each probed cell is
    read once however many queries probe it (member id and flags of every
    lane, `lane_bytes` of row and metadata of every live lane), each query
    and cell list once, each output once; the ops are 2d per (query, live
    lane)."""
    b = cells.shape[0]
    uniq = torch.unique(cells).long()
    live = (members[uniq] >= 0) & alive[uniq]
    per_query = (members[cells.long()] >= 0) & alive[cells.long()]
    if allowed is not None:
        live &= allowed[uniq]
        per_query &= allowed[cells.long()]
    flag_bytes = 5 + (allowed is not None)
    nbytes = (uniq.numel() * members.shape[1] * flag_bytes + int(live.sum()) * lane_bytes
              + b * query_bytes + cells.numel() * 4 + b * out_bytes)
    return _bound(nbytes, 2 * d * int(per_query.sum()), peak)


def _stream_ms(route, cells, members, alive, allowed, row_bytes, meta_bytes, query_bytes,
               out_bytes):
    """Milliseconds at the memory rate for the bytes a probe's order
    streams when none of its reads hits a cache. Query-major ("query"):
    each query reads every probed lane's member and metadata (`meta_bytes`)
    and flags, and every live lane's row. Cell-major
    ("cell"): each probed cell once (its lanes' metadata, its rows up to
    the last live lane), each (query, probe) pair its query row, and the
    [B, P*L] distances written once and read once by the selection."""
    b, p = cells.shape
    lanes = members.shape[1]
    flags = 1 + (allowed is not None)

    def live_of(src):
        live = (members[src] >= 0) & alive[src]
        return live & allowed[src] if allowed is not None else live

    if route == "query":
        nbytes = (cells.numel() * lanes * (meta_bytes + flags)
                  + int(live_of(cells.long()).sum()) * row_bytes + b * query_bytes)
    else:
        uniq = torch.unique(cells).long()
        pos = torch.arange(1, lanes + 1, device=cells.device)
        extent = torch.where(live_of(uniq), pos, 0).amax(1)
        nbytes = (uniq.numel() * lanes * (meta_bytes + flags) + int(extent.sum()) * row_bytes
                  + cells.numel() * (query_bytes + 2 * 4 * lanes))
    return (nbytes + cells.numel() * 4 + b * out_bytes) / HBM_BPS * 1e3


def _device_parts(fn, calls=20):
    """Device ms of one call of fn and its share in each kernel, from a
    trace of `calls` calls (each kernel's time over the calls the trace
    kept of it: the profiler drops a few)."""
    prof = _traced(fn, calls, top=16)
    parts = {t["name"]: t["ms"] / t["calls"] for t in prof["top"]}
    return sum(parts.values()), parts


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _selection_error(vals_k, pos_k, vals_p, pos_p, vals_at_pos, rtol, what):
    """Kernel vs plain selection: same values (within rtol of the scale),
    the kernel's positions hold the values it reports, and positions differ
    only where the two values tie exactly. Returns (max abs error, share
    of positions that differ at a tie)."""
    fin = torch.isfinite(vals_p)
    check(torch.equal(fin, torch.isfinite(vals_k)), f"{what}: +inf entries differ")
    scale = float(vals_p[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((vals_k[fin] - vals_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= rtol * max(scale, 1.0), f"{what}: max abs err {err} (scale {scale})")
    at = vals_at_pos(pos_k)
    check(bool(((at == vals_k) | ~fin).all()), f"{what}: a position does not hold its value")
    diff = pos_k != pos_p
    check(bool((vals_k[diff] == vals_p[diff]).all()), f"{what}: ids differ away from a tie")
    return err, float(diff.float().mean())


def _near_equal(dk, ik, dp, ip, rtol, what):
    """Probe / rerank outputs: same +inf entries, distances within rtol of
    the distance scale, ids equal except inside that band. Returns the max
    abs error and the share of ids that differ."""
    fin = torch.isfinite(dp)
    check(torch.equal(fin, torch.isfinite(dk)), f"{what}: +inf entries differ")
    scale = max(float(dp[fin].abs().max()) if bool(fin.any()) else 1.0, 1.0)
    err = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err > rtol * scale and dk.dim() == 2:
        # the first row that parts, both versions, for the report
        over = ((dk - dp).abs() > rtol * scale) & fin
        bad = int(torch.nonzero(over)[0, 0])
        REPORT.setdefault("parted", {})[what] = {
            "row": bad, "rows_parted": int(over.any(1).sum()),
            "kernel": [dk[bad].tolist(), ik[bad].tolist()],
            "plain": [dp[bad].tolist(), ip[bad].tolist()]}
    check(err <= rtol * scale, f"{what}: max abs err {err}")
    close = (dk - dp).abs() <= rtol * scale
    check(bool(((ik == ip) | close | ~fin).all()), f"{what}: ids differ")
    return err, float(((ik != ip) & fin).float().mean())


def _plant_segment_ties(rows, n):
    """Exact ties across K2's segment boundaries: the first 64 entries of
    each segment of a width-n row copy the last 64 of the segment before
    (rows: a [n, ...] tensor whose entries make the columns)."""
    from turdb_tpu_torch.kernels import topk_segments

    w = -(-n // topk_segments(n))
    for s in range(w, n, w):
        rows[s:s + 64] = rows[s - 64:s]


def _traced(fn, calls, tries=3, **kw):
    """A device trace of `calls` calls of fn. The profiler on the H100 now
    and then keeps no device span of a trace of small calls at all: such a
    trace is taken again, up to `tries` times."""
    from turdb_tpu_torch.utils.timing import device_profile

    for _ in range(tries):
        prof = device_profile(lambda: [fn() for _ in range(calls)], **kw)
        if prof.get("traced"):
            return prof
        log(f"a trace of {calls} calls saw no device activity; tracing again")
    check(False, "the trace saw no device activity")


def _trace_ms(fn, kernel=None, calls=50):
    """Device ms of one call of fn, from a trace of `calls` calls: the
    time of the kernel whose name holds `kernel`, or (None) all of the
    call's device time. An event pair around one small call also holds
    the host's launch path."""
    prof = _traced(fn, calls)
    if kernel is None:
        return prof["busy_ms"] / calls
    kern = [t for t in prof["top"] if kernel in t["name"]]
    check(len(kern) == 1 and kern[0]["calls"] > 0,
          f"{kernel} did not show in its trace: {json.dumps(prof['top'])}")
    if kern[0]["calls"] != calls:
        log(f"the trace kept {kern[0]['calls']} of {calls} calls of {kernel}")
    return kern[0]["ms"] / kern[0]["calls"]


def _k2_timed(x, k, **kw):
    """K2's, its plain version's and `torch.topk`'s times on x, and K2's
    bound: x read once (and the epilogue's norms and mask), the k values and
    positions of each row written once; three operations an entry."""
    from turdb_tpu_torch.kernels import _row_values, topk_rows, topk_rows_plain

    # the library call selects on the distances the epilogue produces
    full = _row_values(x, kw.get("rown"), kw.get("coln"), kw.get("colvalid"),
                       kw.get("epilogue", 0), kw.get("clamp", False))
    b, n = x.shape
    extra = 4 * (b + n) * (kw.get("rown") is not None) + n * (kw.get("colvalid") is not None)
    return {"ms": _median_ms(lambda: topk_rows(x, k, **kw)),
            "plain_ms": _median_ms(lambda: topk_rows_plain(x, k, **kw)),
            "library_ms": _median_ms(lambda: torch.topk(full, k, largest=False)),
            **_bound(4 * b * n + extra + 8 * b * k, 3 * b * n, FP32_OPS)}


def k2_phase(dev, gen, cells=CELLS, flat_chunk=FLAT_CHUNK):
    from turdb_tpu_torch.kernels import EPI_L2, _row_values, topk_rows, topk_rows_plain

    def compare(x, k, what, **kw):
        vk, pk = topk_rows(x, k, **kw)
        vp, pp = topk_rows_plain(x, k, **kw)
        full = _row_values(x, kw.get("rown"), kw.get("coln"), kw.get("colvalid"),
                           kw.get("epilogue", 0), kw.get("clamp", False))
        check(torch.equal(vk, vp) and torch.equal(pk, pp), f"{what}: not bit-equal")
        return _selection_error(vk, pk, vp, pp, lambda p: torch.gather(full, 1, p.long()),
                                K2_RTOL, what)

    timed = _k2_timed

    out = {}
    # cell selection: [1024, C] dot matrix, top-nprobe with the unclamped
    # L2 epilogue, at every nprobe of the sweep
    q = torch.randn(BATCH, DIM, device=dev, generator=gen) * 4
    c = torch.randn(cells, DIM, device=dev, generator=gen) * 4
    # a few exact duplicate centroids plant exact ties, some of them across
    # K2's segment boundaries
    c[1::97] = c[0::97][: c[1::97].shape[0]]
    _plant_segment_ties(c, cells)
    qn, cn = (q * q).sum(1), (c * c).sum(1)
    dots = q @ c.T
    kw = dict(rown=qn, coln=cn, epilogue=EPI_L2)
    for p in PROBES:
        err, tie_frac = compare(dots, p, f"K2 cell select k={p}", **kw)
        if p in (K1_PROBE, PROBES[-1]):
            out[f"cell_select_k{p}"] = {"shape": [BATCH, cells], "k": p, "max_abs_err": err,
                                        "tie_id_diff": tie_frac, **timed(dots, p, **kw)}
    # a width that is no multiple of the segment (three uneven segments)
    odd = cells - 1000
    compare(dots[:, :odd].contiguous(), PROBES[-1], f"K2 width {odd}",
            rown=qn, coln=cn[:odd].contiguous(), epilogue=EPI_L2)
    # flat oracle chunk: [256, 131072], clamped L2 + valid mask, at the
    # oracle's k=10, at k=50 and at k=300 (past the old 256 limit)
    qf = q[:N_ORACLE].contiguous()
    xf = torch.randn(flat_chunk, DIM, device=dev, generator=gen) * 4
    valid = torch.rand(flat_chunk, device=dev, generator=gen) < 0.9
    _plant_segment_ties(xf, flat_chunk)
    _plant_segment_ties(valid, flat_chunk)
    dots = qf @ xf.T
    kw = dict(rown=(qf * qf).sum(1), coln=(xf * xf).sum(1), colvalid=valid,
              epilogue=EPI_L2, clamp=True)
    for kk in (K, 50, 300):
        err, _ = compare(dots, kk, f"K2 flat chunk k={kk}", **kw)
        out[f"flat_chunk_k{kk}"] = {"shape": [N_ORACLE, flat_chunk], "k": kk,
                                    "max_abs_err": err, **timed(dots, kk, **kw)}
    # the oracle's running merge: [256, 2k] -> k. Merging a buffer with
    # itself makes every value an exact tie of two positions.
    best, _ = topk_rows(dots, K, **kw)
    merged = torch.cat([best, best], dim=1)
    err, tie_frac = compare(merged, K, "K2 merge")
    out["merge"] = {"shape": [N_ORACLE, 2 * K], "k": K, "max_abs_err": err,
                    "tie_id_diff": tie_frac, **timed(merged, K),
                    "device_ms": _trace_ms(lambda: topk_rows(merged, K), "topk_short_kernel"),
                    "library_device_ms": _trace_ms(lambda: torch.topk(merged, K, largest=False))}
    # the short-row path at n = 2, 20, 40 and 2048, k = min(10, n) and k = n,
    # each row two copies of one half (exact ties)
    short = {}
    for n in (2, 20, 40, 2048):
        half = dots[:BATCH, : n // 2]
        x = torch.cat([half, half], 1).contiguous()
        for kk in sorted({min(K, n), n}):
            compare(x, kk, f"K2 short n={n} k={kk}")
        short[str(n)] = {"k": [min(K, n), n], "ms": _median_ms(lambda: topk_rows(x, n))}
    out["short"] = short
    return out


K1_PROBES = (K1_PROBE, 64, 128)


def synthetic_f32_store(dev, gen, cells=CELLS, lanes=LANES):
    """A synthetic packed store at the headline geometry: cells 40-100%
    full, ids drawn from 4096 values so that copies of an id meet in one
    probe (as replicas do), 1% tombstones, a 50% allowed mask; 1024 queries."""
    pvecs = torch.randn(cells, lanes, DIM, device=dev, generator=gen)
    occ = torch.randint(lanes * 2 // 5, lanes + 1, (cells, 1), device=dev, generator=gen)
    lane = torch.arange(lanes, device=dev)[None, :]
    members = torch.randint(0, 1 << 12, (cells, lanes), device=dev,
                            generator=gen, dtype=torch.int32)
    members = torch.where(lane < occ, members, -1).to(torch.int32)
    pnorms = torch.where(members >= 0, (pvecs * pvecs).sum(-1), float("inf"))
    alive = torch.rand(cells, lanes, device=dev, generator=gen) < 0.99
    allowed = torch.rand(cells, lanes, device=dev, generator=gen) < 0.5
    q = torch.randn(BATCH, DIM, device=dev, generator=gen)
    return {"pvecs": pvecs, "members": members, "pnorms": pnorms, "alive": alive,
            "allowed": allowed, "q": q, "qn": (q * q).sum(1)}


def k1_cases(st, p, top):
    """K1's (args, kwargs, what) at probe width p over the cells `top`:
    metrics 0 / 1 / 2 with and without replicas and `allowed`."""
    lanes = st["members"].shape[1]
    for metric in (0, 1, 2):
        for replicated, allow in ((True, None), (False, None), (True, st["allowed"])):
            m = min(2 * K, p * lanes) if replicated else K
            args = (st["q"], st["qn"], top, st["pvecs"], st["pnorms"], st["members"],
                    st["alive"], allow)
            yield (args, dict(metric=metric, k=K, m=m, replicated=replicated),
                   f"K1 P={p} metric={metric} replicated={replicated} allowed={allow is not None}")


def k1_phase(dev, gen, cells=CELLS, lanes=LANES):
    from turdb_tpu_torch.kernels import MODE_CAND, MODE_TOPK, ivf_probe_f32, ivf_probe_f32_plain

    st = synthetic_f32_store(dev, gen, cells, lanes)
    q, qn, pvecs, pnorms = st["q"], st["qn"], st["pvecs"], st["pnorms"]
    members, alive = st["members"], st["alive"]
    out = {}
    # the headline's nprobe 5; 64 (the sweep's end); 128 = 32,768 lanes,
    # chunked, past the one-block limit of PR 1
    for p in K1_PROBES:
        top = torch.rand(BATCH, cells, device=dev, generator=gen).topk(p).indices.to(torch.int32)
        for args, kw, what in k1_cases(st, p, top):
            metric, replicated, m, allow = kw["metric"], kw["replicated"], kw["m"], args[-1]
            err, id_diff = _near_equal(*ivf_probe_f32(*args, **kw),
                                       *ivf_probe_f32_plain(*args, **kw), DOT_RTOL, what)
            if metric == 0 and replicated and allow is None and p in (K1_PROBE, 128):
                def run():
                    return ivf_probe_f32(*args, **kw)

                dev_ms, _ = _device_parts(run)
                row = {"max_abs_err": err, "ms": _median_ms(run, reps=5 if p < 128 else 3),
                       "loop_ms": _loop_ms(run), "device_ms": dev_ms,
                       "stream_ms": _stream_ms("query", top, members, alive, None, 4 * DIM,
                                               8, 4 * DIM + 4, 8 * K),
                       **_probe_bound(top, members, alive, None, 4 * DIM + 4, 4 * DIM + 4,
                                      8 * K, DIM, FP32_OPS)}
                if p == K1_PROBE:
                    out.update(shape={"B": BATCH, "P": p, "L": lanes, "d": DIM, "C": cells},
                               k=K, m=m, id_diff=id_diff,
                               plain_ms=_median_ms(lambda: ivf_probe_f32_plain(*args, **kw)),
                               library_ms=None, **row)
                else:
                    out["wide"] = {"P": p, "lanes": p * lanes, **row}
        # candidate mode (the rerank of the f32 store) and k = 300 with
        # replicas (m = 600, past the old 256 limit)
        if p == K1_PROBE:
            for k, m, mode in ((RERANK, RERANK, MODE_CAND), (300, 600, MODE_TOPK)):
                args = (q, qn, top, pvecs, pnorms, members, alive, None)
                kw = dict(metric=0, k=k, m=m, replicated=True, mode=mode)
                got, want = ivf_probe_f32(*args, **kw), ivf_probe_f32_plain(*args, **kw)
                what = f"K1 P={p} k={k} m={m} mode={mode}"
                err, _ = _near_equal(got[0], got[1], want[0], want[1], DOT_RTOL, what)
                if mode == MODE_CAND:
                    close = (got[0] - want[0]).abs() <= DOT_RTOL * max(float(want[0].abs().max()), 1.0)
                    check(bool(((got[2] == want[2]) | close).all()), f"{what}: positions differ")
                out[f"k{k}_m{m}"] = {"max_abs_err": err}
    return out


def _gemm_ms(xb, cb, chunk=1 << 17):
    """The yardstick beside K3: a bf16 `torch.mm` of the same operands with
    fp32 output (the product alone, no argmin), over row chunks of x (the
    whole [n, C] matrix does not fit), as one timed call."""
    def run():
        for s in range(0, xb.shape[0], chunk):
            torch.mm(xb[s:s + chunk], cb.T, out_dtype=torch.float32)

    return _median_ms(run, reps=3)


def k3_phase(dev, gen, rows=K3_ROWS, cells=K3_CELLS, cells_r2=CELLS, small=(100_000, 4096)):
    from turdb_tpu_torch.kernels import kmeans_assign, kmeans_assign_plain

    def pool(n, d):
        centers = torch.randn(1024, d, device=dev, generator=gen) * 4
        pick = torch.randint(0, 1024, (n,), device=dev, generator=gen)
        x = centers[pick] + torch.randn(n, d, device=dev, generator=gen)
        return x, (x * x).sum(1)

    def agree(x, xn, n_cells, r, timed=True, inf_rows=None):
        n, d = x.shape
        cents = x[torch.randperm(n, device=dev, generator=gen)[:n_cells]].contiguous()
        cn = (cents * cents).sum(1)
        xb = x.bfloat16()          # rounded once, as a k-means run rounds its rows
        args = (xb, cents, xn, cn, r)
        ik, dk = kmeans_assign(*args)
        ip, dp = kmeans_assign_plain(*args)
        fin = torch.isfinite(dp)
        check(torch.equal(fin, torch.isfinite(dk)), f"K3 r={r} d={d}: +inf entries differ")
        same = (ik == ip).all(1)
        frac = float(same.float().mean())
        check(frac >= K3_AGREE, f"K3 r={r} C={n_cells} d={d}: agreement {frac}")
        # every disagreement is a near tie: the plain distance of the
        # kernel's pick is within tolerance of the plain best
        xf, cb = xb.float(), cents.bfloat16().float()
        at = (xn[:, None] + cn[ik.long()]) - 2.0 * torch.einsum(
            "nd,nrd->nr", xf, cb[ik.long()])
        tol = DOT_RTOL * (xn[:, None] + cn[ip.long()]).abs()
        check(bool((((at - dp).abs() <= tol) | ~fin).all()),
              f"K3 r={r} d={d}: a disagreement is no near tie")
        check(bool((((dk - dp).abs() <= tol) | ~fin).all()), f"K3 r={r} d={d}: distances differ")
        if inf_rows is not None:
            want = torch.arange(r, device=dev, dtype=torch.int32).expand(len(inf_rows), r)
            check(torch.equal(ik[inf_rows], want), f"K3 r={r} d={d}: an all-+inf row")
        del at, xf, cb
        both = same & fin.all(1)
        out = {"shape": {"n": n, "C": n_cells, "d": d, "r": r}, "agreement": frac,
               "max_abs_err": float((dk[both] - dp[both]).abs().max()) if bool(both.any())
               else 0.0}
        if timed:
            out.update(
                ms=_median_ms(lambda: kmeans_assign(*args)),
                plain_ms=_median_ms(lambda: kmeans_assign_plain(*args), reps=3),
                # no one PyTorch call gives the bf16-rounded argmin / top-R
                library_ms=None,
                **_bound(4 * (n * d + n_cells * d + n + n_cells) + 8 * n * r,
                         2 * n * n_cells * d, BF16_OPS))
            out["gemm_ms"] = _gemm_ms(xb, cents.bfloat16())
        return out

    # Lloyd's first pass (r=1, C = n//128) and the replica placement's top-2
    # over every row at the post-split cell count
    x, xn = pool(rows, DIM)
    out = agree(x, xn, cells, 1)
    out["top2"] = agree(x, xn, cells_r2, 2)
    del x, xn
    # the widths of the tests (32) and of the emb384 cell, r = 1..4, with a
    # few rows whose every distance is +inf (ids 0..r-1)
    n, c = small
    out["cases"] = []
    for d in (32, DIM, 384):
        x, xn = pool(n, d)
        inf_rows = torch.arange(0, n, n // 7, device=dev)
        xn[inf_rows] = float("inf")
        for r in (1, 2, 3, 4):
            case = agree(x, xn, c, r, timed=(r == 1), inf_rows=inf_rows)
            out["cases"].append(case)
        del x, xn
    return out


def synthetic_sq8_store(dev, gen, cells=SQ8_CELLS, lanes=SQ8_LANES):
    """A synthetic sq8 store at the ivf_sq8 geometry (C = 16,384, L = 128,
    d = 128): rows from randn, cells 50-100% full, 1% tombstones, a 50%
    allowed mask. Replica ties are planted: lanes 0-31 of each odd cell
    copy lanes 32-63 (id and row) of the even cell before it, and the
    probes below take cells in such pairs. Encoded as the build encodes
    (int8 codes, m′, scales, SQ16)."""
    from turdb_tpu_torch.ops.quantize import sq8_store, sq16_encode

    pvecs = torch.randn(cells, lanes, DIM, device=dev, generator=gen)
    members = torch.arange(cells * lanes, device=dev, dtype=torch.int32).reshape(cells, lanes)
    pvecs[1::2, :32] = pvecs[0::2, 32:64]
    members[1::2, :32] = members[0::2, 32:64]
    occ = torch.randint(lanes // 2, lanes + 1, (cells, 1), device=dev, generator=gen)
    members = torch.where(torch.arange(lanes, device=dev)[None, :] < occ, members, -1)
    pvecs[members < 0] = 0.0
    flat = pvecs.reshape(-1, DIM)
    codes, m_prime, scales, m8 = sq8_store(flat)
    u16 = sq16_encode(flat, m8, scales)
    shape2 = (cells, lanes)
    return {
        "pvecs": pvecs, "members": members.to(torch.int32),
        "pnorms": torch.where(members >= 0, (pvecs * pvecs).sum(-1), float("inf")),
        "alive": torch.rand(shape2, device=dev, generator=gen) < 0.99,
        "allowed": torch.rand(shape2, device=dev, generator=gen) < 0.5,
        "codes": codes.reshape(cells, lanes, DIM), "mins": m_prime.reshape(shape2),
        "scales": scales.reshape(shape2), "u16": u16.reshape(cells, lanes, DIM),
    }


def _paired_cells(dev, gen, p, cells, b):
    """p distinct cells per query, in (even, odd) pairs that share copies."""
    ev = torch.rand(b, cells // 2, device=dev, generator=gen).topk(p // 2).indices * 2
    return torch.stack([ev, ev + 1], dim=-1).reshape(b, p).to(torch.int32).contiguous()


def _queries_near(st, cells, dev, gen):
    """Each query next to a copied row of its first (even) cell, so the two
    copies are its nearest lanes and tie exactly."""
    lane = 32 + torch.randint(0, 32, (cells.shape[0],), device=dev, generator=gen)
    q = st["pvecs"][cells[:, 0].long(), lane]
    return (q + 0.05 * torch.randn(q.shape, device=dev, generator=gen)).contiguous()


K4_PROBES = (SQ8_PROBE, 64, HARD_PROBE, 512)


def k4_cases(st, p, cells, q):
    """K4's (args, kwargs, what) at probe width p over `cells` for the
    queries q: top-k with and without replicas and `allowed`, candidates
    (the rerank's); at P = SQ8_PROBE also the serving pack's COSINE and IP
    seeding (top 32 of all lanes, no replicas)."""
    from turdb_tpu_torch.kernels import MODE_CAND, MODE_TOPK
    from turdb_tpu_torch.ops.quantize import quantize_queries

    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cases = [(MODE_TOPK, K, 2 * K, True, None, 0), (MODE_TOPK, K, K, False, None, 0),
             (MODE_TOPK, K, 2 * K, True, st["allowed"], 0),
             (MODE_CAND, RERANK, RERANK, True, None, 0)]
    if p == SQ8_PROBE:
        cases += [(MODE_TOPK, 32, 32, False, None, metric) for metric in (1, 2)]
    for mode, k, m, replicated, allow, metric in cases:
        args = (qc, qs, qsum, qn, cells, st["codes"], st["mins"], st["scales"],
                st["pnorms"], st["members"], st["alive"], allow)
        yield (args, dict(k=k, m=m, replicated=replicated, mode=mode, metric=metric),
               f"K4 P={p} mode={mode} k={k} replicated={replicated} "
               f"allowed={allow is not None} metric={metric}")


def k4_phase(dev, gen, st):
    """K4 in top-k and candidate mode at the ivf_sq8 shapes (P = 8: one
    block a query; 64: the sweep's end) and the hard row's (P = 256, 512);
    past one chunk of lanes (P >= 64 here) it runs cell-major
    (`probe_route`, reported under "paths"). K4's distance is L2 under
    every metric (the reference's sq8 probe), so it has no metric to vary
    there; the serving pack's COSINE and IP epilogues are checked at P = 8.
    Values and ids must equal the plain version's exactly."""
    from turdb_tpu_torch.kernels import MODE_CAND, ivf_probe_sq8, ivf_probe_sq8_plain, probe_route

    lanes = st["members"].shape[1]
    out = {"paths": {str(p): probe_route(p, lanes, DIM) for p in K4_PROBES}}
    for p in K4_PROBES:
        cells = _paired_cells(dev, gen, p, st["members"].shape[0], BATCH)
        q = _queries_near(st, cells, dev, gen)
        for args, kw, what in k4_cases(st, p, cells, q):
            got = ivf_probe_sq8(*args, **kw)
            want = ivf_probe_sq8_plain(*args, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{what}: differs from plain")
            if kw["metric"]:
                out[f"metric{kw['metric']}"] = {"P": p, "k": kw["k"], "max_abs_err": 0.0}
            if kw["mode"] != MODE_CAND:
                continue
            # the copies tie at the top of the candidate list
            ties = (got[1][:, 0] == got[1][:, 1]) & (got[0][:, 0] == got[0][:, 1])
            check(bool(ties.any()), f"{what}: no planted replica tie reached the top")
            if p == SQ8_PROBE:
                out["cand"] = (q, args[3], cells, got)
            if p not in (SQ8_PROBE, HARD_PROBE):
                continue

            def run():
                return ivf_probe_sq8(*args, **kw)

            reps = 5 if p == SQ8_PROBE else 3
            dev_ms, parts = _device_parts(run)
            path = probe_route(p, lanes, DIM)
            out[f"cand_P{p}"] = {
                "shape": {"B": BATCH, "P": p, "L": lanes, "d": DIM, "C": st["members"].shape[0]},
                "r": RERANK, "path": path, "max_abs_err": 0.0,
                "replica_ties": float(ties.float().mean()),
                "ms": _median_ms(run, reps=reps), "loop_ms": _loop_ms(run),
                "device_ms": dev_ms, "device_parts": parts,
                "plain_ms": _median_ms(lambda: ivf_probe_sq8_plain(*args, **kw), reps=reps),
                "library_ms": None,
                "stream_ms": _stream_ms(path, cells, st["members"], st["alive"], None,
                                        DIM, 16, DIM + 12, 12 * RERANK),
                **_probe_bound(cells, st["members"], st["alive"], None, DIM + 12,
                               DIM + 12, 12 * RERANK, DIM, INT8_OPS)}
    return out


def k5_phase(st, cand):
    """K5 over the f32 and the SQ16 store, at r = 40 (the sq8 rows) and
    r = 300, on K4's candidates (which carry the planted replica ties),
    replicas on and off; timed at r = 40 as one call (`ms`), ten back to
    back (`loop_ms`) and a trace's device time (`device_ms`)."""
    from turdb_tpu_torch.kernels import (
        MODE_CAND, ivf_probe_sq8, ivf_rerank, ivf_rerank_plain)
    from turdb_tpu_torch.ops.quantize import quantize_queries

    q, qn, cells, (cd, ci, cpos) = cand
    out = {}
    for r in (RERANK, 300):
        if r != cd.shape[1]:
            qc, qs, qsum = quantize_queries(q)
            cd, ci, cpos = ivf_probe_sq8(qc, qs, qsum, qn, cells, st["codes"], st["mins"],
                                         st["scales"], st["pnorms"], st["members"],
                                         st["alive"], k=r, m=r, replicated=True,
                                         mode=MODE_CAND)
        for store, meta in (("f32", ()), ("sq16", (st["mins"], st["scales"]))):
            rows = st["pvecs"] if store == "f32" else st["u16"]
            for replicated in (True, False):
                args = (q, qn, cd, ci, cpos, rows, st["pnorms"], *meta)
                plain_args = (*args, *(None, None)[len(meta):])
                what = f"K5 r={r} store={store} replicated={replicated}"
                err, id_diff = _near_equal(*ivf_rerank(*args, k=K, replicated=replicated),
                                           *ivf_rerank_plain(*plain_args, K, replicated),
                                           DOT_RTOL, what)
                if r == RERANK and replicated:
                    def run():
                        return ivf_rerank(*args, k=K, replicated=True)

                    fin = torch.isfinite(cd)
                    pos = torch.unique(cpos[fin].long())
                    row_bytes = 4 * DIM if store == "f32" else 2 * DIM + 8
                    nbytes = (cd.numel() * 12 + pos.numel() * (row_bytes + 4)
                              + q.shape[0] * (4 * DIM + 4) + q.shape[0] * K * 8)
                    out[store] = {
                        "shape": {"B": q.shape[0], "r": r, "d": DIM}, "max_abs_err": err,
                        "id_diff": id_diff,
                        "ms": _median_ms(run), "loop_ms": _loop_ms(run),
                        "device_ms": _device_parts(run)[0],
                        "plain_ms": _median_ms(lambda: ivf_rerank_plain(*plain_args, K, True)),
                        "library_ms": None,
                        **_bound(nbytes, 2 * DIM * int(fin.sum()), FP32_OPS)}
    return out


# ---------------------------------------------------------------------------
# main paths
# ---------------------------------------------------------------------------

def _oracle(dev, x, queries):
    from turdb_tpu_torch.models.flat import FlatIndex

    t = time.perf_counter()
    flat = FlatIndex(dim=DIM, capacity=len(x), device=dev)
    flat.add(x)
    _, truth = flat.search(queries[:N_ORACLE], k=K)
    check(bool((truth >= 0).all()), "oracle returned empty slots")
    return truth, time.perf_counter() - t


def _state_gib(idx):
    return sum(t.numel() * t.element_size() for t in idx.state if t is not None) / 2**30


def build_phase(dev, x, **flags):
    from turdb_tpu_torch.models.ivf import IvfIndex

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = IvfIndex(dim=DIM, device=dev, **flags)
    idx.add(x)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t,
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "C": idx.cfg.n_clusters, "L": idx.cfg.cluster_cap,
           "replicated": idx.cfg.replicated, "state_gib": _state_gib(idx)}
    log(f"build {flags}: {out['build_s']:.3f} s  C={out['C']} L={out['L']}  "
        f"peak {out['build_peak_gib']:.3f} GiB, state {out['state_gib']:.3f} GiB")
    return out, idx


def sweep_phase(idx, queries, truth, probes, gate=True):
    from turdb_tpu_torch.utils.datasets import recall_of

    sweep, at = [], None
    for p in probes:
        _, ids = idx.search(queries[:N_ORACLE], K, nprobe=p)
        r = recall_of(ids, truth)
        sweep.append({"nprobe": p, "recall@10": r})
        log(f"  nprobe={p:3d} recall@10={r:.4f}")
        if r >= RECALL_GATE:
            at = p
            break
    if gate:
        check(at is not None, f"recall gate {RECALL_GATE} not reached by nprobe {probes[-1]}")
    return sweep, at


def qps_phase(idx, batches, nprobe, complete=True):
    """QPS at `nprobe` over the batches. Every answer must hold k rows,
    unless `complete` is False: then the share of empty slots is reported
    (ids -1 with +inf distances), and every other id must be in range."""
    d, i = idx.search(batches[0], K, nprobe=nprobe, out="torch")
    check(tuple(d.shape) == (BATCH, K) and tuple(i.shape) == (BATCH, K), "search shape")
    empty = (i < 0) & torch.isinf(d)
    ok = torch.isfinite(d) & (i >= 0) & (i < idx.size)
    check(bool((ok if complete else ok | empty).all()),
          "search returned non-finite distances or out-of-range ids")

    def run():
        for b in batches:
            idx.search(b, K, nprobe=nprobe, out="torch")

    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(run)
    out = {"search_ms_per_batch": ms / len(batches), "qps": len(batches) * BATCH / (ms / 1e3),
           "search_peak_gib": torch.cuda.max_memory_allocated() / 2**30, "batches": len(batches),
           "empty_slot_share": float(empty.float().mean())}
    log(f"search at nprobe={nprobe}: {out['qps']:.1f} QPS "
        f"({out['search_ms_per_batch']:.4f} ms / batch of {BATCH}), "
        f"peak {out['search_peak_gib']:.3f} GiB")
    return out


def _batches(queries, dev, n_batches=None):
    qd = torch.as_tensor(queries, device=dev)
    bs = [qd[s:s + BATCH] for s in range(0, len(qd) - BATCH + 1, BATCH)]
    return bs[:n_batches] if n_batches else bs


def headline_phase(dev, x, queries, truth):
    """The f32 headline: build, a traced rebuild equal bit for bit, the
    sweep to the gate, QPS at the gate."""
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.utils.timing import device_profile

    out, idx = build_phase(dev, x)
    # the same seed builds the same index: a second build, traced, must
    # equal the first bit for bit
    again = IvfIndex(dim=DIM, device=dev)
    out["build_profile"] = device_profile(lambda: again.add(x))
    same = again.cfg == idx.cfg and all(
        a is b is None or torch.equal(a, b) for a, b in zip(again.state, idx.state))
    out["rebuild_identical"] = same
    log(f"rebuild: C={again.cfg.n_clusters} identical={same}; "
        f"device profile {json.dumps(out['build_profile'])}")
    check(same, "a second build from the same seed differs from the first")
    del again
    torch.cuda.empty_cache()
    out["sweep"], out["gate_nprobe"] = sweep_phase(idx, queries, truth, PROBES)
    batches = _batches(queries, dev)
    out.update(qps_phase(idx, batches, out["gate_nprobe"]))
    return out, idx, batches


def append_check(idx, new, nprobe):
    slots = idx.add(new)
    _, ids = idx.search(new, K, nprobe=nprobe)
    found = float((ids == slots[:, None]).any(1).mean())
    check(found >= 0.999, f"only {found} of the appended rows found by their own query")
    return {"appended": len(slots), "append_found": found}


def maintenance_phase(idx, queries, gate, n):
    rng = np.random.default_rng(1)
    out = {}
    # delete: the top hits of 1000 held-out queries, topped up to 1000 slots
    _, ids0 = idx.search(queries[:1000], K, nprobe=gate)
    dele = np.unique(ids0[:, 0][ids0[:, 0] >= 0])
    extra = rng.choice(np.setdiff1d(np.arange(n), dele), 1000 - len(dele), replace=False)
    dele = np.concatenate([dele, extra])
    idx.delete(dele)
    _, ids1 = idx.search(queries[:1000], K, nprobe=gate)
    check(not np.isin(ids1, dele).any(), "a deleted slot came back")
    out["deleted"] = len(dele)

    allowed = rng.random(n) < 0.5
    _, ids2 = idx.search(queries[:N_ORACLE], K, nprobe=gate, allowed=allowed)
    got = ids2[ids2 >= 0]
    check(len(got) > 0, "allowed search returned nothing")
    check(bool(allowed[got].all()), "a slot outside the allowed mask came back")
    check(not np.isin(got, dele).any(), "a deleted slot came back under a mask")
    out["allowed_hits"] = int(len(got))

    out.update(append_check(idx, queries[-N_APPEND:], gate))
    log(f"maintenance: deleted {len(dele)} (none returned), allowed-only hits "
        f"{len(got)}, appended {out['appended']} found {out['append_found']}")
    return out


def sq8_phase(dev, x, queries, truth):
    """The bench's ivf_sq8 row: sq8 int8 probe + exact rerank over f32 rows."""
    out, idx = build_phase(dev, x, sq8=True, rerank=RERANK)
    out["sweep"], out["gate_nprobe"] = sweep_phase(idx, queries, truth, PROBES)
    batches = _batches(queries, dev)
    out.update(qps_phase(idx, batches, out["gate_nprobe"]))
    return out, idx, batches


def compact_phase(dev, x, queries, truth, gate, sq8_out):
    """The compact store at the sq8 index's gate: less memory, the same
    recall (within 0.005), and appends that keep the SQ16 encoding."""
    out, idx = build_phase(dev, x, sq8=True, keep_f32=False, rerank=RERANK)
    check(idx.state.pvecs.dtype == torch.int16, "the compact store is not SQ16")
    out["sweep"], _ = sweep_phase(idx, queries, truth, (gate,), gate=False)
    r, r_sq8 = out["sweep"][0]["recall@10"], sq8_out["sweep"][-1]["recall@10"]
    check(abs(r - r_sq8) <= 0.005, f"compact recall {r} vs sq8 {r_sq8} at nprobe {gate}")
    check(out["state_gib"] < sq8_out["state_gib"], "the compact store is not smaller")
    batches = _batches(queries, dev)
    out.update(qps_phase(idx, batches, gate))
    check(out["search_peak_gib"] < sq8_out["search_peak_gib"],
          "the compact store's search peak is not below the sq8 index's")
    out.update(append_check(idx, queries[-N_APPEND:], gate))
    log(f"compact: recall {r:.4f} (sq8 {r_sq8:.4f}), appended {out['appended']} "
        f"found {out['append_found']}")
    return out, idx, batches


def hard_phase(dev, rng, n, n_batches=4):
    """The bench's ivf_hard row: hard_pool drawn after make_pool from the
    same generator, its own oracle, sq8 + rerank, the wide sweep."""
    from turdb_tpu_torch.utils.datasets import hard_pool

    t = time.perf_counter()
    xh, qh = hard_pool(rng, n, DIM, n_queries=N_QUERIES)
    out = {"pool_s": time.perf_counter() - t}
    truth, out["oracle_s"] = _oracle(dev, xh, qh)
    b, idx = build_phase(dev, xh, sq8=True, rerank=RERANK)
    out.update(b)
    out["sweep"], out["gate_nprobe"] = sweep_phase(idx, qh, truth, HARD_PROBES)
    batches = _batches(qh, dev, n_batches)
    out.update(qps_phase(idx, batches, out["gate_nprobe"]))
    return out, idx, batches


def probe_only_phase(dev, x, queries, n):
    """The probe-only store (the HNSW bulk build's candidate generator):
    int8 codes and no row copy; it searches, and an append raises."""
    truth, _ = _oracle(dev, x[:n], queries)
    out, idx = build_phase(dev, x[:n], sq8=True, keep_f32=False, rerank=0)
    check(idx.state.pvecs.shape == (1, 1, 1), "the probe-only store keeps rows")
    out["sweep"], _ = sweep_phase(idx, queries, truth, (8, 32), gate=False)
    out.update(qps_phase(idx, _batches(queries, dev, 4), 8))
    try:
        idx.add(x[n:n + 2])
    except RuntimeError as e:
        out["append_refused"] = str(e)
    check("append_refused" in out, "an append to the probe-only store did not raise")
    return out


# ---------------------------------------------------------------------------
# the HNSW path (the bench's hnsw row) and its kernels on the built index
# ---------------------------------------------------------------------------

HNSW_SWEEP = ((32, 24), (48, 32), (64, 48), (96, 96))   # bench.py:377
HNSW_R50 = ((96, 96), (128, 128), (192, 160))            # bench.py:475
HNSW_GRAPH_EF = 64
K50 = 50
K6_WIDE = (192, 160)          # the widest point of the recall@50 sweep
K7_TARGETS = 16_384           # one selection chunk of the bulk build
N_DELETE = 1000
# reachable share of the nodes from the entry, over the union of the levels
# (the search's own route: a bulk graph's level 0 alone is one island per
# well-separated blob, in the reference as in the port). Neither package's
# bulk graph reaches 0.99 of make_pool: at 30k rows both reach 0.975833
# (the same graph), the port's at 1M 0.977265 (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md, PR 3)
REACH_GATE = 0.97


def _reachable(adjs, entry, n):
    """Fraction of the n nodes reachable from `entry` (BFS) over the edges
    of every adjacency array in `adjs` (host numpy)."""
    seen = np.zeros(n, bool)
    seen[entry] = True
    frontier = np.array([entry])
    while len(frontier):
        nxt = np.concatenate([a[frontier].ravel() for a in adjs])
        nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return float(seen.mean())


def _hnsw_index(dev):
    from turdb_tpu_torch.models.hnsw import HnswIndex

    # bench.py:363
    return HnswIndex(dim=DIM, ef_construction=100, build_batch=512, capacity=N, device=dev)


def _levels(st):
    return (st.adj0, *st.adj_hi)


class _Recorder:
    """Wraps a function for one run: CUDA events around each call and the
    shapes of its first argument (or the argument `arg`). The wrapped
    function is restored on exit."""

    def __init__(self, owner, name, arg=0):
        self.owner, self.name, self.arg = owner, name, arg
        self.calls = []

    def __enter__(self):
        fn = self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.calls.append((start, end, tuple(a[self.arg].shape)))
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e, _ in self.calls)


def ivf_build_parts(two_means, writes, iters=6):
    """Rows 6 and 7 of PERF.md's table, from the self-probe's temporary IVF
    build: `_two_means_batched` (pts [O, L, d] f32: read once, labels and
    centroid pairs written; 2OLd for the first distances, 4OLd per
    distance pass (iters + 1) and per update pass (iters), fp32) and the
    pack's `_write_rows` (rows [n, d] f32 read; int8 codes, m', scale and
    norm written with two int64 lane indices each), each beside its
    CUDA-event time."""
    b2 = o2 = 0
    for _, _, (o, lanes, d) in two_means.calls:
        b2 += 4 * o * lanes * d + o * lanes + 4 * o * lanes + 8 * o * d
        o2 += 2 * o * lanes * d * (1 + 2 * (iters + 1) + 2 * iters)
    bw = sum(n * (4 * d + d + 12 + 16) for _, _, (n, d) in writes.calls)
    return {"two_means": {"calls": len(two_means.calls), "ms": two_means.ms(),
                          **_bound(b2, o2, FP32_OPS)},
            "pack_writes": {"calls": len(writes.calls), "ms": writes.ms(),
                            "rows": sum(c[2][0] for c in writes.calls), **_bound(bw, 0, FP32_OPS)}}


def bulk_parts(merges, scatters, rcap=16):
    """Row 17 of PERF.md's table, from the HNSW bulk build: the union with
    the reverse quota (`_merge_reverse`: [n, deg] forward and [n, rcap]
    reverse ids read, [n, deg] written; the dedup's (deg + rcap)² compares
    a row, counted at the fp32 pipes' rate) and the row scatters
    (`_scatter_rows`: [n, deg] rows and n slots read, [n, deg] written),
    each beside its CUDA-event time."""
    bm = om = 0
    for _, _, (n, deg) in merges.calls:
        bm += 4 * n * (2 * deg + rcap)
        om += n * (deg + rcap) ** 2
    bs = sum(n * (8 * deg + 8) for _, _, (n, deg) in scatters.calls)
    return {"merge_reverse": {"calls": len(merges.calls), "ms": merges.ms(),
                              **_bound(bm, om, FP32_OPS)},
            "scatter_rows": {"calls": len(scatters.calls), "ms": scatters.ms(),
                             **_bound(bs, 0, FP32_OPS)}}


def hnsw_build_phase(dev, x):
    """The bulk build, a traced rebuild that must equal it, and the
    reachability from the entry point."""
    from turdb_tpu_torch.utils.timing import device_profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = _hnsw_index(dev)
    idx.add(x)
    torch.cuda.synchronize()
    st = idx.state
    lv = st.levels[:idx.size].cpu().numpy()
    out = {"build_s": time.perf_counter() - t,
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "max_level": st.max_level, "entry": st.entry, "descent_ef": idx._descent_ef,
           "level_sizes": [int((lv >= lvl).sum()) for lvl in range(st.max_level + 1)],
           "graph_gib": sum(a.numel() * a.element_size()
                            for a in (st.vectors, st.norms, st.levels, *_levels(st))) / 2**30}
    log(f"hnsw build: {out['build_s']:.3f} s, levels {out['level_sizes']}, "
        f"peak {out['build_peak_gib']:.3f} GiB")
    from turdb_tpu_torch.models import hnsw, ivf

    again = _hnsw_index(dev)
    t = time.perf_counter()
    with (_Recorder(ivf, "_two_means_batched") as two_means,
          _Recorder(ivf.IvfIndex, "_write_rows", arg=2) as writes,
          _Recorder(hnsw, "_merge_reverse") as merges,
          _Recorder(hnsw, "_scatter_rows", arg=2) as scatters):
        out["build_profile"] = device_profile(lambda: again.add(x), top=12)
    out["traced_build_s"] = time.perf_counter() - t
    out["ivf_build_parts"] = ivf_build_parts(two_means, writes)
    out["bulk_parts"] = bulk_parts(merges, scatters)
    log(f"hnsw temporary IVF build parts: {json.dumps(out['ivf_build_parts'])}; "
        f"bulk build parts: {json.dumps(out['bulk_parts'])}")
    same = again.state.entry == st.entry and all(
        torch.equal(a, b) for a, b in zip(_levels(again.state), _levels(st)))
    out["rebuild_identical"] = same
    log(f"hnsw rebuild identical={same}; device profile {json.dumps(out['build_profile'])}")
    check(same, "a second HNSW build of the same rows differs from the first")
    del again
    torch.cuda.empty_cache()
    adjs = [a[:idx.size].cpu().numpy() for a in _levels(st)]
    out["reach_levels"] = _reachable(adjs, st.entry, idx.size)
    out["reach_l0"] = _reachable(adjs[:1], st.entry, idx.size)
    log(f"hnsw reachability from the entry: over all levels {out['reach_levels']:.6f}, "
        f"over level 0 alone {out['reach_l0']:.6f}")
    check(out["reach_levels"] >= REACH_GATE,
          f"only {out['reach_levels']} of the graph is reachable from its entry")
    return out, idx


def _pack_bound(idx):
    """Row 18 of PERF.md's table: `pack_serving` as a whole. Its inputs
    read once (the rows, norms and level-0 lists of the index's nodes),
    every array of the pack written once but the rows and norms it shares
    with the graph; its k-means (K3's work: six assignment passes over the
    training rows, one over all rows) at the bf16 rate."""
    sv, n = idx.serve, idx.size
    c, (m0, d) = sv.centroids.shape[0], sv.nbr_codes.shape[1:]
    written = sum(a.numel() * a.element_size() for a in sv
                  if a is not sv.vectors and a is not sv.norms)
    n_train = min(n, max(c * 32, 65_536))
    return _bound(n * (4 * d + 4 + 4 * m0) + written, 2 * d * c * (6 * n_train + n), BF16_OPS)


def hnsw_pack_phase(idx, pack_m=None):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx.pack_serving(pack_m=pack_m)
    torch.cuda.synchronize()
    sv = idx.serve
    out = {"pack_s": time.perf_counter() - t,
           "pack_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           # as the bench's pack_gb: every array of the pack, the rows too
           "pack_gib": sum(a.numel() * a.element_size() for a in sv) / 2**30,
           "blocks_gib": sum(a.numel() * a.element_size()
                             for a in (sv.nbr_codes, sv.nbr_meta)) / 2**30,
           "C": sv.centroids.shape[0], "L": sv.cell_members.shape[1], "M0": sv.nbr_codes.shape[1],
           **_pack_bound(idx)}
    log(f"hnsw pack (pack_m={pack_m}): {out['pack_s']:.3f} s, {out['pack_gib']:.3f} GiB "
        f"(blocks {out['blocks_gib']:.3f}), C={out['C']} L={out['L']}, "
        f"peak {out['pack_peak_gib']:.3f} GiB")
    return out


def hnsw_sweep(search, queries, truth, points, k=K, gate=RECALL_GATE):
    from turdb_tpu_torch.utils.datasets import recall_of

    sweep, at = [], None
    for ef, iters in points:
        _, ids = search(queries[:N_ORACLE], k, ef=ef, iters=iters)
        r = recall_of(ids, truth)
        sweep.append({"ef": ef, "iters": iters, f"recall@{k}": r})
        log(f"  ef={ef:3d} iters={iters:3d} recall@{k}={r:.4f}")
        if r >= gate:
            at = (ef, iters)
            break
    return sweep, at


def hnsw_qps(fn, batches, n):
    d, i = fn(batches[0])
    check(tuple(d.shape) == (BATCH, K) and tuple(i.shape) == (BATCH, K), "hnsw search shape")
    check(bool(torch.isfinite(d).all()) and bool(((i >= 0) & (i < n)).all()),
          "hnsw search returned non-finite distances or out-of-range ids")
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(lambda: [fn(b) for b in batches])
    return {"search_ms_per_batch": ms / len(batches), "qps": len(batches) * BATCH / (ms / 1e3),
            "search_peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def hnsw_maintenance(idx, queries, gate):
    """Deletes of 1,000 rows (the first hits of 1,000 held-out queries,
    topped up at random) and a 50 % `allowed` mask: neither search may
    return a deleted or hidden row. Returns the deleted slots."""
    rng = np.random.default_rng(2)
    _, ids0 = idx.search_serve(queries[:1000], K, ef=gate[0], iters=gate[1])
    dele = np.unique(ids0[:, 0][ids0[:, 0] >= 0])
    extra = rng.choice(np.setdiff1d(np.arange(idx.size), dele), N_DELETE - len(dele),
                       replace=False)
    dele = np.concatenate([dele, extra])
    idx.delete(dele)
    allowed = rng.random(idx.size) < 0.5
    out = {"deleted": len(dele)}
    searches = (("serve", lambda q, **kw: idx.search_serve(q, K, ef=gate[0], iters=gate[1], **kw)),
                ("graph", lambda q, **kw: idx.search(q, K, ef=HNSW_GRAPH_EF, **kw)))
    for name, search in searches:
        _, ids = search(queries[:1000])
        check(not np.isin(ids, dele).any(), f"hnsw {name}: a deleted slot came back")
        _, ids = search(queries[:N_ORACLE], allowed=allowed)
        got = ids[ids >= 0]
        check(len(got) > 0, f"hnsw {name}: the allowed search returned nothing")
        check(bool(allowed[got].all()), f"hnsw {name}: a slot outside the allowed mask came back")
        check(not np.isin(got, dele).any(), f"hnsw {name}: a deleted slot came back under a mask")
        out[f"{name}_allowed_hits"] = int(len(got))
    log(f"hnsw maintenance: {json.dumps(out)}")
    return out, dele


def hnsw_phase(dev, x, queries, truth):
    """The bench's hnsw row (bench.py:353-467) end to end."""
    from turdb_tpu_torch.models.flat import FlatIndex
    from turdb_tpu_torch.utils.datasets import recall_of

    flat = FlatIndex(dim=DIM, capacity=len(x), device=dev)
    flat.add(x)
    _, truth50 = flat.search(queries[:N_ORACLE], k=K50)
    del flat
    out, idx = hnsw_build_phase(dev, x)
    out["pack"] = hnsw_pack_phase(idx)
    out["sweep"], gate = hnsw_sweep(idx.search_serve, queries, truth, HNSW_SWEEP)
    check(gate is not None, f"hnsw serve: recall gate {RECALL_GATE} not reached by ef 96")
    out["gate"] = {"ef": gate[0], "iters": gate[1]}
    batches = _batches(queries, dev)
    out["serve"] = hnsw_qps(
        lambda b: idx.search_serve(b, K, ef=gate[0], iters=gate[1], out="torch"), batches,
        idx.size)
    log(f"hnsw serve at ef={gate[0]}: {out['serve']['qps']:.1f} QPS "
        f"({out['serve']['search_ms_per_batch']:.4f} ms / batch)")
    # recall@50 (bench.py _recall50_hnsw): the gate, then up to 0.99
    r50 = []
    for ef, iters in (gate, *HNSW_R50):
        if ef < K50:
            ef, iters = 64, max(iters, 48)
        _, ids = idx.search_serve(queries[:N_ORACLE], K50, ef=ef, iters=iters)
        r50.append({"ef": ef, "iters": iters, "recall@50": recall_of(ids, truth50)})
        log(f"  recall@50 ef={ef}: {r50[-1]['recall@50']:.4f}")
        if r50[-1]["recall@50"] >= 0.99:
            break
    out["recall50"] = r50
    # the pack_m=16 sub-row (bench.py:425-460), then back to the full pack
    full = idx.serve
    m16 = hnsw_pack_phase(idx, pack_m=16)
    pts = (gate, (gate[0] + 16, gate[1] + 16), (gate[0] + 32, gate[1] + 32), (96, 96))
    m16["sweep"], g16 = hnsw_sweep(idx.search_serve, queries, truth, pts)
    if g16 is not None:
        m16["gate"] = {"ef": g16[0], "iters": g16[1]}
        m16.update(hnsw_qps(lambda b: idx.search_serve(b, K, ef=g16[0], iters=g16[1],
                                                       out="torch"), batches, idx.size))
    out["pack_m16"] = m16
    idx.serve = full
    torch.cuda.empty_cache()
    # the graph path at ef 64
    _, ids = idx.search(queries[:N_ORACLE], K, ef=HNSW_GRAPH_EF)
    out["graph"] = {"ef": HNSW_GRAPH_EF, "recall@10": recall_of(ids, truth),
                    **hnsw_qps(lambda b: idx.search(b, K, ef=HNSW_GRAPH_EF, out="torch"),
                               batches, idx.size)}
    log(f"hnsw graph search ef={HNSW_GRAPH_EF}: recall@10 {out['graph']['recall@10']:.4f}, "
        f"{out['graph']['qps']:.1f} QPS")
    out["maintenance"], dele = hnsw_maintenance(idx, queries, gate)
    return out, idx, batches, gate, dele


def k6_cases(idx, batch, gate):
    """K6's inputs on the 1M pack, B = 1024, at the gate and at K6_WIDE:
    [(ef, args, kwargs)], the seeds from the pack's own seeding (K4)."""
    from turdb_tpu_torch.models.hnsw_serve import serve_seeds
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    sv = idx.serve
    q = batch.float().contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    out = []
    for ef, iters in (gate, K6_WIDE):
        sd, si = serve_seeds(sv, q, qn, qc, qs, qsum, metric=Metric.L2, ef=ef, nprobe=2,
                             nseed=32)
        args = (sv.nbr_codes, sv.nbr_meta, sv.vectors, sv.norms, q, qn, qc, qs, qsum, si, sd,
                None)
        out.append((ef, args, dict(ef=ef, iters=iters, expand=4, rerank=0, k=K, metric=0)))
    return out


def k6_check(idx, batch, gate):
    """K6 on the 1M pack, B = 1024: the beam's expansions and scored
    neighbours equal the plain version's (exact int8 dots, the same
    rounding); the reranked distances within DOT_RTOL of their scale, ids
    equal but at ties inside that band. Timed as one call (`ms`), ten back
    to back (`loop_ms`) and a trace's device time (`device_ms`)."""
    from turdb_tpu_torch.kernels import hnsw_serve_beam, hnsw_serve_beam_plain, serve_beam_stage

    deg = idx.serve.nbr_codes.shape[1]
    out = {}
    for ef, args, kw in k6_cases(idx, batch, gate):
        q, si = args[4], args[9]
        iters = kw["iters"]
        dk, ik, sk = hnsw_serve_beam(*args, **kw)
        dp, ip, sp = hnsw_serve_beam_plain(*args, **kw)
        check(torch.equal(sk, sp), f"K6 ef={ef}: expansions differ from the plain version")
        err, id_diff = _near_equal(dk, ik, dp, ip, DOT_RTOL, f"K6 ef={ef}")
        tot = sk.long().sum(0)
        b = q.shape[0]
        nbytes = (int(tot[0]) * deg * 16 + int(tot[1]) * DIM + b * ef * (4 * DIM + 4)
                  + b * (5 * DIM + 12) + si.numel() * 8 + b * K * 8)
        out[f"ef{ef}"] = {
            "shape": {"B": b, "ef": ef, "iters": iters, "deg": deg, "d": DIM},
            "expanded": int(tot[0]), "scored": int(tot[1]), "max_abs_err": err,
            "id_diff": id_diff,
            # the stage rule's choice at this shape (a query of the library)
            "stage": dict(zip(("code_rows", "rerank_rows", "smem_bytes", "blocks_at_16",
                               "blocks_at_32"),
                              serve_beam_stage(b, si.shape[1], DIM, deg, ef=ef, iters=iters,
                                               expand=4, rerank=ef, device=q.device)))
            if q.is_cuda else None,
            "ms": _median_ms(lambda: hnsw_serve_beam(*args, **kw)),
            "loop_ms": _loop_ms(lambda: hnsw_serve_beam(*args, **kw)),
            "device_ms": _trace_ms(lambda: hnsw_serve_beam(*args, **kw), "serve_beam"),
            "plain_ms": _median_ms(lambda: hnsw_serve_beam_plain(*args, **kw), reps=3),
            # no PyTorch call runs a graph beam
            "library_ms": None,
            **_bound(nbytes, [(2 * DIM * int(tot[1]), INT8_OPS),
                              (2 * DIM * b * ef, FP32_OPS)])}
    return out


def k8_check(idx, batch):
    """K8 at the refinement shape (4096 level-1 nodes through level 1,
    deg 16, ef 32, with the expanded ids), the descent shape (B = 1024
    through level 1 from level 2's beam, deg 16, ef 32, expand 2) and the
    search shape (B = 1024 through level 0 from the upper levels' beams,
    deg 32, ef 64, with and without a 50 % `allowed` mask): distances
    within DOT_RTOL, ids apart only at ties, on <= 1 % of entries. Timed
    as `ms`, `loop_ms` and a trace's `device_ms`."""
    from turdb_tpu_torch.kernels import hnsw_graph_beam, hnsw_graph_beam_plain
    from turdb_tpu_torch.models.hnsw import _beam_level, _seed_from_entry
    from turdb_tpu_torch.ops.distance import Metric

    st = idx.state
    rows = torch.nonzero(st.levels[:idx.size] >= 1)[:4096, 0]
    q1, q1n = st.vectors[rows], st.norms[rows]
    s1, d1 = _seed_from_entry(st.vectors, st.norms, q1, q1n, st.entry, Metric.L2)
    qb = batch.float().contiguous()
    qbn = (qb * qb).sum(1)
    si, sd = _seed_from_entry(st.vectors, st.norms, qb, qbn, st.entry, Metric.L2)
    si, sd = si[:, None], sd[:, None]
    for lvl in range(len(st.adj_hi), 0, -1):
        if lvl == 1:
            d_si, d_sd = si, sd
        sd, si = _beam_level(st.adj_hi[lvl - 1], st.vectors, st.norms, qb, qbn, si, sd, 32, 64,
                             Metric.L2, expand=2)
    allowed = torch.rand(st.vectors.shape[0], device=qb.device) < 0.5
    cases = (("refine", st.adj_hi[0], q1, q1n, s1[:, None], d1[:, None],
              dict(ef=32, iters=48, return_expanded=True)),
             ("descent", st.adj_hi[0], qb, qbn, d_si, d_sd, dict(ef=32, iters=64, expand=2)),
             ("search", st.adj0, qb, qbn, si, sd, dict(ef=64, iters=96)),
             ("search_allowed", st.adj0, qb, qbn, si, sd,
              dict(ef=64, iters=96, allowed=allowed, k_res=16)))
    out = {}
    for name, adj, q, qn, s_i, s_d, kw in cases:
        args = (adj, st.vectors, st.norms, q, qn, s_i.contiguous(), s_d.contiguous())
        kw = {"metric": 0, "expand": 4, **kw}
        got = hnsw_graph_beam(*args, **kw)
        want = hnsw_graph_beam_plain(*args, **kw)
        err, id_diff = _near_equal(got.cand_d, got.cand_i, want.cand_d, want.cand_i, DOT_RTOL,
                                   f"K8 {name}")
        check(id_diff <= 0.01, f"K8 {name}: {id_diff} of the ids differ")
        if "allowed" in kw:
            _near_equal(got.res_d, got.res_i, want.res_d, want.res_i, DOT_RTOL, f"K8 {name} res")
            ri = got.res_i[got.res_i >= 0].long()
            check(bool(kw["allowed"][ri].all()), f"K8 {name}: a hidden node in the results")
        tot = got.stats.long().sum(0)
        b, s = s_i.shape
        deg = adj.shape[1]
        out_bytes = b * kw["ef"] * 8 + b * kw.get("k_res", 0) * 8 + b * 8
        nbytes = (int(tot[0]) * deg * 4 + int(tot[1]) * (4 * DIM + 4) + b * (4 * DIM + 4)
                  + b * s * 8 + out_bytes)
        out[name] = {
            "shape": {"B": b, "S": s, "ef": kw["ef"], "iters": kw["iters"],
                      "expand": kw["expand"], "deg": deg, "d": DIM},
            "expanded": int(tot[0]), "scored": int(tot[1]), "max_abs_err": err,
            "id_diff": id_diff,
            "ms": _median_ms(lambda: hnsw_graph_beam(*args, **kw)),
            "loop_ms": _loop_ms(lambda: hnsw_graph_beam(*args, **kw)),
            "device_ms": _trace_ms(lambda: hnsw_graph_beam(*args, **kw), "graph_beam"),
            "plain_ms": _median_ms(lambda: hnsw_graph_beam_plain(*args, **kw), reps=3),
            "library_ms": None,
            **_bound(nbytes, 2 * DIM * int(tot[1]), FP32_OPS)}
    return out


def _select_margins(vectors, t, cand, deg, alpha, cand_d=None):
    """Per row, the closest call the L2 diversity selection makes, in fp64
    from the rows: the smallest gap between two sorted candidate distances
    or between a distance and alpha times its distance to the nearest taken
    candidate. Two fp32 selections that sum in different orders can part
    only on a row whose margin is within their rounding. With `cand_d`
    (the presorted mode) the candidates keep their order and given
    distances, and only the scan's decisions count."""
    w = cand.shape[1]
    dev = cand.device
    inf = float("inf")
    x = vectors.double()
    cv = x[cand.clamp_min(0).long()]
    if cand_d is None:
        earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=dev), -1)
        dup = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, -1)
               | (cand == t[:, None]) | (cand < 0))
        d = torch.where(dup, inf, ((cv - x[t.long()][:, None]) ** 2).sum(-1))
        order = torch.argsort(d, dim=1, stable=True)
    else:
        d = torch.where(cand >= 0, cand_d.double(), inf)
        order = torch.arange(w, device=dev).expand(len(cand), w)
    d_s = torch.gather(d, 1, order)
    valid = torch.isfinite(d_s)
    gaps = torch.where(valid[:, 1:], (d_s[:, 1:] - d_s[:, :-1]).abs(), inf)
    vs = cv[torch.arange(len(cand), device=dev)[:, None], order]
    nrm = (vs * vs).sum(-1)
    pair = nrm[:, :, None] + nrm[:, None, :] - 2.0 * vs @ vs.transpose(1, 2)
    min_sel = torch.full(d_s.shape, inf, dtype=torch.float64, device=dev)
    count = torch.zeros(len(cand), dtype=torch.int64, device=dev)
    margin = gaps.min(1).values if cand_d is None else torch.full((len(cand),), inf,
                                                                     dtype=torch.float64,
                                                                     device=dev)
    for j in range(w):
        live = valid[:, j] & (count < deg)
        bound = alpha * min_sel[:, j]
        near = torch.where(live & torch.isfinite(bound), (d_s[:, j] - bound).abs(), inf)
        margin = torch.minimum(margin, near)
        take = live & (d_s[:, j] < bound)
        min_sel = torch.where(take[:, None], torch.minimum(min_sel, pair[:, :, j]), min_sel)
        count += take.long()
    return margin


def k7_check(idx, gen):
    """K7 on 16,384-target chunks of the built graph: W = 64 at level 0
    (a node's 32 edges and its nearest edge's 32: duplicates and the
    target itself occur, as in the self-probe's lists) and W = 128 at level
    1 (its 16 edges and those of 7 of its neighbours), alpha 1.2. Rows
    equal to the plain version's on >= 98 %, and every row that differs in
    its ids or its n_pairs has a decision within 4x the two versions'
    largest distance error of a tie (fp64 margins): the two sum their fp32
    dots in different orders."""
    from turdb_tpu_torch.kernels import hnsw_select, hnsw_select_plain

    st = idx.state
    dev = st.vectors.device

    def hops(adj, t, n):
        first = adj[t.long()]
        parts = [first] + [torch.where(first[:, j, None] >= 0, adj[first[:, j].clamp_min(0).long()],
                                       -1) for j in range(n)]
        return torch.cat(parts, 1).to(torch.int32).contiguous()

    l0 = torch.randperm(idx.size, device=dev, generator=gen)[:K7_TARGETS]
    l1 = torch.nonzero(st.levels[:idx.size] >= 1)[:, 0]
    l1 = l1[torch.randperm(len(l1), device=dev, generator=gen)[:K7_TARGETS]]
    out = {}
    for name, t, cand, deg in (("W64", l0, hops(st.adj0, l0, 1), 32),
                               ("W128", l1, hops(st.adj_hi[0], l1, 7), 16)):
        t = t.to(torch.int32).contiguous()
        kw = dict(deg=deg, metric=0, alpha=1.2)
        ki, kd, kp = hnsw_select(st.vectors, st.norms, t, cand, **kw)
        pi, pd, pp = hnsw_select_plain(st.vectors, st.norms, t, cand, **kw)
        same = (ki == pi).all(1)
        frac = float(same.float().mean())
        check(frac >= 0.98, f"K7 {name}: only {frac} of the rows equal the plain version's")
        # n_pairs follows the takes: an equal row may still take another
        # candidate and backfill it in the same place, at a tie
        pairs_equal = float((kp[same] == pp[same]).float().mean())
        fin = torch.isfinite(pd[same])
        err = float((kd[same][fin] - pd[same][fin]).abs().max()) if bool(fin.any()) else 0.0
        # a row (its ids or its n_pairs) may part only where the fp64
        # selection comes within a few times the two versions' own fp32
        # disagreement of a tie
        rows = torch.nonzero(~(same & (kp == pp)))[:, 0]
        margins = _select_margins(st.vectors, t[rows], cand[rows], deg, 1.2)
        tol = 4.0 * max(err, 2e-7 * float(st.norms[:idx.size].max()))
        check(bool((margins <= tol).all()),
              f"K7 {name}: a row differs with no decision within {tol} of a tie "
              f"(margins {margins.tolist()[:8]})")
        # the work: distinct valid candidates (their distance and their
        # sum of squares) and the pair columns the scan took
        w = cand.shape[1]
        earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=dev), -1)
        dup = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, -1)
               | (cand == t[:, None]) | (cand < 0))
        n_valid = int((~dup).sum())
        n_rows = int(torch.unique(torch.cat([t, cand[~dup]])).numel())
        u = t.numel()
        nbytes = n_rows * (4 * DIM + 4) + u * 4 + cand.numel() * 4 + u * deg * 8 + u * 4
        out[name] = {
            "shape": {"U": u, "W": w, "deg": deg, "d": DIM, "alpha": 1.2},
            "rows_equal": frac, "pairs_equal": pairs_equal, "max_abs_err": err,
            "pairs": int(kp.sum()),
            "tie_tol": tol, "max_margin_of_differing": float(margins.max()) if len(rows) else 0.0,
            "ms": _median_ms(lambda: hnsw_select(st.vectors, st.norms, t, cand, **kw)),
            "loop_ms": _loop_ms(lambda: hnsw_select(st.vectors, st.norms, t, cand, **kw)),
            "plain_ms": _median_ms(lambda: hnsw_select_plain(st.vectors, st.norms, t, cand, **kw),
                                   reps=3),
            # no PyTorch call runs the sequential diversity scan
            "library_ms": None,
            **_bound(nbytes, 2 * DIM * (2 * n_valid + int(kp.sum())), FP32_OPS)}
    return out


# ---------------------------------------------------------------------------
# the HNSW insert paths (waves, single rows, the SQ store, vacuum) and
# their kernels on the built indexes
# ---------------------------------------------------------------------------

def _clone_index(idx):
    """An index over a copy of `idx`'s graph (the tensors cloned)."""
    import copy

    c = copy.copy(idx)
    st = idx.state
    c.state = st._replace(vectors=st.vectors.clone(), norms=st.norms.clone(),
                          adj0=st.adj0.clone(), adj_hi=tuple(a.clone() for a in st.adj_hi),
                          levels=st.levels.clone())
    c._alive = idx._alive.copy()
    return c


def _same_graph(a, b):
    sa, sb = a.state, b.state
    return (sa.entry, sa.max_level) == (sb.entry, sb.max_level) and all(
        torch.equal(u, v) for u, v in zip((sa.vectors, sa.norms, sa.levels, *_levels(sa)),
                                          (sb.vectors, sb.norms, sb.levels, *_levels(sb))))


def _synced(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _self_hits(idx, rows, slots, ef=HNSW_GRAPH_EF, chunk=16_384):
    """Share of `rows` whose own slot comes first in a k = 1 search."""
    hits = 0
    for s in range(0, len(rows), chunk):
        _, ids = idx.search(rows[s:s + chunk], 1, ef=ef)
        hits += int((ids[:, 0] == slots[s:s + chunk]).sum())
    return hits / len(rows)


def _reach(idx):
    st = idx.state
    return _reachable([a[:idx.size].cpu().numpy() for a in _levels(st)], st.entry, idx.size)


def hnsw_insert_phase(dev, x, queries, truth):
    """The insert path users take, at full width: the bulk build of the
    first N - N_INSERT rows, N_SINGLE single-row inserts (the SQL INSERT),
    the rest in one `add` (flush_pending: waves of 512), then the checks on
    the index, which holds `x` in slot order, and the SQ stores."""
    from turdb_tpu_torch.utils.datasets import recall_of
    from turdb_tpu_torch.utils.timing import device_profile

    n0 = len(x) - N_INSERT
    idx = _hnsw_index(dev)
    _, bulk_s = _synced(lambda: idx.add(x[:n0]))
    out = {"bulk_rows": n0, "bulk_s": bulk_s}
    ms = []
    for i in range(n0, n0 + N_SINGLE):
        slot, dt = _synced(lambda: idx.add(x[i:i + 1]))
        check(int(slot[0]) == i, f"a single-row insert took slot {slot[0]}, not {i}")
        ms.append(dt * 1e3)
    out["single"] = {"rows": N_SINGLE, "p50_ms": float(np.percentile(ms, 50)),
                     "p99_ms": float(np.percentile(ms, 99)), "mean_ms": float(np.mean(ms)),
                     "max_ms": float(np.max(ms))}
    log(f"hnsw single-row inserts: {json.dumps(out['single'])}")
    rest = x[n0 + N_SINGLE:]
    again = _clone_index(idx)
    _, dt = _synced(lambda: idx.add(rest))
    out["waves"] = {"rows": len(rest), "waves": -(-len(rest) // idx.build_batch), "s": dt,
                    "rows_per_s": len(rest) / dt}
    # the same rows into a copy of the graph, traced: it must build the
    # same graph (the waves are deterministic)
    out["waves"]["profile"] = device_profile(lambda: again.add(rest), top=12)
    out["waves"]["traced_identical"] = _same_graph(idx, again)
    log(f"hnsw wave inserts: {json.dumps(out['waves'])}")
    check(out["waves"]["traced_identical"], "a traced insert of the same rows built another graph")
    del again
    check(idx.size == len(x), f"the index holds {idx.size} rows, not {len(x)}")
    out["descent_ef"] = idx._descent_ef
    _, ids = idx.search(queries[:N_ORACLE], K, ef=HNSW_GRAPH_EF)
    out["graph_recall"] = recall_of(ids, truth)
    out["inserted_self_hit"] = _self_hits(idx, x[n0:], np.arange(n0, len(x)))
    out["reach_levels"] = _reach(idx)
    log(f"hnsw after inserts: recall@10 {out['graph_recall']:.4f} at ef {HNSW_GRAPH_EF}, "
        f"inserted rows self-hit {out['inserted_self_hit']:.4f}, "
        f"reachability {out['reach_levels']:.6f}")
    check(out["inserted_self_hit"] >= INSERT_SELF_HIT_GATE,
          f"only {out['inserted_self_hit']} of the inserted rows find themselves")
    check(out["reach_levels"] >= REACH_GATE,
          f"only {out['reach_levels']} of the graph is reachable from its entry")
    out["pack"] = hnsw_pack_phase(idx)
    out["sweep"], gate = hnsw_sweep(idx.search_serve, queries, truth, HNSW_SWEEP)
    check(gate is not None, f"hnsw insert serve: recall gate {RECALL_GATE} not reached by ef 96")
    out["gate"] = {"ef": gate[0], "iters": gate[1]}
    idx.serve = None
    torch.cuda.empty_cache()
    # the SQ stores, each from the exact f32 rows
    f32 = idx.state.vectors
    batches = _batches(queries, dev, 16)

    def graph(b):
        return idx.search(b, K, ef=HNSW_GRAPH_EF, out="torch")

    out["f32"] = {"recall@10": out["graph_recall"], "store_gib": f32.numel() * 4 / 2**30,
                  **hnsw_qps(graph, batches, idx.size)}
    for bits in (16, 8):
        idx.state = idx.state._replace(vectors=f32)
        (idx.quantize_sq16 if bits == 16 else idx.quantize_sq8)()
        _, ids = idx.search(queries[:N_ORACLE], K, ef=HNSW_GRAPH_EF)
        out[f"sq{bits}"] = {"recall@10": recall_of(ids, truth),
                            "store_gib": idx.state.vectors.nbytes / 2**30,
                            **hnsw_qps(graph, batches, idx.size)}
        log(f"hnsw SQ{bits} store: {json.dumps(out[f'sq{bits}'])} (f32 {json.dumps(out['f32'])})")
    r16 = out["sq16"]["recall@10"]
    check(abs(r16 - out["graph_recall"]) <= SQ_RECALL_TOL,
          f"SQ16 recall {r16} is not within {SQ_RECALL_TOL} of f32's {out['graph_recall']}")
    # an add of 256 held-out rows into the SQ8 index: the store turns f32
    # again (the SQ8 rows dequantized), and the rows find themselves as
    # often as the inserted rows above
    sq8, n = idx.state.vectors, idx.size
    new = queries[-256:]
    slots = idx.add(new)
    out["sq8_add"] = {"rows": len(new), "store_f32": isinstance(idx.state.vectors, torch.Tensor),
                      "dequantized_rows_equal": bool(torch.equal(idx.state.vectors[:n],
                                                                 sq8.dense()[:n])),
                      "self_hit": _self_hits(idx, new, slots)}
    log(f"hnsw add into the SQ8 store: {json.dumps(out['sq8_add'])}")
    check(out["sq8_add"]["store_f32"] and out["sq8_add"]["dequantized_rows_equal"]
          and out["sq8_add"]["self_hit"] >= INSERT_SELF_HIT_GATE,
          f"an add into the SQ8 index: {out['sq8_add']}")
    del sq8
    # back to the exact rows (the added rows are exact in both)
    at = torch.as_tensor(slots.astype(np.int64), device=dev)
    f32[at] = idx.state.vectors[at]
    idx.state = idx.state._replace(vectors=f32)
    return out, idx


def hnsw_wave_phase(dev, x, queries):
    """The insert algorithm from an empty index at cpu_hnsw_baseline's size
    (bench.py:498-525): every row through the waves, its recall and
    reachability; then a quarter of the rows deleted (the SQL vacuum's
    min_dead_frac) and `vacuum`, whose survivors take the bulk route, on a
    copy. Returns the wave-built index."""
    from turdb_tpu_torch import kernels
    from turdb_tpu_torch.models.hnsw import _BULK_MIN, HnswIndex, select_levels
    from turdb_tpu_torch.utils.datasets import recall_of

    xs = x[:N_WAVE]
    truth, _ = _oracle(dev, xs, queries)
    idx = HnswIndex(dim=DIM, ef_construction=100, build_batch=512, capacity=N_WAVE,
                    bulk_threshold=N_WAVE + 1, device=dev)
    # the waves that descend: all but the first (the empty graph's), each
    # with a row below the top level; K9 walks all their levels in one launch
    levels, descents, off = select_levels(np.arange(N_WAVE, dtype=np.uint64), idx.cfg), 0, 0
    while off < N_WAVE:
        w = min(idx.build_batch, N_WAVE - off, max(1, off))
        descents += off > 0 and bool((levels[off:off + w] < idx.cfg.max_levels - 1).any())
        off += w
    before = kernels.launches["hnsw_greedy"]
    _, dt = _synced(lambda: idx.add(xs))
    out = {"rows": N_WAVE, "build_s": dt, "rows_per_s": N_WAVE / dt,
           "descent_ef": idx._descent_ef, "max_level": idx.state.max_level,
           "k9_launches": {"waves_descending": descents,
                           "add": kernels.launches["hnsw_greedy"] - before}}
    before = kernels.launches["hnsw_greedy"]
    _, ids = idx.search(queries[:N_ORACLE], K, ef=HNSW_GRAPH_EF)
    out["k9_launches"]["search"] = kernels.launches["hnsw_greedy"] - before
    check(out["k9_launches"] == {"waves_descending": descents, "add": descents, "search": 1},
          f"K9 launches: {out['k9_launches']}, not one a descending wave and one a search")
    out["recall@10"] = recall_of(ids, truth)
    out["reach_levels"] = _reach(idx)
    log(f"hnsw waves from empty: {json.dumps(out)}")
    check(out["recall@10"] >= RECALL_GATE,
          f"the wave-built graph's recall {out['recall@10']} is under {RECALL_GATE} at ef 64")
    check(out["reach_levels"] >= REACH_GATE,
          f"only {out['reach_levels']} of the wave-built graph is reachable")
    # the copy to vacuum keeps the default bulk_threshold (8,192) that the
    # build above was held over to force the waves
    vac = _clone_index(idx)
    vac.bulk_threshold = _BULK_MIN
    dead = np.sort(np.random.default_rng(3).choice(N_WAVE, N_WAVE // 4, replace=False))
    vac.delete(dead)
    mapping, dt = _synced(vac.vacuum)
    alive = np.setdiff1d(np.arange(N_WAVE), dead)
    check(bool((mapping[dead] == -1).all()) and np.array_equal(mapping[alive],
                                                               np.arange(len(alive))),
          "vacuum's old-slot -> new-slot mapping is wrong")
    check(len(vac) == len(alive) and vac._descent_ef == 32,
          "vacuum did not rebuild the survivors by the bulk route")
    probe = alive[np.random.default_rng(4).choice(len(alive), 4096, replace=False)]
    hit = _self_hits(vac, xs[probe], mapping[probe])
    d, _ = vac.search(xs[dead[:4096]], 1, ef=HNSW_GRAPH_EF)
    out["vacuum"] = {"deleted": len(dead), "survivors": len(alive), "s": dt,
                     "survivor_self_hit": hit, "deleted_min_dist": float(d[:, 0].min())}
    log(f"hnsw vacuum: {json.dumps(out['vacuum'])}")
    check(hit >= SELF_HIT_GATE, f"only {hit} of the survivors find themselves after vacuum")
    check(out["vacuum"]["deleted_min_dist"] > 0, "a deleted row came back after vacuum")
    return out, idx


def _greedy_bound(stats, b, deg, row_bytes, d):
    """K9's bound on this run's inputs: per query, each list it read (deg
    ids) and each neighbour it scored (its row and norm); the query, its
    norm and start read once, the end written once; 2d ops a score."""
    tot = stats.long().sum(0)
    nbytes = int(tot[0]) * deg * 4 + int(tot[1]) * (row_bytes + 4) + b * (4 * d + 12) + b * 8
    return _bound(nbytes, 2 * d * int(tot[1]), FP32_OPS)


def _k9_case(adjs, st, q, qn, cur_i, cur_d, what, lowest=None, timed=False):
    """K9 through `adjs` (one launch) against the plain chain of one-level
    walks: ends within DOT_RTOL, ids apart only at ties; timed, with its
    device time, the longest chain of steps any query took and the device
    time a step of it, and the one-level launches of the same walk."""
    from turdb_tpu_torch.kernels import hnsw_greedy, hnsw_greedy_plain

    args = (adjs, st.vectors, st.norms, q, qn, cur_i.contiguous(), cur_d.contiguous())
    ki, kd, ks = hnsw_greedy(*args, metric=0, lowest=lowest)
    pi, pd, ps = hnsw_greedy_plain(*args, metric=0, lowest=lowest)
    err, id_diff = _near_equal(kd[:, None], ki[:, None], pd[:, None], pi[:, None], DOT_RTOL, what)
    check(id_diff <= 0.01, f"{what}: {id_diff} of the ends differ")
    out = {"B": q.shape[0], "levels": len(adjs), "deg": adjs[0].shape[1], "max_abs_err": err,
           "id_diff": id_diff, "steps": int(ks[:, 0].sum()), "scored": int(ks[:, 1].sum()),
           "longest_chain": int(ks[:, 0].max()),
           "stats_equal": float((ks == ps).all(1).float().mean())}
    if timed:
        def fused():
            return hnsw_greedy(*args, metric=0, lowest=lowest)

        def per_level():
            # one launch a level, each from where the last ended (the calls
            # before one launch walked several levels)
            ci, cd = args[5], args[6]
            for adj in adjs:
                ci, cd, _ = hnsw_greedy(adj, *args[1:5], ci, cd, metric=0)

        out.update(ms=_median_ms(fused), loop_ms=_loop_ms(fused),
                   device_ms=_trace_ms(fused, "greedy_kernel"),
                   levels_ms=_median_ms(per_level),
                   plain_ms=_median_ms(lambda: hnsw_greedy_plain(*args, metric=0,
                                                                 lowest=lowest), reps=3),
                   library_ms=None,
                   **_greedy_bound(ks, q.shape[0], adjs[0].shape[1], 4 * DIM, q.shape[1]))
        out["step_ms"] = out["device_ms"] / out["longest_chain"]
    return out


def k9_check(ins, wave, wave_q, batch):
    """K9 against its plain chain: a wave of 512 held-out rows through
    levels 3-1 of the inserted 1M graph from its entry in one launch (the
    timed row), the same wave with each row stopping above its own level
    (the waves' descent), level 0 alone from there (which the waves skip),
    and the 1024-query search descent of the wave-built graph (descent_ef
    1, levels 3-1, one launch)."""
    from turdb_tpu_torch.kernels import hnsw_greedy
    from turdb_tpu_torch.models.hnsw import _seed_from_entry, select_levels
    from turdb_tpu_torch.ops.distance import Metric

    out = {}
    for name, idx, q in (("wave512", ins, wave_q), ("descent1024", wave, batch.float())):
        st = idx.state
        q = q.contiguous()
        qn = (q * q).sum(1)
        cur_i, cur_d = _seed_from_entry(st.vectors, st.norms, q, qn, st.entry, Metric.L2)
        adjs = [st.adj_hi[lvl - 1] for lvl in range(st.max_level, 0, -1)]
        out[name] = _k9_case(adjs, st, q, qn, cur_i, cur_d, f"K9 {name}", timed=True)
        if name == "wave512":
            slots = np.arange(idx.size, idx.size + len(q), dtype=np.uint64)
            lowest = torch.as_tensor(select_levels(slots, idx.cfg), device=q.device)
            out["wave512_own_levels"] = _k9_case(adjs, st, q, qn, cur_i, cur_d,
                                                 "K9 wave512 own levels", lowest=lowest)
            end_i, end_d, _ = hnsw_greedy(adjs, st.vectors, st.norms, q, qn, cur_i, cur_d,
                                          metric=0)
            out["wave512_level0"] = _k9_case([st.adj0], st, q, qn, end_i, end_d,
                                             "K9 wave512 level 0")
    return out


def k8sq_check(idx, batch):
    """K8 over the SQ8 and SQ16 stores of the inserted 1M graph at the
    search shape (B = 1024 through level 0 from the upper levels' beams,
    ef 64): distances within DOT_RTOL, ids apart only at ties."""
    from turdb_tpu_torch.kernels import (
        graph_beam_sq_stage,
        hnsw_graph_beam,
        hnsw_graph_beam_plain,
    )
    from turdb_tpu_torch.models.hnsw import _beam_level, _seed_from_entry
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import sq_rows_encode

    st = idx.state
    qb = batch.float().contiguous()
    qbn = (qb * qb).sum(1)
    out = {}
    for bits in (8, 16):
        rows = sq_rows_encode(st.vectors, bits)
        si, sd = _seed_from_entry(rows, st.norms, qb, qbn, st.entry, Metric.L2)
        si, sd = si[:, None], sd[:, None]
        for lvl in range(len(st.adj_hi), 0, -1):
            sd, si = _beam_level(st.adj_hi[lvl - 1], rows, st.norms, qb, qbn, si, sd, 32, 64,
                                 Metric.L2, expand=2)
        args = (st.adj0, rows, st.norms, qb, qbn, si.contiguous(), sd.contiguous())
        kw = dict(ef=64, iters=96, metric=0, expand=4)
        got = hnsw_graph_beam(*args, **kw)
        want = hnsw_graph_beam_plain(*args, **kw)
        err, id_diff = _near_equal(got.cand_d, got.cand_i, want.cand_d, want.cand_i, DOT_RTOL,
                                   f"K8-SQ{bits}")
        check(id_diff <= 0.01, f"K8-SQ{bits}: {id_diff} of the ids differ")
        tot = got.stats.long().sum(0)
        b, s = si.shape
        deg = st.adj0.shape[1]
        nbytes = (int(tot[0]) * deg * 4 + int(tot[1]) * (DIM * bits // 8 + 12)
                  + b * (4 * DIM + 4) + b * s * 8 + b * 64 * 8 + b * 8)
        rows_a_warp, fit16, fit32 = graph_beam_sq_stage(b, s, DIM, deg, ef=64, iters=96,
                                                        expand=4, k_res=0, bits=bits,
                                                        device=qb.device)
        out[f"sq{bits}"] = {
            "shape": {"B": b, "S": s, "ef": 64, "iters": 96, "deg": deg, "d": DIM},
            "stage": {"rows": rows_a_warp, "blocks_per_sm_16": fit16, "blocks_per_sm_32": fit32},
            "expanded": int(tot[0]), "scored": int(tot[1]), "max_abs_err": err,
            "id_diff": id_diff,
            "ms": _median_ms(lambda: hnsw_graph_beam(*args, **kw)),
            "loop_ms": _loop_ms(lambda: hnsw_graph_beam(*args, **kw)),
            "device_ms": _trace_ms(lambda: hnsw_graph_beam(*args, **kw), "graph_beam_sq_kernel"),
            "plain_ms": _median_ms(lambda: hnsw_graph_beam_plain(*args, **kw), reps=3),
            "library_ms": None,
            **_bound(nbytes, 2 * DIM * int(tot[1]), FP32_OPS)}
        del rows
    return out


def k7_sorted_check(idx, q):
    """K7's presorted mode at the waves' level-0 shape: the ef 100 beam
    buffers (W = 100) of 512 held-out rows through level 0 of the inserted
    1M graph, deg 32, alpha 1. Rows equal to the plain version's
    on >= 98 %, and every row that differs in its ids or its n_pairs has
    a decision within 4x the fp32 disagreement of a tie (fp64 margins)."""
    from turdb_tpu_torch.kernels import hnsw_select_sorted, hnsw_select_sorted_plain
    from turdb_tpu_torch.models.hnsw import _beam_level, _seed_from_entry
    from turdb_tpu_torch.ops.distance import Metric

    st = idx.state
    q = q.float().contiguous()
    qn = (q * q).sum(1)
    si, sd = _seed_from_entry(st.vectors, st.norms, q, qn, st.entry, Metric.L2)
    cand_d, cand_i = _beam_level(st.adj0, st.vectors, st.norms, q, qn, si, sd, 100, 150,
                                 Metric.L2)
    kw = dict(deg=32, metric=0, alpha=1.0)
    ki, kd, kp = hnsw_select_sorted(st.vectors, cand_i, cand_d, **kw)
    pi, pd, pp = hnsw_select_sorted_plain(st.vectors, cand_i, cand_d, **kw)
    same = (ki == pi).all(1)
    frac = float(same.float().mean())
    check(frac >= 0.98, f"K7 presorted: only {frac} of the rows equal the plain version's")
    check(torch.equal(kd[same], pd[same]), "K7 presorted: the distances of equal rows differ")
    pairs_equal = float((kp[same] == pp[same]).float().mean())
    rows = torch.nonzero(~(same & (kp == pp)))[:, 0]
    margins = _select_margins(st.vectors, None, cand_i[rows], 32, 1.0, cand_d=cand_d[rows])
    tol = 4.0 * 2e-7 * float(st.norms[:idx.size].max())
    check(bool((margins <= tol).all()),
          f"K7 presorted: a row differs with no decision within {tol} of a tie")
    valid = cand_i >= 0
    u, w = cand_i.shape
    n_rows = int(torch.unique(cand_i[valid]).numel())
    nbytes = n_rows * 4 * DIM + u * w * 8 + u * 32 * 8 + u * 4
    return {"shape": {"U": u, "W": w, "deg": 32, "d": DIM, "alpha": 1.0}, "rows_equal": frac,
            "pairs_equal": pairs_equal,
            "max_abs_err": 0.0, "pairs": int(kp.sum()), "tie_tol": tol,
            "max_margin_of_differing": float(margins.max()) if len(rows) else 0.0,
            "ms": _median_ms(lambda: hnsw_select_sorted(st.vectors, cand_i, cand_d, **kw)),
            "loop_ms": _loop_ms(lambda: hnsw_select_sorted(st.vectors, cand_i, cand_d, **kw)),
            "plain_ms": _median_ms(lambda: hnsw_select_sorted_plain(st.vectors, cand_i, cand_d,
                                                                    **kw), reps=3),
            "library_ms": None,
            **_bound(nbytes, 2 * DIM * (int(valid.sum()) + int(kp.sum())), FP32_OPS)}

# ---------------------------------------------------------------------------
# the mesh (parallel/), the dense IVF store and sq8_search
# ---------------------------------------------------------------------------

N_MESH_SHARDS = 4
N_ONE_SHARD = 100_000         # rows of the 1-shard mesh held against the plain index
N_MESH_WAVE = 4_096           # rows of the wave `add` into the 4-shard bulk graph
MESH_QPS_BATCHES = 16
SQ8_SEARCH_GATE = 0.5         # a sanity floor on sq8_search's recall (reported, not a target)


def _mesh(n_db, dev):
    from turdb_tpu_torch.parallel import make_mesh

    return make_mesh(n_db=n_db, devices=[dev] * n_db)


def _gid_rows(gids):
    """gid -> row lookup: (sorted gids, their rows)."""
    o = np.argsort(gids, kind="stable")
    return gids[o], o


def _rows_of(lut, gi):
    sg, rows = lut
    pos = np.clip(np.searchsorted(sg, gi), 0, len(sg) - 1)
    return np.where((gi >= 0) & (sg[pos] == gi), rows[pos], -1)


def _mesh_batches(queries, n=MESH_QPS_BATCHES):
    return [queries[s:s + BATCH] for s in range(0, n * BATCH, BATCH)]


def _mesh_qps(search, batches, size):
    d, gi = search(batches[0])
    check(d.shape == (BATCH, K) and bool(np.isfinite(d).all()) and bool((gi >= 0).all()),
          "mesh search returned non-finite distances or empty ids")
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(lambda: [search(b) for b in batches])
    return {"search_ms_per_batch": ms / len(batches), "qps": len(batches) * BATCH / (ms / 1e3),
            "search_peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _staged_mesh_build(idx, x):
    """The mesh build (`ShardedIvfIndex._train_mesh`) at full size. As in
    the reference, `IvfIndex.add` trains a shard as soon as its rows
    suffice, so the mesh build runs where shards were filled untrained;
    here the rows are routed by `add` with the shards' training held
    back, then `train()` builds every shard through the mesh path."""
    from turdb_tpu_torch.models.ivf import IvfIndex

    real = IvfIndex.train
    IvfIndex.train = lambda self, *a, **kw: None
    try:
        gids = idx.add(x)
    finally:
        IvfIndex.train = real
    check(all(s.state is None for s in idx.shards), "a shard trained while staged")
    idx.train()     # every shard untrained: the mesh build
    return gids


def _mesh_ivf_store(idx, x, queries, truth, staged):
    from turdb_tpu_torch.utils.datasets import recall_of

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if staged:
        gids = _staged_mesh_build(idx, x)
    else:
        gids = idx.add(x)
        idx.train()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    out = {"build_s": build_s, "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "C": idx._cfg.n_clusters, "L": idx._cfg.cluster_cap,
           "shard_sizes": [s.size for s in idx.shards],
           "state_gib": sum(_state_gib(s) for s in idx.shards)}
    log(f"mesh ivf build (staged={staged}): {build_s:.3f} s, C={out['C']} L={out['L']}, "
        f"state {out['state_gib']:.3f} GiB")
    lut = _gid_rows(gids)
    sweep, gate = [], None
    for p in PROBES:
        _, gi = idx.search(queries[:N_ORACLE], K, nprobe=p)
        r = recall_of(_rows_of(lut, gi), truth)
        sweep.append({"nprobe": p, "recall@10": r})
        log(f"  mesh nprobe={p:3d} recall@10={r:.4f}")
        if r >= RECALL_GATE:
            gate = p
            break
    check(gate is not None, f"mesh ivf: recall gate {RECALL_GATE} not reached by nprobe 64")
    out["sweep"], out["gate_nprobe"] = sweep, gate
    out.update(_mesh_qps(lambda b: idx.search(b, K, nprobe=gate), _mesh_batches(queries),
                         len(idx)))
    log(f"mesh ivf search at nprobe={gate}: {out['qps']:.1f} QPS")
    return out


def _merge_share(idx, batches, nprobe):
    """The merge's share of the mesh search's device time: the busy time
    of a trace of `_two_level_merge` over the shards' lists of the same
    batches, over the busy time of a trace of the whole searches."""
    from turdb_tpu_torch.models.ivf import ivf_search_impl
    from turdb_tpu_torch.parallel.sharded import _two_level_merge, pack_gids
    from turdb_tpu_torch.utils.timing import device_profile

    search = device_profile(lambda: [idx.search(b, K, nprobe=nprobe) for b in batches])
    lists = []
    for b in batches:
        qd = torch.as_tensor(b, device=idx.devices[0])
        parts = [ivf_search_impl(s.state, qd, None, cfg=idx._cfg, k=K, nprobe=nprobe)
                 for s in idx.shards]
        lists.append(([d for d, _ in parts],
                      [pack_gids(d, i, s, idx.id_stride) for s, (d, i) in enumerate(parts)]))
    merge = device_profile(lambda: [_two_level_merge(ds, gis, K, 1, idx.devices[0])
                                    for ds, gis in lists])
    out = {"search_profile": search, "merge_profile": merge}
    if search.get("traced") and merge.get("traced"):
        out["merge_share"] = merge["busy_ms"] / search["busy_ms"]
    return out, lists[0]


def mesh_ivf_phase(dev, x, queries, truth):
    """`ShardedIvfIndex` on a 4-shard mesh of one card: the f32 store built
    by the mesh build, the compact store by the shards' own builds; the
    sweep, QPS at the gate, the merge's share; then a 1-shard mesh against
    the plain index on the same rows."""
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.parallel import ShardedIvfIndex

    mesh = _mesh(N_MESH_SHARDS, dev)
    out = {}
    idx = ShardedIvfIndex(dim=DIM, mesh=mesh)
    out["f32"] = _mesh_ivf_store(idx, x, queries, truth, staged=True)
    out["f32"]["merge"], merge_case = _merge_share(idx, _mesh_batches(queries, 4),
                                                   out["f32"]["gate_nprobe"])
    log(f"mesh merge share of the search's device time: "
        f"{out['f32']['merge'].get('merge_share')}")
    del idx
    torch.cuda.empty_cache()
    idx = ShardedIvfIndex(dim=DIM, mesh=mesh, sq8=True, keep_f32=False, rerank=RERANK)
    out["compact"] = _mesh_ivf_store(idx, x, queries, truth, staged=False)
    check(all(s.state.pvecs.dtype == torch.int16 for s in idx.shards), "mesh compact: not SQ16")
    del idx
    torch.cuda.empty_cache()
    one = ShardedIvfIndex(dim=DIM, mesh=_mesh(1, dev))
    gids = one.add(x[:N_ONE_SHARD])
    plain = IvfIndex(dim=DIM, device=dev)
    plain.add(x[:N_ONE_SHARD])
    d1, g1 = one.search(queries[:N_ORACLE], K, nprobe=8)
    dp, ip = plain.search(queries[:N_ORACLE], K, nprobe=8)
    same = bool(np.array_equal(gids, np.arange(N_ONE_SHARD)) and np.array_equal(g1, ip)
                and np.array_equal(d1, dp))
    out["one_shard_equals_plain"] = same
    log(f"1-shard mesh ids and distances equal to the plain index: {same}")
    check(same, "a 1-shard mesh answers differently from the plain index")
    out["data_axis"] = _data_axis_check(dev, x[:N_ONE_SHARD], queries[:BATCH])
    return out, merge_case


def _data_axis_check(dev, x, queries):
    """A (data 2, db 2) mesh of the card (each data row serves half of the
    batch) against a (data 1, db 2) mesh over the same shards: the share of
    equal ids and the largest distance difference (the cell selection's
    cuBLAS product may sum in another order at another batch size)."""
    from turdb_tpu_torch.parallel import ShardedIvfIndex, make_mesh

    two = ShardedIvfIndex(dim=DIM, mesh=make_mesh(n_db=2, n_data=2, devices=[dev] * 4))
    two.add(x)
    two.train()
    one = ShardedIvfIndex(dim=DIM, mesh=make_mesh(n_db=2, devices=[dev] * 2))
    one.shards, one._cfg = two.shards, two._cfg
    d2, g2 = two.search(queries, K, nprobe=8)
    d1, g1 = one.search(queries, K, nprobe=8)
    out = {"same_ids": float((g2 == g1).mean()), "max_abs_err": float(np.abs(d2 - d1).max())}
    log(f"(data 2, db 2) against (data 1, db 2): {json.dumps(out)}")
    check(out["same_ids"] >= 0.999, f"the data axis changed the answers: {out}")
    return out


def mesh_hnsw_phase(dev, x, queries, truth):
    """`ShardedHnswIndex` on a 4-shard mesh of one card: the bulk route per
    shard, the serving packs, the serve sweep and QPS at its gate, graph
    search at ef 64, then one wave `add` of new rows."""
    from turdb_tpu_torch.parallel import ShardedHnswIndex
    from turdb_tpu_torch.utils.datasets import recall_of

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = ShardedHnswIndex(dim=DIM, mesh=_mesh(N_MESH_SHARDS, dev), ef_construction=100,
                           build_batch=512)
    gids = idx.add(x)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t, "descent_ef": idx._descent_ef,
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "shard_sizes": idx.sizes.tolist()}
    check(idx._descent_ef == 32, "the mesh HNSW load did not take the bulk route")
    log(f"mesh hnsw bulk build: {out['build_s']:.3f} s, shards {out['shard_sizes']}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx.pack_serving()
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t
    out["pack_gib"] = sum(a.numel() * a.element_size() for sv in idx._serve for a in sv) / 2**30
    log(f"mesh hnsw packs: {out['pack_s']:.3f} s, {out['pack_gib']:.3f} GiB")
    lut = _gid_rows(gids)

    def serve(q, k, ef, iters):
        d, gi = idx.search_serve(q, k, ef=ef, iters=iters)
        return d, _rows_of(lut, gi)

    out["sweep"], gate = hnsw_sweep(serve, queries, truth, HNSW_SWEEP)
    check(gate is not None, f"mesh hnsw serve: recall gate {RECALL_GATE} not reached by ef 96")
    out["gate"] = {"ef": gate[0], "iters": gate[1]}
    batches = _mesh_batches(queries)
    out["serve"] = _mesh_qps(lambda b: idx.search_serve(b, K, ef=gate[0], iters=gate[1]),
                             batches, len(idx))
    log(f"mesh hnsw serve at ef={gate[0]}: {out['serve']['qps']:.1f} QPS")
    _, gi = idx.search(queries[:N_ORACLE], K, ef=HNSW_GRAPH_EF)
    out["graph"] = {"ef": HNSW_GRAPH_EF, "recall@10": recall_of(_rows_of(lut, gi), truth),
                    **_mesh_qps(lambda b: idx.search(b, K, ef=HNSW_GRAPH_EF), batches[:4],
                                len(idx))}
    log(f"mesh hnsw graph ef={HNSW_GRAPH_EF}: recall@10 {out['graph']['recall@10']:.4f}, "
        f"{out['graph']['qps']:.1f} QPS")
    new = queries[-N_MESH_WAVE:]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ng = idx.add(new)
    torch.cuda.synchronize()
    out["wave_add_s"] = time.perf_counter() - t
    check(idx._serve is None, "a mesh add kept a stale serving pack")
    hits = 0
    for s in range(0, len(new), BATCH):
        _, gi = idx.search(new[s:s + BATCH], 1, ef=HNSW_GRAPH_EF)
        hits += int((gi[:, 0] == ng[s:s + BATCH]).sum())
    out["wave_self_hit"] = hits / len(new)
    log(f"mesh hnsw wave add of {len(new)}: {out['wave_add_s']:.3f} s, "
        f"found first by their own query {out['wave_self_hit']:.4f}")
    check(out["wave_self_hit"] >= INSERT_SELF_HIT_GATE,
          f"only {out['wave_self_hit']} of the rows added to the mesh find themselves")
    return out


DENSE_SPLIT = 2               # nblocks = nprobe // DENSE_SPLIT in the compacted sweep


def dense_ivf_phase(dev, x, queries, truth):
    """`IvfIndex(dense_pack=True)` on the 1M pool: blocks against cells,
    the sweep and QPS at nblocks = nprobe and at nblocks = nprobe / 2."""
    out, idx = build_phase(dev, x, dense_pack=True)
    check(idx.cfg.dense and idx.state.cell_block is not None, "the dense store has no map")
    out["blocks"] = int(idx.state.members.shape[0])
    log(f"dense: {out['blocks']} blocks for {out['C']} cells")
    batches = _batches(queries, dev)
    for name, split in (("nblocks_eq_nprobe", 1), ("nblocks_half", DENSE_SPLIT)):
        sweep, gate = [], None
        for p in PROBES:
            idx.nblocks = max(1, p // split)
            r = sweep_phase(idx, queries, truth, (p,), gate=False)[0][0]["recall@10"]
            sweep.append({"nprobe": p, "nblocks": idx.nblocks, "recall@10": r})
            if r >= RECALL_GATE:
                gate = p
                break
        check(gate is not None, f"dense {name}: recall gate not reached by nprobe 64")
        # a row with fewer than nblocks distinct blocks repeats some (the
        # reference's `_first_unique`); a repeated block's rows then fill the
        # pre-dedup window twice over and some answers come back short
        out[name] = {"sweep": sweep, "gate_nprobe": gate, "nblocks": idx.nblocks,
                     **qps_phase(idx, batches, gate, complete=split == 1)}
    return out, idx, batches


def k10_check(idx, batch, nprobe):
    """K10, fused into K2, on the dense index's own cell selection (the
    queries' top-nprobe cells) at u = nprobe / 2: the blocks bit-equal to
    `dense_blocks_plain` of K2's own cells, and at u = P the gather. Its
    row is its own share of the fused launch: `ms` and `device_ms` the
    fused launch's device time less K2's alone (K2's kernel in traces of
    each, A B B A), against K10's
    own bound (the cells read, their map entries gathered, the blocks
    written) and its plain version alone on K2's cells; the fused launch's
    times and bound stay as `fused_*` fields."""
    from turdb_tpu_torch.kernels import EPI_L2, dense_blocks_plain, topk_rows, topk_rows_plain

    st = idx.state
    q = batch.float().contiguous()
    dots = q @ st.centroids.T
    kw = dict(rown=(q * q).sum(1), coln=st.cnorms, epilogue=EPI_L2)
    u = max(1, nprobe // DENSE_SPLIT)
    _, top, got = topk_rows(dots, nprobe, cell_block=st.cell_block, u=u, **kw)
    check(torch.equal(top, topk_rows_plain(dots, nprobe, **kw)[1]), "K2 with K10 fused: cells")
    want = dense_blocks_plain(st.cell_block, top, u)
    check(torch.equal(got, want), "K10 (fused) differs from dense_blocks_plain")
    _, _, full = topk_rows(dots, nprobe, cell_block=st.cell_block, u=nprobe, **kw)
    check(torch.equal(full, st.cell_block[top.long()]), "K10 at u = P is not the gather")
    b, c = dots.shape

    def fused():
        return topk_rows(dots, nprobe, cell_block=st.cell_block, u=u, **kw)

    def k2_alone():
        return topk_rows(dots, nprobe, **kw)

    # K2's kernel span in each trace (per call it kept: the profiler drops
    # spans), fused and alone in turns A B B A
    t = [_trace_ms(f, "topk_") for f in (fused, k2_alone, k2_alone, fused)]
    fused_dev, k2_dev = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    # the fused launch: the dot matrix, its norms and the cell map read
    # once, the cells' values, ids and blocks written once
    pair = _bound(4 * b * c + 4 * (b + c) + 4 * c + 8 * b * nprobe + 4 * b * u, 3 * b * c,
                  FP32_OPS)
    return {"shape": [b, c], "P": nprobe, "u": u, "max_abs_err": 0.0,
            "distinct_blocks_per_query": float(
                sum(len(set(r.tolist())) for r in want.cpu()) / b),
            "distinct_blocks_in_batch": torch.unique(want).numel(),
            "ms": fused_dev - k2_dev, "device_ms": fused_dev - k2_dev,
            "fused_ms": _median_ms(fused), "fused_loop_ms": _loop_ms(fused),
            "fused_device_ms": fused_dev, "k2_alone_device_ms": k2_dev,
            "fused_bound_ms": pair["bound_ms"],
            "plain_ms": _median_ms(lambda: dense_blocks_plain(st.cell_block, top, u)),
            "library_ms": None,
            # K10's own work: the P cells of each row read, their map
            # entries gathered, the u blocks written, one compare a cell
            # at the least
            **_bound(4 * b * nprobe + 4 * b * nprobe + 4 * b * u, b * nprobe, FP32_OPS)}


def sq8_search_phase(dev, x, queries, truth):
    """`ops.quantize.sq8_search` (no index calls it; the reference's own
    tests do) over the 1M pool's u8 codes for 1024 queries: recall@10
    against the exact oracle."""
    from turdb_tpu_torch.ops.quantize import sq8_encode, sq8_search
    from turdb_tpu_torch.utils.datasets import recall_of

    xd = torch.as_tensor(x, device=dev)
    codes, mins, scales = sq8_encode(xd)
    del xd
    valid = torch.ones(len(x), dtype=torch.bool, device=dev)
    q = torch.as_tensor(queries[:BATCH], device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    d, i = sq8_search(q, codes, mins, scales, valid, K)
    torch.cuda.synchronize()
    out = {"search_s": time.perf_counter() - t,
           "recall@10": recall_of(i[:N_ORACLE].cpu().numpy(), truth),
           "store_gib": sum(a.numel() * a.element_size() for a in (codes, mins, scales)) / 2**30}
    check(tuple(i.shape) == (BATCH, K) and bool(torch.isfinite(d).all()), "sq8_search shape")
    log(f"sq8_search over 1M u8 rows: recall@10 {out['recall@10']:.4f}")
    check(out["recall@10"] >= SQ8_SEARCH_GATE, f"sq8_search recall {out['recall@10']}")
    return out, (q, codes, mins, scales)


def k11_check(store, gen, truth):
    """K11 against its plain version at B = 1024, N = 1M, d = 128, k = 10,
    with 1 % of the rows invalid: ids equal except at ties, distances
    within DOT_RTOL of the distance scale (the int8 tensor cores' exact
    sums joined in fp32, against cuBLAS's fp32 order); the share of ids
    apart; its recall against the exact oracle beside its plain version's
    (which the fp32 kernel before it equalled bit for bit, PERF.md §6), within
    K11_RECALL_TOL. Bound on both units: the fp32 FMA pipes, and the
    kernel's own work, four int8 passes."""
    from turdb_tpu_torch.kernels import sq8_scan, sq8_scan_plain
    from turdb_tpu_torch.utils.datasets import recall_of

    q, codes, mins, scales = store
    n, d = codes.shape
    b = q.shape[0]
    valid = torch.rand(n, device=q.device, generator=gen) >= 0.01
    qn, qsum = (q * q).sum(1), q.sum(1)
    args = (q, qn, qsum, codes, mins, scales, valid, K)
    dk, ik = sq8_scan(*args)
    dp, ip = sq8_scan_plain(*args)
    err, id_diff = _near_equal(dk, ik, dp, ip, DOT_RTOL, "K11 sq8_scan")
    all_valid = (q, qn, qsum, codes, mins, scales, torch.ones_like(valid), K)
    rec = recall_of(sq8_scan(*all_valid)[1][:N_ORACLE].cpu().numpy(), truth)
    rec_plain = recall_of(sq8_scan_plain(*all_valid)[1][:N_ORACLE].cpu().numpy(), truth)
    check(abs(rec - rec_plain) <= K11_RECALL_TOL,
          f"K11 recall@10 {rec} against its plain version's {rec_plain}")

    dev_ms, parts = _device_parts(lambda: sq8_scan(*args))
    return {"shape": [b, n, d], "k": K, "max_abs_err": err, "id_diff": id_diff,
            "recall@10_all_valid": rec, "plain_recall@10_all_valid": rec_plain,
            "ms": _median_ms(lambda: sq8_scan(*args)), "loop_ms": _loop_ms(lambda: sq8_scan(*args)),
            "device_ms": dev_ms, "device_parts": parts,
            "plain_ms": _median_ms(lambda: sq8_scan_plain(*args), reps=3),
            **_sq8_library_and_bound(*args)}


def _sq8_library_and_bound(q, qn, qsum, codes, mins, scales, valid, k):
    """K11's yardsticks on its arguments: the time of the same function as
    one matmul, its epilogue and `torch.topk`; the bound on both units (the
    bytes: the codes, the rows' min / scale / valid, the queries and the
    outputs once), the fp32 FMA pipes and the kernel's own work, four int8
    passes of B x N x d multiply-adds."""
    n, d = codes.shape
    b = q.shape[0]

    def library():
        u = codes.float()
        xn = d * mins ** 2 + 2.0 * mins * scales * u.sum(1) + scales ** 2 * (u * u).sum(1)
        dist = qn[:, None] - 2.0 * (mins[None, :] * qsum[:, None] + scales[None, :] * (q @ u.T))
        dist = torch.where(valid[None, :], torch.clamp_min(dist + xn[None, :], 0.0), float("inf"))
        return torch.topk(dist, k, largest=False)

    nbytes = n * d + 12 * n + n + b * (4 * d + 8) + 8 * b * k
    return {"library_ms": _median_ms(library, reps=3),
            "bound_fp32_ms": _bound(nbytes, 2 * b * n * d, FP32_OPS)["bound_ms"],
            **_bound(nbytes, 4 * 2 * b * n * d, INT8_OPS)}


def k2_merge_check(case):
    """K2 at the mesh merge's shape: the 4 shards' lists of one batch,
    [1024, 4 · 10] -> 10, bit-equal; its time between events and its
    device time in a trace, beside `torch.topk`'s."""
    from turdb_tpu_torch.kernels import topk_rows, topk_rows_plain

    ds, _ = case
    x = torch.cat(ds, dim=1).contiguous()
    vk, pk = topk_rows(x, K)
    vp, pp = topk_rows_plain(x, K)
    check(torch.equal(vk, vp) and torch.equal(pk, pp), "K2 mesh merge: not bit-equal")
    err, tie = _selection_error(vk, pk, vp, pp, lambda p: torch.gather(x, 1, p.long()),
                                K2_RTOL, "K2 mesh merge")
    b, n = x.shape
    return {"shape": [b, n], "k": K, "max_abs_err": err, "tie_id_diff": tie,
            "ms": _median_ms(lambda: topk_rows(x, K)),
            "device_ms": _trace_ms(lambda: topk_rows(x, K), "topk_short_kernel"),
            "plain_ms": _median_ms(lambda: topk_rows_plain(x, K)),
            "library_ms": _median_ms(lambda: torch.topk(x, K, largest=False)),
            "library_device_ms": _trace_ms(lambda: torch.topk(x, K, largest=False)),
            **_bound(4 * b * n + 8 * b * K, b * n, FP32_OPS)}


def k2_width_check(idx, batch, nprobe):
    """K2 at the sq8 headline's own cell selection: [1024, C] with C read
    from the built index (no multiple of the segment), k = its gate's
    nprobe; bit-equal, timed beside `torch.topk`."""
    from turdb_tpu_torch.kernels import EPI_L2, _row_values, topk_rows, topk_rows_plain

    st = idx.state
    q = batch.float().contiguous()
    dots = q @ st.centroids.T
    kw = dict(rown=(q * q).sum(1), coln=st.cnorms, epilogue=EPI_L2)
    vk, pk = topk_rows(dots, nprobe, **kw)
    vp, pp = topk_rows_plain(dots, nprobe, **kw)
    check(torch.equal(vk, vp) and torch.equal(pk, pp), "K2 at the sq8 cell width: not bit-equal")
    full = _row_values(dots, kw["rown"], kw["coln"], None, EPI_L2, False)
    b, n = dots.shape
    return {"shape": [b, n], "k": nprobe, "max_abs_err": 0.0,
            "ms": _median_ms(lambda: topk_rows(dots, nprobe, **kw)),
            "library_ms": _median_ms(lambda: torch.topk(full, nprobe, largest=False)),
            **_bound(4 * b * n + 4 * (b + n) + 8 * b * nprobe, 3 * b * n, FP32_OPS)}

def _on_cpu(state):
    from turdb_tpu_torch.parallel.sharded import _to_device

    return _to_device(state, torch.device("cpu"))


def width_check(dev):
    """The widths past the old limits, outside the counted paths, each in
    its kernel (launches counted here) and against its plain version: K2's
    wide form (bit-equal, and with K10 fused), K11 past its list mode and
    past one column slice (DOT_RTOL), the d = 6 / 130 IVF and HNSW stores
    and a 10-level graph (against the same state searched on the CPU);
    then the widths no kernel holds, which must raise (ValueError, before
    the kernel that refuses them launches)."""
    import copy
    import dataclasses

    from turdb_tpu_torch import kernels
    from turdb_tpu_torch.kernels import EPI_L2
    from turdb_tpu_torch.models import hnsw as th
    from turdb_tpu_torch.models.hnsw_serve import serve_search_impl
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.ops.quantize import sq8_encode
    from turdb_tpu_torch.utils.datasets import make_pool

    out = {}

    def launched(name, fn, kernel, n):
        before = kernels.launches[kernel]
        res = fn()
        torch.cuda.synchronize()
        got = kernels.launches[kernel] - before
        check(got == n, f"{name}: {got} {kernel} launches, expected {n}")
        return res

    def near(name, got, want):
        err, diff = _near_equal(got[0].cpu(), got[1].cpu(), want[0].cpu(), want[1].cpu(),
                                DOT_RTOL, name)
        out[name] = {"max_abs_err": err, "id_diff": diff}
        log(f"width {name}: max abs err {err}, ids apart {diff}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn(5000, 16, device=dev, generator=gen)
    q = torch.randn(64, 16, device=dev, generator=gen)
    dots = q @ x.T
    kw = dict(rown=(q * q).sum(1), coln=(x * x).sum(1), epilogue=EPI_L2)
    got = launched("topk_rows k=3000", lambda: kernels.topk_rows(dots, 3000, **kw), "topk_rows", 1)
    want = kernels.topk_rows_plain(dots, 3000, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "K2's wide form: not bit-equal")
    cell_block = torch.randint(0, 700, (5000,), device=dev, generator=gen, dtype=torch.int32)
    _, top, blk = kernels.topk_rows(dots, 3000, cell_block=cell_block, u=2100, **kw)
    check(torch.equal(blk, kernels.dense_blocks_plain(cell_block, top, 2100)),
          "K10 in K2's wide form: not bit-equal")
    out["topk_rows k=3000"] = {"shape": list(dots.shape), "max_abs_err": 0.0,
                               **_k2_timed(dots, 3000, **kw)}
    # K11's distance mode (k past 64) at k = 100 and 2100, its column slices
    # (rows past 320 codes) at d = 384
    for d, k in ((128, 100), (128, 2100), (384, 10)):
        xs = torch.randn(100_000, d, device=dev, generator=gen)
        codes, mins, scales = sq8_encode(xs)
        qs = torch.randn(256, d, device=dev, generator=gen)
        valid = torch.rand(100_000, device=dev, generator=gen) >= 0.01
        args = (qs, (qs * qs).sum(1), qs.sum(1), codes, mins, scales, valid, k)
        n_launch = len(kernels.sq8_slices(d))
        got = launched(f"sq8_scan d={d} k={k}", lambda: kernels.sq8_scan(*args), "sq8_scan",
                       n_launch)
        near(f"sq8_scan d={d} k={k}", got, kernels.sq8_scan_plain(*args))
        out[f"sq8_scan d={d} k={k}"].update(
            shape=[256, 100_000, d], launches=n_launch,
            ms=_median_ms(lambda: kernels.sq8_scan(*args)),
            plain_ms=_median_ms(lambda: kernels.sq8_scan_plain(*args)),
            **_sq8_library_and_bound(*args))
        del xs, codes
    for d in (6, 130):
        pool = make_pool(np.random.default_rng(4), 12_032, d)
        dx, dq = pool[:12_000], pool[12_000:]
        for flags in (dict(), dict(sq8=True, rerank=40)):
            idx = IvfIndex(dim=d, device=dev, **flags)
            idx.add(dx)
            check(idx.state.pvecs.shape[-1] == d, f"the d = {d} IVF store's dim")
            cpu = copy.copy(idx)
            cpu.device, cpu.state = torch.device("cpu"), _on_cpu(idx.state)
            near(f"ivf d={d}{' sq8' if flags else ''}", idx.search(dq, K, nprobe=8, out="torch"),
                 cpu.search(dq, K, nprobe=8, out="torch"))
        hd = th.HnswIndex(dim=d, device=dev, ef_construction=64)
        hd.add(dx[:6000])
        hd.add(dx[6000:6500])
        hd.pack_serving()
        dqt = torch.as_tensor(dq, device=dev)
        near(f"hnsw d={d}", hd.search(dqt, K, ef=64, out="torch"),
             th.hnsw_search_impl(_on_cpu(hd.state), dqt.cpu(), None, cfg=hd.cfg, k=K, ef=64,
                                 iters=96, filtered=False, descent_ef=hd._descent_ef))
        near(f"hnsw serve d={d}", hd.search_serve(dqt, K, ef=64, out="torch"),
             serve_search_impl(_on_cpu(hd.serve), dqt.cpu(), None, metric=hd.cfg.metric, k=K,
                               ef=64, iters=96))
    pool = make_pool(np.random.default_rng(3), 20_032, 32)
    px, hq = pool[:20_000], torch.as_tensor(pool[20_000:], device=dev)
    ten = th.HnswIndex(dim=32, device=dev, ef_construction=64, bulk_threshold=10**9)
    ten.cfg = dataclasses.replace(ten.cfg, max_levels=10)
    ten.state = th.init_state(ten.cfg, ten.capacity, ten.device)
    ten.add(px[:4000])
    got = launched("hnsw 10 levels", lambda: ten.search(hq, K, ef=64, out="torch"),
                   "hnsw_greedy", 2)
    near("hnsw 10 levels", got,
         th.hnsw_search_impl(_on_cpu(ten.state), hq.cpu(), None, cfg=ten.cfg, k=K, ef=64,
                             iters=96, filtered=False, descent_ef=ten._descent_ef))
    # the widths no kernel holds: refused before any launch
    ivf = IvfIndex(dim=32, device=dev, n_clusters=16, sq8=True, rerank=2500)
    ivf.add(px)
    hn = th.HnswIndex(dim=32, device=dev, ef_construction=64)
    hn.add(px[:12_000])
    hn.pack_serving()
    x5 = torch.randn(4000, 512, device=dev, generator=gen)
    cand = torch.randint(0, 4000, (64, 100), dtype=torch.int32, device=dev, generator=gen)
    refused = {
        "ivf rerank=2500": lambda: ivf.search(pool[20_000:], K, nprobe=8),
        "hnsw ef=1500": lambda: hn.search(hq, K, ef=1500),
        "hnsw serve ef=1500": lambda: hn.search_serve(hq, K, ef=1500),
        "hnsw_select W=100 d=512": lambda: kernels.hnsw_select(
            x5, (x5 * x5).sum(1), torch.arange(64, dtype=torch.int32, device=dev), cand, deg=16,
            metric=0, alpha=1.0),
    }
    for name, fn in refused.items():
        try:
            fn()
        except ValueError as e:
            out[name] = {"refused": str(e)}
        else:
            check(False, f"{name}: answered on the card; no kernel holds it")
        log(f"width {name}: refused ({out[name]['refused']})")
    return out


# ---------------------------------------------------------------------------
# the SQL database (turdb_tpu_torch.database) over the port's indexes

N_SQL_QUERIES = 256          # held-out queries sent as SQL statements
N_SQL_INSERT = 256           # rows INSERTed into the HNSW-indexed table
SQL_REL_TOL = 1e-6           # distances after a reopen against before it
SQL_TRACED = 8               # statements in a store's device trace
SQL_REOPEN = 64              # statements a path repeats after the reopen
# The 256 INSERTed rows join the 1M bulk graph as one wave at the next
# statement's flush. They find themselves as the insert path's rows do
# (the waves' greedy descent, ROADMAP queue 3; 0.4986 of 65,536 rows there,
# 0.5039 of a 256-row add), but 256 rows give a standard error of 0.031:
# 0.4258 of them did (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), every
# one as the index's own search on the same state answers. The gate sits
# 1.6 standard errors under INSERT_SELF_HIT_GATE.
SQL_INSERT_SELF_HIT_GATE = 0.40


def _sql_vec(v):
    return "'[" + ",".join(f"{float(a):.6f}" for a in v) + "]'"


def _sql_ann(lit, limit=K):
    return f"SELECT id, emb <-> {lit} FROM docs ORDER BY emb <-> {lit} LIMIT {limit}"


def _parsed(vecs):
    """The vectors as the SQL engine reads their literals."""
    from turdb_tpu_torch.sql.expr import parse_vector_text

    return np.stack([parse_vector_text(_sql_vec(v).strip("'")) for v in vecs])


def _exact_d(rows, lit):
    """`emb <-> lit` over these rows as the SQL engine computes it (sql/expr.py
    `_vector_distance`, the literal read once a row)."""
    from turdb_tpu_torch.sql.expr import Col, _vector_distance

    rows = np.asarray(rows, np.float32)
    text = lit.strip("'")
    return _vector_distance("<->", Col(rows), Col(np.array([text] * len(rows), object))).values


def _same_ranking(got, want, vec_of, lit, what):
    """`got` and `want` are id lists in rank order: equal, or apart only
    where the two ids' exact distances tie."""
    check(len(got) == len(want), f"{what}: {len(got)} rows against {len(want)}")
    for a, b in zip(got, want):
        if a != b:
            da, db_ = _exact_d(vec_of([a, b]), lit)
            check(da == db_, f"{what}: id {a} where {b} was expected")


def _sql_timed(db, sql_list):
    """Each statement through `db.query`: (rows, ms each)."""
    rows, ms = [], []
    for s in sql_list:
        t = time.perf_counter()
        rows.append(db.query(s))
        ms.append((time.perf_counter() - t) * 1e3)
    return rows, ms


def _pcts(ms):
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "statements": len(ms)}


def _sql_recall(rows, truth):
    return float(np.mean([len({r[0] for r in rr} & set(t.tolist())) / K
                          for rr, t in zip(rows, truth)]))


def sql_phase(dev, x, queries):
    """The database on the card (`Database.create` with its default device):
    the 1M make_pool rows bulk-loaded as docs(id, emb VECTOR(128), grp) with
    the WAL on; exact queries without an index; USING IVF (f32, then
    compact) and USING HNSW, each queried by 256 held-out SQL statements
    against the card's FlatIndex oracle; 256 INSERTs into the graph; the
    serving pack; a checkpoint, close and reopen that must give the same
    answers."""
    import shutil
    import tempfile

    from turdb_tpu_torch import Database
    from turdb_tpu_torch.models.flat import FlatIndex

    out = {}
    qv = _parsed(queries[:N_SQL_QUERIES])
    new = _parsed(queries[N_SQL_QUERIES:N_SQL_QUERIES + N_SQL_INSERT])
    lits = [_sql_vec(v) for v in qv]
    # the oracle follows the table: slot = id (the DELETE and the INSERTs
    # below are applied to it too)
    flat = FlatIndex(dim=DIM, capacity=len(x) + N_SQL_INSERT, device=dev)
    flat.add(x)
    truth = flat.search(qv, k=K)[1]

    def vec_of(ids):
        ids = np.asarray(ids)
        return np.where((ids < N)[:, None], x[np.minimum(ids, N - 1)],
                        new[np.clip(ids - N, 0, N_SQL_INSERT - 1)])

    def explain(db):
        return "\n".join(r[0] for r in db.query("EXPLAIN " + _sql_ann(lits[0])))

    def traced(db):
        # a trace of one statement now and then keeps no device span at all;
        # SQL_TRACED of them, taken again if so
        prof = _traced(lambda: db.query(_sql_ann(lits[1])), SQL_TRACED)
        return {"statements": SQL_TRACED,
                **{k: prof[k] for k in ("busy_ms", "window_ms", "idle_share", "top")}}

    def ann(name, db, gate=True):
        rows, ms = _sql_timed(db, [_sql_ann(s) for s in lits])
        rec = _sql_recall(rows, truth)
        out[name] = {"recall@10": rec, **_pcts(ms), "trace": traced(db)}
        log(f"sql {name}: recall@10 {rec}, p50 {out[name]['p50_ms']:.3f} ms, "
            f"p99 {out[name]['p99_ms']:.3f} ms, idle {out[name]['trace']['idle_share']:.3f}")
        if gate:
            check(rec >= RECALL_GATE, f"sql {name}: recall@10 {rec} < {RECALL_GATE}")
        check(all(len(r) == K for r in rows), f"sql {name}: short answers")
        return rows

    tmp = tempfile.mkdtemp(prefix="turdb_sql_")
    path = f"{tmp}/db"
    try:
        t = time.perf_counter()
        db = Database.create(path)
        db.execute(f"CREATE TABLE docs (id BIGINT PRIMARY KEY, emb VECTOR({DIM}), grp INT)")
        check(db.wal_enabled, "the WAL is off")
        db.bulk_insert("docs", {"id": np.arange(len(x)), "emb": x, "grp": np.arange(len(x)) % 4})
        out["load_s"] = time.perf_counter() - t
        log(f"sql load: {len(x)} rows in {out['load_s']:.3f} s")
        # the exact path (no index): the oracle's ranking
        for i in range(4):
            rows = db.query("SELECT id FROM docs ORDER BY emb <-> $1 LIMIT 10", [qv[i]])
            _same_ranking([r[0] for r in rows], truth[i].tolist(), vec_of, lits[i],
                          f"sql exact query {i}")

        # IVF, the f32 store
        t = time.perf_counter()
        db.execute("CREATE INDEX iv ON docs USING IVF (emb) WITH (nprobe = 8)")
        out["create_ivf_s"] = time.perf_counter() - t
        check(db.catalog["main"]["docs"].hnsw["iv"].index.device.type == "cuda",
              "the IVF index is not on the card")
        check("AnnIndexScan" in explain(db), "EXPLAIN shows no AnnIndexScan under USING IVF")
        ivf_rows = ann("ivf", db)
        rows = db.query(f"SELECT id, grp FROM docs WHERE grp = 1 ORDER BY emb <-> {lits[2]} "
                        "LIMIT 10")
        check(len(rows) == K and all(r[1] == 1 for r in rows),
              f"sql ivf WHERE grp = 1: {rows}")
        victim = ivf_rows[3][0][0]
        db.execute(f"DELETE FROM docs WHERE id = {victim}")
        rows = db.query(_sql_ann(lits[3]))
        check(victim not in [r[0] for r in rows], "sql ivf: a deleted row came back")
        flat.delete([victim])
        truth = flat.search(qv, k=K)[1]

        # IVF, the compact store (int8 probe + SQ16 rerank)
        db.execute("DROP INDEX iv")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        db.execute("CREATE INDEX ivc ON docs USING IVF (emb) WITH (compact = true)")
        out["create_ivf_compact_s"] = time.perf_counter() - t
        ann("ivf_compact", db)

        # HNSW: the bulk build, the graph path, inserts, the serving pack
        db.execute("DROP INDEX ivc")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        db.execute("CREATE INDEX ih ON docs USING HNSW (emb)")
        out["create_hnsw_s"] = time.perf_counter() - t
        info = db.catalog["main"]["docs"]
        h = info.hnsw["ih"]
        check(h.index.device.type == "cuda", "the HNSW index is not on the card")
        check("hnsw:ih" in explain(db), "EXPLAIN shows no AnnIndexScan under USING HNSW")
        graph_rows = ann("hnsw_graph", db, gate=False)
        def index_ids(queries, k, ef):
            """The index's own search on the statements' visibility: the
            ids (not the rowids the index holds) of each query's k rows."""
            at = info.table.visible_indices(db.mgr, db.mgr.snapshot_ts(), 0)
            vis = info.table.rowids[at]
            order = np.argsort(vis)
            ids = np.asarray(info.table.column_batch("id", at)[0])[order]
            _, slots = h.index.search(queries, k=k, ef=ef, allowed=h._allowed_mask(vis))
            rids = [h._slots_to_rowids(sl) for sl in slots]
            return [ids[np.searchsorted(vis[order], r[r >= 0])] for r in rids]

        # the statements against the index's own answer: its 40 candidates
        # at ef 80 (the ANN path's fetch and ef for LIMIT 10), the 10 best
        # by exact distance
        for i, (rr, cand) in enumerate(zip(graph_rows, index_ids(qv, 4 * K, 8 * K))):
            want = cand[np.argsort(_exact_d(vec_of(cand), lits[i]), kind="stable")[:K]]
            _same_ranking([r[0] for r in rr], want.tolist(), vec_of, lits[i],
                          f"sql hnsw graph query {i} against HnswIndex.search")
        ms = []
        for j, v in enumerate(new):
            t = time.perf_counter()
            db.execute(f"INSERT INTO docs VALUES ({N + j}, {_sql_vec(v)}, {j % 4})")
            ms.append((time.perf_counter() - t) * 1e3)
        own, _ = _sql_timed(db, [_sql_ann(_sql_vec(v), 1) for v in new])
        found = np.array([rr[0][0] == N + j for j, rr in enumerate(own)])
        # the same rows through the index's own search (LIMIT 1: 9 rows at
        # ef 64) on the same state and visibility
        in_index = np.array([N + j in c for j, c in enumerate(index_ids(new, 9, 64))])
        check(np.array_equal(found, in_index),
              f"sql insert: {int((found != in_index).sum())} rows found by the statement "
              "and not by HnswIndex.search, or the other way")
        hit = float(found.mean())
        out["insert"] = {**_pcts(ms), "self_hit": hit}
        log(f"sql insert: {json.dumps(out['insert'])}")
        check(hit >= SQL_INSERT_SELF_HIT_GATE,
              f"sql insert: self-hit {hit} < {SQL_INSERT_SELF_HIT_GATE}")
        flat.add(new)
        truth = flat.search(qv, k=K)[1]
        graph_before, _ = _sql_timed(db, [_sql_ann(s) for s in lits])
        t = time.perf_counter()
        db.execute("PRAGMA ann_pack = 'docs'")
        out["ann_pack_s"] = time.perf_counter() - t
        check(h.index.serve is not None, "PRAGMA ann_pack built no serving pack")
        serve_before = ann("hnsw_serve", db)

        # checkpoint, close, reopen: the snapshot loads, the answers hold
        for step, fn in (("checkpoint_s", db.checkpoint), ("close_s", db.close)):
            t = time.perf_counter()
            fn()
            out[step] = time.perf_counter() - t
        t = time.perf_counter()
        db = Database.open(path)
        out["open_s"] = time.perf_counter() - t
        info = db.catalog["main"]["docs"]
        check(getattr(info, "_hnsw_loaded", False), "the .hnsw snapshot did not load")
        check(info.hnsw["ih"].index.device.type == "cuda", "the reopened index is not on the card")

        def same(before, what):
            after, ms = _sql_timed(db, [_sql_ann(s) for s in lits[:SQL_REOPEN]])
            for i, (a, b) in enumerate(zip(after, before)):
                check([r[0] for r in a] == [r[0] for r in b], f"{what} query {i}: ids moved")
                check(np.allclose([r[1] for r in a], [r[1] for r in b], rtol=SQL_REL_TOL,
                                  atol=0.0), f"{what} query {i}: distances moved")
            return _pcts(ms)

        out["reopen_graph"] = same(graph_before, "sql graph path after the reopen")
        db.execute("PRAGMA ann_pack = 'docs'")
        out["reopen_serve"] = same(serve_before, "sql serve path after the reopen")
        out["graph_recall@10_before_reopen"] = _sql_recall(graph_before, truth)
        db.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"sql: {json.dumps({k: v for k, v in out.items() if not isinstance(v, dict)})}")
    return out

# ---------------------------------------------------------------------------

KERNELS = {
    "ivf_probe_f32": ("turdb_tpu_torch/kernels/csrc/ivf_probe.cu",
                      "turdb_tpu/models/ivf.py:286"),
    "topk_rows": ("turdb_tpu_torch/kernels/csrc/topk_rows.cu",
                  "turdb_tpu/ops/topk.py:45"),
    "kmeans_assign": ("turdb_tpu_torch/kernels/csrc/kmeans_assign.cu",
                      "turdb_tpu/models/ivf.py:117"),
    "ivf_probe_sq8": ("turdb_tpu_torch/kernels/csrc/ivf_probe.cu",
                      "turdb_tpu/models/ivf.py:291"),
    "ivf_rerank": ("turdb_tpu_torch/kernels/csrc/ivf_rerank.cu",
                   "turdb_tpu/models/ivf.py:333"),
    "hnsw_serve_beam": ("turdb_tpu_torch/kernels/csrc/hnsw_beam.cu",
                        "turdb_tpu/models/hnsw_serve.py:137"),
    "hnsw_select": ("turdb_tpu_torch/kernels/csrc/hnsw_select.cu",
                    "turdb_tpu/models/hnsw.py:568"),
    "hnsw_graph_beam": ("turdb_tpu_torch/kernels/csrc/hnsw_beam.cu",
                        "turdb_tpu/models/hnsw.py:234"),
    "hnsw_greedy": ("turdb_tpu_torch/kernels/csrc/hnsw_greedy.cu",
                    "turdb_tpu/models/hnsw.py:192"),
    "hnsw_graph_beam_sq": ("turdb_tpu_torch/kernels/csrc/hnsw_beam.cu",
                           "turdb_tpu/models/hnsw.py:130"),
    "hnsw_select_sorted": ("turdb_tpu_torch/kernels/csrc/hnsw_select.cu",
                           "turdb_tpu/models/hnsw.py:471"),
    "dense_blocks": ("turdb_tpu_torch/kernels/csrc/topk_rows.cu",
                     "turdb_tpu/models/ivf.py:225"),
    "sq8_scan": ("turdb_tpu_torch/kernels/csrc/sq8_scan.cu",
                 "turdb_tpu/ops/quantize.py:42"),
}
# the kernels each main path must launch
PATH_KERNELS = {
    "f32": ("ivf_probe_f32", "topk_rows", "kmeans_assign"),
    "sq8": ("ivf_probe_sq8", "ivf_rerank", "topk_rows", "kmeans_assign"),
    "compact": ("ivf_probe_sq8", "ivf_rerank", "topk_rows", "kmeans_assign"),
    "hard": ("ivf_probe_sq8", "ivf_rerank", "topk_rows", "kmeans_assign"),
    "probe_only": ("ivf_probe_sq8", "topk_rows", "kmeans_assign"),
    "hnsw": ("topk_rows", "kmeans_assign", "ivf_probe_sq8", "hnsw_serve_beam", "hnsw_select",
             "hnsw_graph_beam"),
    "hnsw_insert": ("topk_rows", "kmeans_assign", "ivf_probe_sq8", "hnsw_serve_beam",
                    "hnsw_select", "hnsw_graph_beam", "hnsw_greedy", "hnsw_select_sorted",
                    "hnsw_graph_beam_sq"),
    "hnsw_wave": ("topk_rows", "hnsw_select", "hnsw_graph_beam", "hnsw_greedy",
                  "hnsw_select_sorted"),
    "mesh_ivf": ("ivf_probe_f32", "ivf_probe_sq8", "ivf_rerank", "topk_rows", "kmeans_assign"),
    "mesh_hnsw": ("topk_rows", "kmeans_assign", "ivf_probe_sq8", "hnsw_serve_beam",
                  "hnsw_select", "hnsw_graph_beam", "hnsw_greedy", "hnsw_select_sorted"),
    "dense_ivf": ("dense_blocks", "ivf_probe_f32", "topk_rows", "kmeans_assign"),
    "sq8_search": ("sq8_scan", "topk_rows"),
    "sql": ("ivf_probe_f32", "topk_rows", "kmeans_assign", "ivf_probe_sq8", "ivf_rerank",
            "hnsw_serve_beam", "hnsw_select", "hnsw_graph_beam", "hnsw_greedy",
            "hnsw_select_sorted"),
}


def kernel_rows(launches):
    """The {"kernels": [...]} rows: each kernel's timed shape from the
    kernel phase, its launches summed over the main paths."""
    timed = {
        "ivf_probe_f32": REPORT["k1"],
        "topk_rows": REPORT["k2"][f"cell_select_k{K1_PROBE}"],
        "kmeans_assign": REPORT["k3"],
        "ivf_probe_sq8": REPORT["k4"][f"cand_P{SQ8_PROBE}"],
        "ivf_rerank": REPORT["k5"]["f32"],
        "hnsw_serve_beam": REPORT["k6"][f"ef{REPORT['hnsw']['gate']['ef']}"],
        "hnsw_select": REPORT["k7"]["W64"],
        "hnsw_graph_beam": REPORT["k8"]["search"],
        "hnsw_greedy": REPORT["k9"]["wave512"],
        "hnsw_graph_beam_sq": REPORT["k8sq"]["sq8"],
        "hnsw_select_sorted": REPORT["k7s"],
        "dense_blocks": REPORT["k10"],
        "sq8_scan": REPORT["k11"],
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # where measured: ten calls back to back (the host's launch path hidden),
    # K3's yardstick, the bf16 product of its operands alone, a trace's
    # device time, and K9's longest chain of steps and device time a step
    extra = ("loop_ms", "gemm_ms", "device_ms", "longest_chain", "step_ms", "bound_fp32_ms")
    return [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts.get(name, 0) for counts in launches.values()),
         **{k: timed[name][k] for k in keys},
         **{k: timed[name][k] for k in extra if k in timed[name]}}
        for name, (src, rep) in KERNELS.items()
    ]


def run_paths(dev, launches):
    """The main paths, each between a reset and a read of the launch
    counts; the traced searches run after each path's counts are read."""
    from turdb_tpu_torch import kernels
    from turdb_tpu_torch.utils.datasets import make_pool
    from turdb_tpu_torch.utils.timing import device_profile

    def counted(name, fn):
        kernels.reset_launches()
        result = fn()
        launches[name] = dict(kernels.launches)
        log(f"launches on the {name} path: {json.dumps(launches[name])}")
        for k in PATH_KERNELS[name]:
            check(launches[name][k] > 0, f"{k} never launched on the {name} path")
        return result

    def profile(name, idx, batches, nprobe):
        REPORT[f"{name}_profile"] = device_profile(
            lambda: [idx.search(b, K, nprobe=nprobe, out="torch") for b in batches])
        log(f"{name} search profile: {json.dumps(REPORT[f'{name}_profile'])}")

    # one generator feeds make_pool, then hard_pool: the bench's draw order
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    pool = make_pool(rng, N + N_QUERIES, DIM)
    x, queries = pool[:N], pool[N:]
    REPORT["pool_s"] = time.perf_counter() - t
    truth, REPORT["oracle_s"] = _oracle(dev, x, queries)

    def f32():
        out, idx, batches = headline_phase(dev, x, queries, truth)
        REPORT["headline"] = out
        REPORT["maintenance"] = maintenance_phase(idx, queries, out["gate_nprobe"], n=len(x))
        return idx, batches, out["gate_nprobe"]

    idx, batches, gate = counted("f32", f32)
    profile("search", idx, batches, gate)
    del idx

    def sq8():
        REPORT["sq8"], idx, batches = sq8_phase(dev, x, queries, truth)
        return idx, batches

    idx, batches = counted("sq8", sq8)
    sq8_gate = REPORT["sq8"]["gate_nprobe"]
    profile("sq8", idx, batches, sq8_gate)
    REPORT["k2"]["sq8_cell_width"] = k2_width_check(idx, batches[0], sq8_gate)
    log(f"k2 at the sq8 cell width: {json.dumps(REPORT['k2']['sq8_cell_width'])}")
    del idx

    def compact():
        REPORT["compact"], idx, batches = compact_phase(dev, x, queries, truth, sq8_gate,
                                                         REPORT["sq8"])
        return idx, batches

    idx, batches = counted("compact", compact)
    profile("compact", idx, batches, sq8_gate)
    del idx

    REPORT["probe_only"] = counted("probe_only",
                                   lambda: probe_only_phase(dev, x, queries, N_PROBE_ONLY))
    torch.cuda.empty_cache()

    def hnsw():
        REPORT["hnsw"], idx, batches, gate, dele = hnsw_phase(dev, x, queries, truth)
        return idx, batches, gate, dele

    idx, batches, gate, dele = counted("hnsw", hnsw)
    # undo the deletes: the traces and the kernel checks below see the
    # graph the QPS was measured on
    idx._alive[dele] = True
    REPORT["hnsw_serve_profile"] = device_profile(
        lambda: [idx.search_serve(b, K, ef=gate[0], iters=gate[1], out="torch") for b in batches])
    log(f"hnsw serve profile: {json.dumps(REPORT['hnsw_serve_profile'])}")
    REPORT["hnsw_graph_profile"] = device_profile(
        lambda: [idx.search(b, K, ef=HNSW_GRAPH_EF, out="torch") for b in batches[:4]])
    log(f"hnsw graph profile: {json.dumps(REPORT['hnsw_graph_profile'])}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    REPORT["k6"] = k6_check(idx, batches[0], gate)
    REPORT["k8"] = k8_check(idx, batches[0])
    REPORT["k7"] = k7_check(idx, gen)
    for name in ("k6", "k7", "k8"):
        log(f"{name}: {json.dumps(REPORT[name])}")
    del idx, batches
    torch.cuda.empty_cache()

    def hnsw_insert():
        REPORT["hnsw_insert"], idx = hnsw_insert_phase(dev, x, queries, truth)
        return idx

    ins = counted("hnsw_insert", hnsw_insert)
    torch.cuda.empty_cache()

    def hnsw_wave():
        REPORT["hnsw_wave"], idx = hnsw_wave_phase(dev, x, queries)
        return idx

    wave = counted("hnsw_wave", hnsw_wave)
    qb = torch.as_tensor(queries[:BATCH], device=dev)
    wave_q = torch.as_tensor(queries[BATCH:BATCH + 512], device=dev)
    REPORT["k9"] = k9_check(ins, wave, wave_q, qb)
    REPORT["k8sq"] = k8sq_check(ins, qb)
    REPORT["k7s"] = k7_sorted_check(ins, wave_q)
    for name in ("k9", "k8sq", "k7s"):
        log(f"{name}: {json.dumps(REPORT[name])}")
    del ins, wave
    torch.cuda.empty_cache()

    def mesh_ivf():
        REPORT["mesh_ivf"], merge_case = mesh_ivf_phase(dev, x, queries, truth)
        return merge_case

    merge_case = counted("mesh_ivf", mesh_ivf)
    REPORT["k2"]["mesh_merge"] = k2_merge_check(merge_case)
    log(f"k2 mesh merge: {json.dumps(REPORT['k2']['mesh_merge'])}")
    del merge_case
    torch.cuda.empty_cache()

    REPORT["mesh_hnsw"] = counted("mesh_hnsw", lambda: mesh_hnsw_phase(dev, x, queries, truth))
    torch.cuda.empty_cache()

    def dense_ivf():
        REPORT["dense_ivf"], idx, batches = dense_ivf_phase(dev, x, queries, truth)
        return idx, batches

    idx, batches = counted("dense_ivf", dense_ivf)
    dense_gate = REPORT["dense_ivf"]["nblocks_half"]["gate_nprobe"]
    idx.nblocks = max(1, dense_gate // DENSE_SPLIT)
    profile("dense", idx, batches, dense_gate)
    REPORT["k10"] = k10_check(idx, batches[0], max(dense_gate, 2 * DENSE_SPLIT))
    log(f"k10: {json.dumps(REPORT['k10'])}")
    del idx, batches
    torch.cuda.empty_cache()

    def sq8_search():
        REPORT["sq8_search"], store = sq8_search_phase(dev, x, queries, truth)
        return store

    store = counted("sq8_search", sq8_search)
    REPORT["k11"] = k11_check(store, gen, truth)
    log(f"k11: {json.dumps(REPORT['k11'])}")
    del store
    torch.cuda.empty_cache()

    REPORT["sql"] = counted("sql", lambda: sql_phase(dev, x, queries))
    del pool, x, queries
    torch.cuda.empty_cache()

    def hard():
        REPORT["hard"], idx, batches = hard_phase(dev, rng, N)
        return idx, batches

    idx, batches = counted("hard", hard)
    profile("hard", idx, batches, REPORT["hard"]["gate_nprobe"])
    del idx
    torch.cuda.empty_cache()
    REPORT["widths"] = width_check(dev)
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(card)
    REPORT["card"] = card
    OUT.mkdir(exist_ok=True)

    from turdb_tpu_torch.kernels import build

    t = time.perf_counter()
    build.library()
    REPORT["build_kernels_s"] = time.perf_counter() - t
    (OUT / "ptxas.txt").write_text(build.build_log)
    log(f"kernels built in {REPORT['build_kernels_s']:.3f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    launches: dict = {}
    t0 = time.perf_counter()
    try:
        REPORT["k2"] = k2_phase(dev, gen)
        REPORT["k1"] = k1_phase(dev, gen)
        REPORT["k3"] = k3_phase(dev, gen)
        torch.cuda.empty_cache()
        st = synthetic_sq8_store(dev, gen)
        k4 = k4_phase(dev, gen, st)
        REPORT["k5"] = k5_phase(st, k4.pop("cand"))
        REPORT["k4"] = k4
        del st
        for name in ("k1", "k2", "k3", "k4", "k5"):
            log(f"{name}: {json.dumps(REPORT[name])}")
        torch.cuda.empty_cache()
        REPORT["kernel_phase_s"] = time.perf_counter() - t0
        run_paths(dev, launches)
    except SmokeFailure as e:
        REPORT["failure"] = str(e)
        REPORT["launches"] = launches
        (OUT / "chip_smoke_report.json").write_text(json.dumps(REPORT, indent=1))
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    REPORT["launches"] = launches
    REPORT["total_s"] = time.perf_counter() - t0
    (OUT / "chip_smoke_report.json").write_text(json.dumps(REPORT, indent=1))
    for name in ("headline", "sq8", "compact", "hard", "probe_only", "hnsw", "hnsw_insert",
                 "hnsw_wave", "mesh_ivf", "mesh_hnsw", "dense_ivf", "sq8_search", "sql"):
        log(f"{name}: {json.dumps({k: v for k, v in REPORT[name].items() if k != 'build_profile'})}")

    rows = kernel_rows(launches)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
