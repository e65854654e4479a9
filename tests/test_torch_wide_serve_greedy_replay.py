"""K6 wide's staged scorer and rerank and K9 wide's warp rows, replayed on the CPU.

K6 past the fast form's widths (`kernels/csrc/graph_wide.cu` wide_beam,
SCORE_SERVE) stages each expanded node's meta block ([deg] int4) and code
block ([deg, d] int8, one contiguous run of the pack) in the block's shared
memory as soon as warp 0 has chosen the step's nodes: one bulk copy a node's
meta block, and one a node's run of code rows of the first batch. The claims
read the slots' ids from the staged meta; the kept slots are scored from
the stage a batch of `srows` rows at a time (a step's slots, whole nodes, or
rows of one node: `serve_stage`), a lane group a kept slot, by the exact int8
dot and `_approx_dist`'s epilogue. `_serve_scorer` replays that plan inside
the wide loop's replay and must give `_beam_plain`'s buffers, expanded ids
and stats entry for entry; `_serve_stage` replays the sizing rule. The
rerank reads a warp a row (`RR_ROWS` rows of a warp at once, lane l on float4
words l, l + 32, ..., the lanes' sums through `reduce_rows`): its distances
stay within DOT_RTOL of `hnsw_serve_beam_plain`'s, ids apart only there.

K9 past DIM_MAX (`greedy_wide_kernel`) walks a query in a block: warp w
reads the neighbour rows w, w + 8, ... two at once, lane l words l, l + 32,
... (float4, or 16 / 8 codes of SQ8 / SQ16 dequantized by one fmaf), the
sums by `reduce_rows`; the argmin goes through shared memory, the lower
slot on ties. `_k9_replay` walks the levels that way at d = 4,608 and must
give `hnsw_greedy_plain`'s ends, except at ties within DOT_RTOL.
"""

import numpy as np
import pytest
import torch

from test_torch_beam_replay import _f2key, _table_bits
from test_torch_wide_replay import _k8_wide_replay, _mbits
from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops.quantize import sq_rows_encode

torch.set_num_threads(1)

SMEM_OPTIN = 232_448        # an H100's opted-in shared memory a block
WB_WARPS = 8                # graph_wide.cu WB_THREADS / 32
GROUP = 8                   # lanes of a lane group (graph_scorer.cuh)
RR_ROWS = 4                 # rows a warp of K6 wide's rerank reads at once
WG_WARPS, WG_ROWS = 8, 2    # K9 wide: warps a block, rows a warp reads at once
DOT_RTOL = 1e-5             # chip_smoke.py's: fp32 dots summed in another order


def _a16(n):
    return (n + 15) & ~15


def _pow2_ge(n):
    p = 1
    while p < n:
        p <<= 1
    return p


def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64, one rounding of
    the sum there (a double rounding at most half an ulp apart)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _butterfly(s):
    """The xor butterfly over the last axis (32 lanes): every lane's sum."""
    s = s.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[..., np.arange(32) ^ o]).astype(np.float32)
    return s


def _reduce_rows(v):
    """row_sums.cuh reduce_rows over [32 lanes, R rows] of partial sums:
    lane l ends with the sum of row l >> (5 - log2 R)."""
    v = v.astype(np.float32).copy()
    r = v.shape[1]
    log = r.bit_length() - 1
    lanes = np.arange(32)
    for s in range(log):
        n, o = r >> s, 16 >> s
        upper = (lanes & o) != 0
        for i in range(n // 2):
            lo, hi = v[:, i].copy(), v[:, i + n // 2].copy()
            send = np.where(upper, lo, hi)
            keep = np.where(upper, hi, lo)
            v[:, i] = (keep + send[lanes ^ o]).astype(np.float32)
    s = v[:, 0]
    o = 16 >> log
    while o > 0:
        s = (s + s[lanes ^ o]).astype(np.float32)
        o >>= 1
    return s


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_reduce_rows_is_the_plain_butterfly(rows):
    """K6 wide's rerank (4 rows a warp) and K9 wide (2 rows) sum through
    reduce_rows: each lane's row sum equals the plain xor butterfly of that
    row (warp_dot's order) bit for bit."""
    rng = np.random.default_rng(rows)
    for _ in range(20):
        v = (rng.standard_normal((32, rows)) * 10.0 ** rng.integers(-3, 4, (32, rows)))
        v = v.astype(np.float32)
        got = _reduce_rows(v)
        plain = _butterfly(v.T)[:, 0]
        shift = 5 - (rows.bit_length() - 1)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      plain[np.arange(32) >> shift].view(np.uint32))


# ---------------------------------------------------------------------------
# K6 wide: the stage's sizing

def _wide_beam_bytes(deg, ef, iters, expand, rerank):
    """graph_wide.cu wide_beam_bytes at k_res 0 with K6's rerank keys."""
    loops = -(-iters // expand)
    exp_cap, slots = loops * expand, expand * deg
    mbits = _mbits(ef, exp_cap, min(slots, ef))
    words = ((1 << mbits) + (2 << _table_bits(slots)) + 3 * ef + 6 * slots + expand + exp_cap
             + 8)
    return _a16(8 * (2 * slots + _pow2_ge(rerank)) + 4 * words)


def _serve_stage(deg, ef, iters, expand, rerank, d):
    """graph_wide.cu serve_stage: (state in the global scratch, code rows a
    batch, shared bytes of the launch)."""
    slots = expand * deg
    state = _wide_beam_bytes(deg, ef, iters, expand, rerank)
    fixed = 32 + _a16(d) + 16 * slots
    glob = state + fixed + deg * d > SMEM_OPTIN
    used = (0 if glob else state) + fixed
    rows = min(slots, max(0, (SMEM_OPTIN - used) // d))
    if deg <= rows < slots:
        rows -= rows % deg
    return glob, rows, used + rows * d


def test_k6_stage_sizing():
    """The SQL LIMIT 200 serve call (deg 32, ef 1,600, iters 2,400, the
    rerank of all 1,600, 384-d): the 85,168-byte state, the stage's fixed
    2,464 bytes and all 128 slots' code rows (4 nodes) in one block's
    shared memory; wider rows leave room for fewer whole nodes a batch
    (2 of 4 at 2,048-d, ef 1,100), a larger state moves to the global
    scratch first (ef 3,500), and past one node's block (8,192-d) the
    stage takes rows of one node."""
    assert _wide_beam_bytes(32, 1600, 2400, 4, 1600) == 85_168
    assert _serve_stage(32, 1600, 2400, 4, 1600, 384) == (False, 128, 85_168 + 2_464 + 128 * 384)
    assert _serve_stage(32, 1100, 1650, 4, 1100, 2048)[:2] == (False, 64)
    assert _serve_stage(32, 3000, 4500, 4, 3000, 768)[:2] == (False, 64)
    assert _serve_stage(32, 3500, 5250, 4, 3500, 384)[:2] == (True, 128)
    assert _serve_stage(32, 1500, 2250, 4, 1500, 4608)[:2] == (True, 32)
    assert _serve_stage(32, 1600, 2400, 4, 1600, 8192)[:2] == (True, 27)
    for deg, ef, d in ((32, 1500, 32), (16, 1500, 8192), (32, 2500, 1024), (32, 5600, 4096),
                       (64, 1200, 384), (32, 1100, 4100)):
        glob, rows, smem = _serve_stage(deg, ef, ef * 3 // 2, 4, ef, d)
        assert 1 <= rows <= 4 * deg and smem <= SMEM_OPTIN
        assert rows == 4 * deg or rows % deg == 0 or (glob and rows < deg)
        # the state leaves shared memory only where a node's block would not fit beside it
        state = _wide_beam_bytes(deg, ef, ef * 3 // 2, 4, ef)
        assert glob == (state + 32 + _a16(d) + 64 * deg + deg * d > SMEM_OPTIN)


# ---------------------------------------------------------------------------
# K6 wide: the staged beam

def _pack(rng, n, deg, d, metric):
    """A serving pack: node i's list of deg neighbour ids (distinct lists,
    none all -1), and for each slot the neighbour's int8 code row and its
    meta (base, scale, norm bits, id): one row and meta a neighbour id."""
    while True:
        ids = rng.integers(0, n, (n, deg))
        ids[rng.random((n, deg)) < 0.1] = -1
        ids[:, 0] = np.where(ids[:, 0] < 0, rng.integers(0, n, n), ids[:, 0])
        if len({tuple(r) for r in ids}) == n:
            break
    rows = rng.integers(-127, 128, (n, d)).astype(np.int8)
    base = (0.01 * rng.standard_normal(n)).astype(np.float32)
    scale = (0.001 + 0.01 * rng.random(n)).astype(np.float32)
    norm = (1.0 + 4.0 * rng.random(n)).astype(np.float32) if metric == 0 else np.ones(n, np.float32)
    safe = np.maximum(ids, 0)
    codes = np.where(ids[..., None] >= 0, rows[safe], 0).astype(np.int8)
    meta = np.stack([base[safe].view(np.int32), scale[safe].view(np.int32),
                     norm[safe].view(np.int32), ids], -1).astype(np.int32)
    meta[ids < 0, :3] = 0
    return ids.astype(np.int32), codes, meta


def _queries(rng, b, d, n):
    qc = rng.integers(-127, 128, (b, d)).astype(np.int8)
    qs = (0.001 + 0.01 * rng.random(b)).astype(np.float32)
    qsum = rng.standard_normal(b).astype(np.float32)
    qn = (1.0 + 4.0 * rng.random(b)).astype(np.float32)
    seed_i = np.stack([rng.choice(n, 4, replace=False) for _ in range(b)]).astype(np.int32)
    seed_d = (20.0 * rng.random((b, 4))).astype(np.float32)
    return qc, qs, qsum, qn, seed_i, seed_d


def _epilogue(dot, m, qs, qsum, qn, metric):
    """BeamServe::finish in float32, op by op (no contraction)."""
    f = m[:3].view(np.float32)
    qdx = np.float32(np.float32(f[0] * qsum) + np.float32(f[1] * np.float32(qs * np.float32(dot))))
    if metric == 0:
        return np.float32(np.float32(qn - np.float32(2.0 * qdx)) + f[2])
    return np.float32(1.0 - qdx) if metric == 1 else np.float32(-qdx)


def _group_dot(row, qrow):
    """A lane group's exact int8 dot: lane `sub` on 16-byte words sub, sub +
    8, ... (4-byte words where d % 16 != 0), four (one) __dp4a a word, then
    the group's sum; every word read by one lane."""
    d = len(row)
    wb = 16 if d % 16 == 0 else 4
    seen = np.zeros(d // wb, int)
    sums = []
    for sub in range(GROUP):
        acc = 0
        for j in range(sub, d // wb, GROUP):
            seen[j] += 1
            acc += int(row[j * wb:(j + 1) * wb].astype(np.int64) @ qrow[j * wb:(j + 1) * wb])
        sums.append(acc)
    assert (seen == 1).all()
    return sum(sums)


def _serve_scorer(ids_of, codes, meta, qc, qs, qsum, qn, srows, metric, log):
    """wide_beam's SCORE_SERVE step over numpy: the step's nodes (found by
    their lists: every list is distinct), their meta blocks staged at slot
    t = e * deg + g, the slots' ids read from there, the code rows of
    [r0, r1) a batch of srows (one copy a node's run, as bulk copies of
    16-byte multiples where d % 16 == 0), each kept slot scored once from
    its staged row."""
    n, deg, d = codes.shape
    node_of = {tuple(r): i for i, r in enumerate(ids_of)}
    bulk = d % 16 == 0

    def score(b, kept, ids):
        expand = len(ids) // deg
        sel = [node_of.get(tuple(ids[e * deg:(e + 1) * deg]), -1) for e in range(expand)]
        found = sum(s >= 0 for s in sel)
        assert all(s >= 0 for s in sel[:found]) and all(s < 0 for s in sel[found:])
        smeta = np.zeros((expand * deg, 4), np.int32)
        for e in range(found):                       # one bulk copy a node's meta block
            smeta[e * deg:(e + 1) * deg] = meta[sel[e]]
        for t in range(found * deg):                 # the claims read the staged ids
            assert smeta[t, 3] == ids[t]
        out = {}
        live = found * deg
        for r0 in range(0, live, srows):
            r1 = min(live, r0 + srows)
            stage = np.zeros(srows * d, np.int8)
            written = np.zeros(srows * d, int)
            expect = 0
            for e in range(r0 // deg, -(-r1 // deg)):
                lo, hi = max(r0, e * deg), min(r1, (e + 1) * deg)
                src = (sel[e] * deg + lo - e * deg) * d
                dst, size = (lo - r0) * d, (hi - lo) * d
                if bulk:
                    assert src % 16 == 0 and dst % 16 == 0 and size % 16 == 0
                stage[dst:dst + size] = codes.reshape(-1)[src:src + size]
                written[dst:dst + size] += 1
                expect += size
            assert expect == (r1 - r0) * d           # the mbarrier's expected bytes
            assert (written[:expect] == 1).all() and not written[expect:].any()
            for t in kept:
                if r0 <= t < r1:
                    row = stage[(t - r0) * d:(t - r0 + 1) * d]
                    np.testing.assert_array_equal(row, codes[sel[t // deg], t % deg])
                    dot = _group_dot(row, qc[b].astype(np.int64))
                    assert t not in out
                    out[t] = _epilogue(dot, smeta[t], qs[b], qsum[b], qn[b], metric)
            log.append(r1 - r0)
        assert sorted(out) == sorted(kept)
        return out
    return score


def _serve_plain_beam(codes, meta, qc, qs, qsum, qn, seed_i, seed_d, *, ef, loops, expand,
                      metric):
    """`_beam_plain` with hnsw_serve_beam_plain's neighbour scorer."""
    deg = codes.shape[1]
    codes_t, meta_t = torch.from_numpy(codes), torch.from_numpy(meta)
    qc_t, qs_t, qsum_t, qn_t = (torch.from_numpy(v) for v in (qc, qs, qsum, qn))
    b = qc.shape[0]

    def neighbours(sel_i):
        safe = sel_i.clamp_min(0).long()
        m = meta_t[safe]
        f = m.view(torch.float32)
        doti = kernels._int8_dots(qc_t, codes_t[safe])
        nd = kernels.sq8_epilogue(doti, f[..., 0], f[..., 1], qn_t[:, None, None],
                                  qsum_t[:, None, None], qs_t[:, None, None], f[..., 2], metric)
        return m[..., 3].reshape(b, -1), nd.reshape(b, -1)

    si, sd = torch.from_numpy(seed_i), torch.from_numpy(seed_d)
    cand_i, cand_d = kernels._beam_init(si, sd, ef)
    return kernels._beam_plain(cand_i, cand_d, (si < 0).all(1), loops, expand, deg, neighbours,
                               exp_cap=loops * expand)


@pytest.mark.parametrize("d, srows", [(48, 32), (48, 16), (48, 8), (48, 5), (36, 16), (36, 5)])
def test_k6_staged_beam_equals_the_plain_beam(d, srows):
    """The wide loop with K6's stage gives `_beam_plain`'s buffers, expanded
    ids and stats over a serving pack, every kept slot scored once from its
    staged row: a whole step a batch (4 nodes of 8), 2 nodes, 1 node, 5
    rows of a node (the batch crosses nodes), and rows of 36 bytes (4-byte
    copies)."""
    rng = np.random.default_rng(d + srows)
    n, deg, b = 300, 8, 3
    ef, expand, loops = 24, 4, 12
    ids, codes, meta = _pack(rng, n, deg, d, 0)
    qc, qs, qsum, qn, seed_i, seed_d = _queries(rng, b, d, n)
    log = []
    scorer = _serve_scorer(ids, codes, meta, qc, qs, qsum, qn, srows, 0, log)
    got = _k8_wide_replay(ids, np.zeros((b, n), np.float32), seed_i, seed_d, ef=ef, loops=loops,
                          expand=expand, seed=4, scorer=scorer)
    want = _serve_plain_beam(codes, meta, qc, qs, qsum, qn, seed_i, seed_d, ef=ef, loops=loops,
                             expand=expand, metric=0)
    for name, g, w in zip(("cand_d", "cand_i", "exp_ids", "stats"),
                          (got[0], got[1], got[4], got[5]),
                          (want[1], want[0], want[4], want[5])):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert max(log) <= srows
    if srows < expand * deg:
        assert max(log) == srows                     # a step took several batches


def _rerank_replay(cand_i, vectors, norms, q, qn, allowed, r, k, metric):
    """serve_beam_wide_kernel's rerank over numpy: the r best a warp a row
    (lane l on float4 words l, l + 32, ... in one fmaf chain, the lanes'
    sums by the butterfly), +inf outside `allowed` or at -1, then the k
    smallest by (distance, position), -1 where +inf."""
    b = cand_i.shape[0]
    d = vectors.shape[1]
    out_d = np.zeros((b, k), np.float32)
    out_i = np.zeros((b, k), np.int32)
    words = d // 4
    for bi in range(b):
        ids = cand_i[bi, :r]
        live = (ids >= 0) & (allowed[np.maximum(ids, 0)] if allowed is not None else True)
        x = vectors[np.maximum(ids, 0)]                     # [r, d]
        acc = np.zeros((r, 32), np.float32)
        for i in range(-(-words // 32)):
            c = np.arange(32) + 32 * i
            ok = c < words
            for e in range(4):
                col = np.minimum(4 * c + e, d - 1)
                acc = np.where(ok, _fma(x[:, col], q[bi, col], acc), acc)
        dot = _butterfly(acc)[:, 0]
        if metric == 0:
            v = (np.float32(qn[bi]) + norms[np.maximum(ids, 0)]).astype(np.float32) - \
                (np.float32(2.0) * dot).astype(np.float32)
        else:
            v = np.float32(1.0) - dot if metric == 1 else -dot
        v = np.where(live, v.astype(np.float32), np.float32(np.inf))
        order = sorted(range(r), key=lambda j: (_f2key(v[j]), j))[:k]
        out_d[bi] = v[order]
        out_i[bi] = np.where(np.isinf(v[order]), -1, ids[order])
    return out_d, out_i


@pytest.mark.parametrize("metric, filtered", [(0, False), (0, True), (1, False), (2, True)])
def test_k6_rerank_order_stays_within_the_tolerance(metric, filtered):
    """The staged beam, then the rerank's warp rows: distances within
    DOT_RTOL of their scale of `hnsw_serve_beam_plain`'s (fp32 dots summed
    in warp_dot's order), ids apart only inside that band, +inf and -1
    where the plain version has them, the beam's work equal."""
    rng = np.random.default_rng(17 + metric + 3 * filtered)
    n, deg, d, b = 300, 8, 64, 3
    ef, expand, loops, rerank, k = 24, 4, 12, 20, 12
    ids, codes, meta = _pack(rng, n, deg, d, metric)
    qc, qs, qsum, qn, seed_i, seed_d = _queries(rng, b, d, n)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    norms = (vectors * vectors).sum(1).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    allowed = rng.random(n) < 0.6 if filtered else None
    scorer = _serve_scorer(ids, codes, meta, qc, qs, qsum, qn, expand * deg, metric, [])
    got = _k8_wide_replay(ids, np.zeros((b, n), np.float32), seed_i, seed_d, ef=ef, loops=loops,
                          expand=expand, seed=9, scorer=scorer)
    kd, ki = _rerank_replay(got[1], vectors, norms, q, qn, allowed, rerank, k, metric)
    t = torch.from_numpy
    pd, pi, ps = kernels.hnsw_serve_beam_plain(
        t(codes), t(meta), t(vectors), t(norms), t(q), t(qn), t(qc), t(qs), t(qsum), t(seed_i),
        t(seed_d), None if allowed is None else t(allowed), ef=ef, iters=loops * expand,
        expand=expand, rerank=rerank, k=k, metric=metric)
    np.testing.assert_array_equal(got[5], ps.numpy())
    pd, pi = pd.numpy(), pi.numpy()
    fin = np.isfinite(pd)
    np.testing.assert_array_equal(fin, np.isfinite(kd))
    np.testing.assert_array_equal(pi[~fin], ki[~fin])
    scale = max(float(np.abs(pd[fin]).max()), 1.0)
    diff = np.abs(np.where(fin, kd, 0) - np.where(fin, pd, 0))
    assert diff.max() <= DOT_RTOL * scale
    assert ((ki == pi) | (diff <= DOT_RTOL * scale) | ~fin).all()
    assert fin.sum() > b                       # the check saw rows


# ---------------------------------------------------------------------------
# K9 wide: a block a query, a warp a row

def _k9_slots(deg):
    """Slots each warp reads (warp w: g0 = w, w + 16, ...; rows g0 and g0 + 8)."""
    out = {w: [] for w in range(WG_WARPS)}
    for w in range(WG_WARPS):
        for g0 in range(w, deg, WG_WARPS * WG_ROWS):
            out[w] += [g0 + e * WG_WARPS for e in range(WG_ROWS) if g0 + e * WG_WARPS < deg]
    return out


@pytest.mark.parametrize("deg", [16, 32, 20, 5])
def test_k9_wide_warps_read_each_slot_once(deg):
    slots = [g for gs in _k9_slots(deg).values() for g in gs]
    assert sorted(slots) == list(range(deg))


def _k9_dists(rows, store, norms, q, qn, ids):
    """The distances K9 wide gives neighbours `ids` (>= 0) of one step:
    each row's lane words (float4, 16 u8 or 8 u16 codes), one fmaf chain a
    lane (the codes dequantized as fmaf(scale, code, min) first), the
    butterfly, gathered_distances' L2 epilogue (clamped at 0)."""
    if store == "f32":
        x, per = rows[ids].astype(np.float32), 4
    else:
        x, per = rows.codes[ids].numpy().astype(np.int64) & 0xFFFF, 16 if store == "sq8" else 8
        x = x.astype(np.float32)
        mins = rows.mins[ids].numpy()[:, None]
        scales = rows.scales[ids].numpy()[:, None]
    d = x.shape[1]
    words = d // per
    acc = np.zeros((len(ids), 32), np.float32)
    for i in range(-(-words // 32)):
        c = np.arange(32) + 32 * i
        ok = c < words
        for e in range(per):
            col = np.minimum(per * c + e, d - 1)
            xv = x[:, col] if store == "f32" else _fma(scales, x[:, col], mins)
            acc = np.where(ok, _fma(xv, q[col], acc), acc)
    dot = _butterfly(acc)[:, 0]
    return np.maximum((np.float32(qn) + norms[ids]).astype(np.float32)
                      - (np.float32(2.0) * dot).astype(np.float32), np.float32(0.0))


def _k9_replay(adjs, rows, store, norms, q, qn, cur_i, cur_d, lowest):
    """greedy_wide_kernel over numpy, a query at a time."""
    out_i, out_d = cur_i.copy(), cur_d.copy()
    stats = np.zeros((len(q), 2), np.int32)
    for b in range(len(q)):
        cur, cd = int(cur_i[b]), np.float32(cur_d[b])
        walk = len(adjs) - min(max(int(lowest[b]), 0), len(adjs))
        for lvl in range(walk):
            for _ in range(kernels.GREEDY_CAP):
                lst = adjs[lvl][max(cur, 0)]
                valid = np.flatnonzero(lst >= 0)
                v = np.full(len(lst), np.inf, np.float32)
                if len(valid):
                    v[valid] = _k9_dists(rows, store, norms, q[b], qn[b], lst[valid])
                # every warp's argmin: the least distance, the lower slot on ties
                g = min(valid, key=lambda s: (v[s], s)) if len(valid) else -1
                stats[b] += (1, len(valid))
                if g < 0 or not v[g] < cd:
                    break
                cur, cd = int(lst[g]), v[g]
        out_i[b], out_d[b] = cur, cd
    return out_i, out_d, stats


@pytest.mark.parametrize("store", ["f32", "sq8", "sq16"])
def test_k9_wide_lane_words_equal_the_plain_chain(store):
    """Three levels of 4,608-d rows in one walk, each query down to its own
    lowest level (some walk none): the replay's ends are
    `hnsw_greedy_plain`'s but where the two distances tie within DOT_RTOL
    of their scale, and its work (lists read, neighbours scored) is the
    plain version's wherever the ends are."""
    rng = np.random.default_rng({"f32": 1, "sq8": 2, "sq16": 3}[store])
    n, d, deg, nq, levels = 240, 4608, 16, 16, 3
    centers = rng.standard_normal((6, d)).astype(np.float32)
    x = (centers[rng.integers(0, 6, n)] + 0.6 * rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)] + 0.6 * rng.standard_normal((nq, d))).astype(np.float32)
    adjs = []
    for _ in range(levels):
        a = rng.integers(0, n, (n, deg)).astype(np.int32)
        a[rng.random((n, deg)) < 0.1] = -1
        adjs.append(a)
    lowest = rng.integers(0, levels + 1, nq).astype(np.int32)
    lowest[:4] = 0
    xt = torch.from_numpy(x)
    rows = x if store == "f32" else sq_rows_encode(xt, 8 if store == "sq8" else 16)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    qn = (q.astype(np.float64) ** 2).sum(1).astype(np.float32)
    cur_i = rng.integers(0, n, nq).astype(np.int32)
    cur_d = np.full(nq, np.inf, np.float32)
    pi, pd, ps = kernels.hnsw_greedy_plain(
        [torch.from_numpy(a) for a in adjs], xt if store == "f32" else rows,
        torch.from_numpy(norms),
        torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(cur_i),
        torch.from_numpy(cur_d), metric=0, lowest=torch.from_numpy(lowest))
    ki, kd, ks = _k9_replay(adjs, rows, store, norms, q, qn, cur_i, cur_d, lowest)
    pi, pd, ps = pi.numpy(), pd.numpy(), ps.numpy()
    assert (lowest >= levels).any() and (ps[:, 0] > 0).any()
    fin = np.isfinite(pd)
    np.testing.assert_array_equal(fin, np.isfinite(kd))
    scale = max(float(np.abs(pd[fin]).max()), 1.0)
    same = ki == pi
    np.testing.assert_array_equal(ks[same], ps[same])
    assert (np.abs(kd[fin] - pd[fin]) <= DOT_RTOL * scale).all()
    assert same.mean() >= 0.9
