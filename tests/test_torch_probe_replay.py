"""K4's cell-major order on the CPU.

For a probe wider than one chunk of lanes, K4 (`kernels/csrc/ivf_probe.cu`)
groups the (query, probe index) pairs by cell: a histogram of the probed
cells, an exclusive scan, and a scatter whose order inside a cell is
whatever the atomics give. One block a cell then scores the cell's pairs in
tiles of 16 queries (an exact int32 dot, the epilogue rounded as
`sq8_epilogue`; +inf for empty, dead and unallowed lanes and for lanes past
the cell's last live one) and writes each distance to column p*L + lane of
its query's row of a [B, P*L] buffer. K2 selects each row's m best by
(f2key(distance), position), and a tail writes either all m with their
flat positions cell*L + lane (candidate mode) or the first k after later
copies of an id are dropped (top-k mode). `_cell_major_replay` replays
that order in numpy, scatter order shuffled, and must equal
`ivf_probe_sq8_plain` exactly. The wrapper's choice between this order and
the query-major one is a rule on shapes (`probe_route`), tested here too
with the kernel library's answer for one cell-major block stood in for.
"""

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels

torch.set_num_threads(1)

F32 = np.float32
INF = F32(np.inf)
INF_KEY = 0xFF800000
TILE = 16


def _f2key(v: np.ndarray) -> np.ndarray:
    """select.cuh f2key: -0.0 folded into +0.0, then the order-preserving
    flip of the float32 bits."""
    v = np.where(v == 0, F32(0), v).astype(F32)
    u = v.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _distance(dot, mins, scales, pnorm, qs, qsum, qn, metric):
    """ivf_probe.cu sq8_distance, one float32 rounding an operation."""
    qdx = (mins * qsum).astype(F32) + (scales * (qs * dot.astype(F32))).astype(F32)
    if metric == 1:
        return (F32(1) - qdx).astype(F32)
    if metric == 2:
        return (-qdx).astype(F32)
    return ((qn - (F32(2) * qdx)).astype(F32) + pnorm).astype(F32)


def _cell_major_replay(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                       allowed, *, k, m, replicated, mode, metric, rng):
    b, p = cells.shape
    nb, lanes, _ = codes.shape
    pairs = cells.reshape(-1)
    # the histogram, the exclusive scan, the scatter (atomics: any order)
    count = np.bincount(pairs, minlength=nb)
    cursor = np.concatenate([[0], np.cumsum(count)[:-1]])
    order = np.empty(b * p, np.int64)
    for i in rng.permutation(b * p):
        order[cursor[pairs[i]]] = i
        cursor[pairs[i]] += 1
    live = (members >= 0) & alive
    if allowed is not None:
        live &= allowed
    dist = np.full((b, p * lanes), np.nan, F32)       # every column must be written
    for c in np.flatnonzero(count):
        end, beg = cursor[c], cursor[c] - count[c]
        on = np.flatnonzero(live[c])
        ext = on[-1] + 1 if len(on) else 0             # rows past it are not read
        for t0 in range(beg, end, TILE):
            for pair in order[t0:min(t0 + TILE, end)]:
                qb, pp = divmod(int(pair), p)
                dot = codes[c, :ext].astype(np.int64) @ qc[qb].astype(np.int64)
                d = _distance(dot, mins[c, :ext], scales[c, :ext], pnorms[c, :ext], qs[qb],
                              qsum[qb], qn[qb], metric)
                row = np.full(lanes, INF, F32)
                row[:ext] = np.where(live[c, :ext], d, INF)
                dist[qb, pp * lanes:(pp + 1) * lanes] = row
    assert not np.isnan(dist).any()
    # K2: the m best of each row by (key, position)
    key = _f2key(dist)
    pos = np.broadcast_to(np.arange(p * lanes), key.shape)
    sel = np.lexsort((pos, key), axis=-1)[:, :m]
    sel_key = np.take_along_axis(key, sel, 1)
    cell = np.take_along_axis(cells, sel // lanes, 1)
    lane = sel % lanes
    ids = members[cell, lane]
    sel_d = np.take_along_axis(dist, sel, 1)
    if mode == kernels.MODE_CAND:
        return sel_d, ids.astype(np.int32), (cell * lanes + lane).astype(np.int32)
    # the tail: finite, the first copy of an id, the first k of those
    out_d = np.full((b, k), INF, F32)
    out_i = np.full((b, k), -1, np.int32)
    for r in range(b):
        kept = [j for j in range(m) if sel_key[r, j] < INF_KEY
                and not (replicated and ids[r, j] in ids[r, :j])][:k]
        out_d[r, :len(kept)] = sel_d[r, kept]
        out_i[r, :len(kept)] = ids[r, kept]
    return out_d, out_i


def _store(rng, nb, lanes, d, n_ids):
    """A packed int8 store: cells 30-100 % full front to back, ids from a
    small pool so that copies of an id (with its row) meet in one probe,
    pairs of ids with one row, 3 % dead lanes, an allowed mask, a cell all
    dead."""
    members = rng.integers(0, n_ids, (nb, lanes))
    occ = rng.integers(lanes * 3 // 10, lanes + 1, (nb, 1))
    members = np.where(np.arange(lanes)[None, :] < occ, members, -1).astype(np.int32)
    rows = rng.integers(-128, 128, (n_ids, d)).astype(np.int8)
    mins = (rng.standard_normal(n_ids) * 0.1).astype(F32)
    scales = (rng.random(n_ids) * 0.01 + 1e-3).astype(F32)
    norms = (rng.random(n_ids) * 50).astype(F32)
    # every 7th id copies the row before it: exact ties between two ids
    for a in (rows, mins, scales, norms):
        a[1::7] = a[0::7][:len(a[1::7])]
    safe = members.clip(0)
    codes = np.where((members >= 0)[..., None], rows[safe], 0).astype(np.int8)
    mins, scales = mins[safe], scales[safe]
    pnorms = np.where(members >= 0, norms[safe], INF).astype(F32)
    alive = rng.random((nb, lanes)) < 0.97
    alive[5] = False
    allowed = rng.random((nb, lanes)) < 0.6
    return codes, mins, scales, pnorms, members, alive, allowed


def _probe(rng, b, p, nb, lanes, d):
    """Queries and their probed cells: distinct cells, then a block listed
    twice in every third row, a cell every query probes, and cell 0 that
    no query probes."""
    qc = rng.integers(-127, 128, (b, d)).astype(np.int8)
    qs = (rng.random(b) * 0.05 + 0.01).astype(F32)
    qsum = rng.standard_normal(b).astype(F32)
    qn = (rng.random(b) * 40).astype(F32)
    cells = np.stack([rng.choice(np.arange(1, nb), p, replace=False) for _ in range(b)])
    cells[::3, 1] = cells[::3, 0]
    cells[:, -1] = 3
    return qc, qs, qsum, qn, cells.astype(np.int32)


CASES = [  # mode, k, m, replicated, with allowed, metric
    (kernels.MODE_TOPK, 10, 20, True, False, 0),
    (kernels.MODE_TOPK, 10, 10, False, True, 0),
    (kernels.MODE_CAND, 40, 40, True, True, 0),
    (kernels.MODE_CAND, 40, 40, False, False, 0),
    (kernels.MODE_TOPK, 32, 32, False, False, 1),
    (kernels.MODE_TOPK, 12, 30, True, True, 2),
]


@pytest.mark.parametrize("mode, k, m, replicated, with_allowed, metric", CASES)
def test_cell_major_replay_equals_plain(mode, k, m, replicated, with_allowed, metric):
    """P*L = 41 * 104 = 4264 lanes, past one chunk and no multiple of it."""
    rng = np.random.default_rng(20 + metric + 3 * mode + 7 * replicated)
    b, p, nb, lanes, d = 40, 41, 64, 104, 32
    store = _store(rng, nb, lanes, d, 300)
    codes, mins, scales, pnorms, members, alive, allowed = store
    qc, qs, qsum, qn, cells = _probe(rng, b, p, nb, lanes, d)
    allow = allowed if with_allowed else None
    count = np.bincount(cells.reshape(-1), minlength=nb)
    assert count[3] >= b > TILE and count[0] == 0      # many tiles; a cell no one probes
    assert p * lanes % kernels.PROBE_CHUNK_LANES != 0
    assert kernels.probe_route(p, lanes, d, fits=lambda lcap, d, device: True) == "cell"
    kw = dict(k=k, m=m, replicated=replicated, mode=mode, metric=metric)
    got = _cell_major_replay(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members,
                             alive, allow, rng=rng, **kw)
    t = torch.from_numpy
    want = kernels.ivf_probe_sq8(t(qc), t(qs), t(qsum), t(qn), t(cells), t(codes), t(mins),
                                 t(scales), t(pnorms), t(members), t(alive),
                                 None if allow is None else t(allow), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(t(np.ascontiguousarray(g)), w)


@pytest.mark.parametrize("p, lanes, d, fits, route", [
    (8, 128, 128, True, "query"),     # the sq8 headline: one block a query
    (32, 128, 128, True, "query"),    # exactly one chunk
    (33, 128, 128, True, "cell"),
    (256, 128, 128, True, "cell"),    # the hard row
    (64, 128, 100, False, "query"),   # rows not in 16-byte words
    (64, 128, 48, True, "cell"),
    (2, 4096, 128, False, "query"),   # a cell past one block's shared memory
    (2, 2304, 16, True, "cell"),      # a wide cell that still fits
])
def test_probe_route_is_a_rule_on_shapes(p, lanes, d, fits, route):
    """Past one chunk of lanes the library's rule for one cell-major block
    decides (asked with the cell's shape and the device); within one chunk
    it is not asked."""
    asked = []

    def library(lcap, width, device):
        asked.append((lcap, width, device))
        return fits

    assert kernels.probe_route(p, lanes, d, "dev", fits=library) == route
    assert asked == ([(lanes, d, "dev")] if p * lanes > kernels.PROBE_CHUNK_LANES else [])
