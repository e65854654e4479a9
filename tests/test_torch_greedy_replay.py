"""K9's descent through several levels, and the staged rows of K8-SQ and
K9, on the CPU.

- `hnsw_greedy` given a list of levels (its plain version here) against the
  reference's `_greedy_level` (jitted, on the CPU) chained level by level,
  each query stopping at its own lowest level, for L2 / COSINE / IP over
  f32 rows and the SQ8 / SQ16 store: ends equal on >= 99 %, and where they
  differ the two distances tie within `assert_knn_match`'s tolerance (fp32
  dots summed in another order); and against the port's own one-level walk
  chained the same way, exactly (ends and work);
- the staging of graph_scorer.cuh (`stage_rows`, `staged_dot`) replayed in
  numpy: which lane copies which word of which row to which offset of the
  warp's region, that the region then holds the rows, that lane r reads
  row r's codes in the order 0 .. d-1, and that the 8 lanes of each phase
  of a 16-byte shared load fall on the 32 banks once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turdb_tpu.models import hnsw as jh
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops.quantize import sq_rows_encode

torch.set_num_threads(1)

N, DIM, NQ, DEG, LEVELS = 1500, 32, 96, 8, 3
METRICS = (0, 1, 2)   # L2, COSINE, IP
STORES = ("f32", "sq8", "sq16")

_ref_greedy = jax.jit(jh._greedy_level, static_argnames=("metric",))


@pytest.fixture(scope="module")
def graph():
    """Clustered rows and LEVELS upper levels (level l holds the rows whose
    level is >= l + 1, as in a graph's adj_hi): each member's DEG - 2
    nearest members and 2 random ones, a few -1."""
    rng = np.random.default_rng(77)
    centers = rng.standard_normal((24, DIM)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, 24, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.7 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    lvl = np.minimum(rng.geometric(0.45, N) - 1, LEVELS)
    lvl[0] = LEVELS                      # the entry holds every level
    adjs = []
    for l in range(1, LEVELS + 1):
        members = np.flatnonzero(lvl >= l)
        sub = x[members]
        d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = min(DEG - 2, len(members) - 1)
        near = members[np.argsort(d2, axis=1, kind="stable")[:, :k]]
        rand = members[rng.integers(0, len(members), (len(members), DEG - k))]
        rows = np.concatenate([near, rand], 1).astype(np.int32)
        rows[rng.random(rows.shape) < 0.03] = -1
        adj = np.full((N, DEG), -1, np.int32)
        adj[members] = rows
        adjs.append(adj)
    # walked top first; a query's lowest level in LEVELS-1 .. 0 numbering,
    # LEVELS and more walks none
    lowest = rng.integers(0, LEVELS + 2, NQ).astype(np.int32)
    lowest[:8] = 0
    return x, q, adjs[::-1], lowest


def _metric_rows(x, q, metric):
    if metric == 1:
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, q = x.astype(np.float32), q.astype(np.float32)
    return x, (x * x).sum(1).astype(np.float32), q, (q * q).sum(1).astype(np.float32)


def _stores(x, store):
    """(the port's rows, the reference's) of one store."""
    xt = torch.from_numpy(x)
    if store == "f32":
        return xt, jnp.asarray(x)
    rows = sq_rows_encode(xt, 8 if store == "sq8" else 16)
    codes = rows.codes.numpy()
    codes = codes if store == "sq8" else (codes.astype(np.int64) & 0xFFFF).astype(np.uint16)
    return rows, jh.Sq8Rows(jnp.asarray(codes), jnp.asarray(rows.mins.numpy()),
                            jnp.asarray(rows.scales.numpy()))


def _starts(x, xn, q, qn, metric, n):
    cur = np.zeros(n, np.int32)
    cur[1::5] = -1                       # row 0's list against +inf
    dots = q @ x[0]
    d = (np.maximum(qn + xn[0] - 2 * dots, 0) if metric == 0
         else 1 - dots if metric == 1 else -dots).astype(np.float32)
    return cur, np.where(cur >= 0, d, np.inf).astype(np.float32)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("metric", METRICS, ids=("L2", "COSINE", "IP"))
def test_multi_level_descent_matches_reference_chain(graph, metric, store):
    x0, q0, adjs, lowest = graph
    x, xn, q, qn = _metric_rows(x0, q0, metric)
    rows, ref_rows = _stores(x, store)
    cur, cur_d = _starts(x, xn, q, qn, metric, NQ)
    want_i, want_d = jnp.asarray(cur), jnp.asarray(cur_d)
    for j, adj in enumerate(adjs):
        ni, nd = _ref_greedy(jnp.asarray(adj), ref_rows, jnp.asarray(xn), jnp.asarray(q),
                             jnp.asarray(qn), want_i, want_d, metric=JaxMetric(metric))
        walks = jnp.asarray(lowest <= len(adjs) - 1 - j)
        want_i, want_d = jnp.where(walks, ni, want_i), jnp.where(walks, nd, want_d)
    got_i, got_d, _ = kernels.hnsw_greedy(
        [torch.from_numpy(a) for a in adjs], rows, torch.from_numpy(xn), torch.from_numpy(q),
        torch.from_numpy(qn), torch.from_numpy(cur), torch.from_numpy(cur_d), metric=metric,
        lowest=torch.from_numpy(lowest))
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    got_i, got_d = got_i.numpy(), got_d.numpy()
    diff = want_i != got_i
    assert diff.mean() <= 0.01, diff.mean()
    assert np.all(np.abs(want_d[diff] - got_d[diff]) <= 1e-3 + 1e-4 * np.abs(want_d[diff]))
    np.testing.assert_allclose(got_d[~diff], want_d[~diff], rtol=1e-4, atol=1e-3)
    # the rows that walk no level pass their starts through
    none = lowest >= len(adjs)
    np.testing.assert_array_equal(got_i[none], cur[none])


@pytest.mark.parametrize("store", STORES)
def test_multi_level_descent_is_the_one_level_chain(graph, store):
    """The ends and the work of one call through every level equal the
    one-level calls chained, row by row, exactly; with no `lowest`, every
    row walks every level."""
    x0, q0, adjs, lowest = graph
    x, xn, q, qn = (torch.from_numpy(a) for a in _metric_rows(x0, q0, 0))
    rows, _ = _stores(x.numpy(), store)
    cur, cur_d = (torch.from_numpy(a) for a in _starts(*(a.numpy() for a in (x, xn, q, qn)),
                                                        0, NQ))
    levels = [torch.from_numpy(a) for a in adjs]
    for low in (torch.from_numpy(lowest), None):
        ci, cd = cur.clone(), cur_d.clone()
        work = torch.zeros((NQ, 2), dtype=torch.int32)
        for j, adj in enumerate(levels):
            walks = (torch.ones(NQ, dtype=torch.bool) if low is None
                     else low <= len(levels) - 1 - j)
            ni, nd, nw = kernels.hnsw_greedy(adj, rows, xn, q, qn, ci, cd, metric=0)
            ci, cd = torch.where(walks, ni, ci), torch.where(walks, nd, cd)
            work += torch.where(walks[:, None], nw, 0)
        gi, gd, gw = kernels.hnsw_greedy(levels, rows, xn, q, qn, cur, cur_d, metric=0,
                                         lowest=low)
        assert torch.equal(gi, ci) and torch.equal(gd, cd) and torch.equal(gw, work)
        if low is not None:
            assert bool((gw[low >= len(levels)] == 0).all())


def test_greedy_levels_past_the_cap_raise(graph):
    x, _, adjs, _ = graph
    xt = torch.from_numpy(x)
    n = (xt * xt).sum(1)
    cur = torch.zeros(4, dtype=torch.int32)
    adj = torch.from_numpy(adjs[0])
    with pytest.raises(ValueError):
        kernels.hnsw_greedy([adj] * (kernels.GREEDY_LEVELS_MAX + 1), xt, n, xt[:4], n[:4], cur,
                            n[:4], metric=0)
    with pytest.raises(ValueError):
        kernels.hnsw_greedy([], xt, n, xt[:4], n[:4], cur, n[:4], metric=0)


# ---------------------------------------------------------------------------
# the staged rows (graph_scorer.cuh)
# ---------------------------------------------------------------------------

CODE_BYTES = {"f32": 4, "sq8": 1, "sq16": 2}


def _stage_words(row_bytes):
    return ((row_bytes + 15) >> 4) | 1


def _stage_copies(ids, d, store, wide):
    """stage_rows: for each copy, (lane, step, row, source byte, staged
    byte, bytes), in the order the lanes issue them."""
    rb = d * CODE_BYTES[store]
    sw = _stage_words(rb)
    wb = 16 if wide else 4
    rw = rb // wb
    total = len(ids) * rw
    out = []
    for step, e0 in enumerate(range(0, total, 32)):
        for lane in range(32):
            e = e0 + lane
            if e >= total:
                continue
            r = e >> (rw - 1).bit_count() if rw & (rw - 1) == 0 else e // rw
            if ids[r] < 0:
                continue
            w = e - r * rw
            out.append((lane, step, r, ids[r] * rb + w * wb, r * sw * 16 + w * wb, wb))
    return out


def _read_order(d, store):
    """staged_dot: the staged bytes lane r reads, load by load, and the
    codes (element indices) each load feeds to the chain, in order."""
    loads = []
    if store == "f32":
        loads = [(16 * j, 16, [4 * j + i for i in range(4)]) for j in range(d // 4)]
    elif store == "sq8":
        c = d // 16
        loads = [(16 * w, 16, [16 * w + i for i in range(16)]) for w in range(c)]
        loads += [(4 * j, 4, [4 * j + i for i in range(4)]) for j in range(4 * c, d // 4)]
    else:
        c = d // 8
        loads = [(16 * w, 16, [8 * w + i for i in range(8)]) for w in range(c)]
        loads += [(8 * j, 8, [4 * j + i for i in range(4)]) for j in range(2 * c, d // 4)]
    return loads


@pytest.mark.parametrize("d", (32, 64, 128, 36, 68, 200))
@pytest.mark.parametrize("store", STORES)
def test_staged_rows_replay(store, d):
    rng = np.random.default_rng(d)
    cap = 300
    itemsize = CODE_BYTES[store]
    rb = d * itemsize
    src = rng.integers(0, 256, cap * rb, dtype=np.uint8)     # the store's bytes
    # the launch's rule: 16-byte copies where rows are whole 16-byte words
    wide = store == "f32" or rb % 16 == 0
    sw = _stage_words(rb)
    assert sw % 2 == 1 and 16 * sw >= rb
    for n in (32, 16, 5):
        ids = rng.integers(0, cap, n)
        ids[rng.random(n) < 0.2] = -1
        stage = np.zeros(32 * sw * 16, np.uint8)
        copies = _stage_copies(ids, d, store, wide)
        # neighbouring lanes copy neighbouring words: within a step, lane
        # l + 1 copies the word after lane l's (or the next row's first)
        by_step = {}
        for lane, step, r, s, t, wb in copies:
            assert s % wb == 0 and t % wb == 0          # aligned copies
            by_step.setdefault(step, []).append((lane, r, t))
            stage[t:t + wb] = src[s:s + wb]
        for items in by_step.values():
            for (l0, r0, t0), (l1, r1, t1) in zip(items, items[1:]):
                if l1 == l0 + 1 and r1 == r0:
                    assert t1 == t0 + (16 if wide else 4)
        # each staged row holds its source row; no copy lands past its row
        for r, i in enumerate(ids):
            if i >= 0:
                np.testing.assert_array_equal(stage[r * sw * 16:r * sw * 16 + rb],
                                              src[i * rb:(i + 1) * rb])
        assert all(t + wb <= r * sw * 16 + rb for _, _, r, _, t, wb in copies)
        # lane r reads row r's elements in order 0 .. d-1, inside its row
        loads = _read_order(d, store)
        fed = [e for _, _, elems in loads for e in elems]
        assert fed == list(range(d))
        assert all(off + size <= rb for off, size, _ in loads)
        # a 16-byte shared load: each phase of 8 lanes (rows 8p .. 8p + 7 at
        # one offset) covers the 32 banks once
        for off, size, _ in loads:
            if size != 16:
                continue
            for p in range(4):
                banks = [(((8 * p + k) * sw * 16 + off) // 4 + i) % 32
                         for k in range(8) for i in range(4)]
                assert sorted(banks) == list(range(32)), (off, p)


def test_stage_words_pads_rows_that_would_share_banks():
    """A 128-byte (SQ8 at d = 128), 256-byte (SQ16) or 512-byte (f32) row
    stride puts the 8 lanes of a phase on 4 banks; the odd word counts 9,
    17 and 33 spread them."""
    for rb, want in ((128, 9), (256, 17), (512, 33), (48, 3), (64, 5)):
        assert _stage_words(rb) == want
        starts = {((k * rb) // 4) % 32 for k in range(8)}
        if rb in (128, 256, 512):
            assert len(starts) == 1
