"""K12 `cell_select` (the IVF cell selection in one launch) on the CPU.

- `cell_select_plan`'s rule: which shapes take K12, with which query tile
  and segments, and which keep the GEMM + K2 pair; `cell_select_fused` on
  a CUDA device (its SM count given) and on the CPU;
- a replay of K12's selection in numpy (csrc/cell_select.cu): each tile's
  distances against the threshold it starts with (the segment's first
  tile's from its threads' two least distances each; NaN where the tile
  has fewer than P finite ones), all passes into the buffer where
  they fit, else 16 columns at a time in ascending order, compaction to the
  P best past CAP - 16; the segments' (key, column) lists merged into a
  running list of P; on the plain version's own distances it must return
  them bit for bit, ties to the lower column and +inf cells included;
- on CPU tensors `ivf_search_impl` and `serve_seeds` return exactly what
  the q·Cᵀ matmul and K2 pair returned.
"""

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels
from turdb_tpu_torch.kernels import EPI_L2, topk_rows
from turdb_tpu_torch.models import HnswIndex, IvfIndex
from turdb_tpu_torch.models import hnsw_serve as ths
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.ops.distance import Metric, prep_norms
from turdb_tpu_torch.ops.quantize import quantize_queries

torch.set_num_threads(1)

H100_SMS = 132
CAP = 48                      # a query's candidate buffer (csrc/cell_select.cu CS_CAP)
GROUP = 16                    # columns a warp meets at once


@pytest.mark.parametrize("shape, plan", [
    ((10_000, 20_429, 128, 5), (4, 5)),      # r95: 157 query tiles x 5 segments, 3 waves of 264
    ((10_000, 20_429, 128, 8), (4, 5)),      # r99
    ((10_000, 3_906, 128, 2), (4, 8)),       # serve's seeding
    ((4_096, 20_429, 128, 8), (4, 4)),       # a self-probe chunk of the bulk build
    ((256, 20_429, 128, 8), (4, 54)),
    ((16, 20_429, 128, 8), (1, 160)),
    ((1, 20_429, 128, 8), (1, 160)),         # a SQL statement: a segment a tile
    ((7, 64, 128, 8), (1, 1)),
    ((10_000, 20_429, 256, 5), (4, 5)),      # d = 256: one block an SM
    ((4_096, 20_000, 96, 32), (4, 4)),       # the widest P
    ((10_000, 20_429, 128, 33), None),       # P past the buffer's
    ((10_000, 20_429, 130, 5), None),        # d no multiple of 4
    ((10_000, 20_429, 260, 5), None),        # d past CELLSEL_D_MAX
    ((3, 2, 128, 3), None),                  # P past C
])
def test_plan_rule(shape, plan):
    got = kernels.cell_select_plan(*shape, H100_SMS)
    assert got == plan
    if got is not None:
        mi, s = got
        b, c, d, _ = shape
        nt = -(-c // kernels.CELLSEL_TC)
        tps = -(-nt // s)
        assert (s - 1) * tps < nt <= s * tps          # no empty segment
        assert kernels.cell_select_smem(mi, d) <= 232_448    # a block's opted-in limit


@pytest.mark.parametrize("device, shape, fused", [
    ("cuda", (10_000, 20_429, 128, 5), True),       # r95, r99
    ("cuda:0", (10_000, 3_906, 128, 2), True),      # serve's seeding
    ("cuda", (4_096, 20_429, 128, 8), True),        # the bulk build's self-probe chunks
    ("cuda", (2_048, 20_429, 128, 8), True),
    ("cuda", (2_047, 20_429, 128, 8), False),       # below CELLSEL_B_MIN: the pair
    ("cuda", (1, 20_429, 128, 8), False),           # a SQL statement keeps the pair
    ("cuda", (10_000, 20_429, 128, 64), False),     # deep LIMITs: wide P keeps the pair
    ("cuda", (10_000, 20_429, 384, 8), False),      # 384-d rows keep the pair
    ("cpu", (10_000, 20_429, 128, 5), False),       # the plain version
])
def test_route(monkeypatch, device, shape, fused):
    monkeypatch.setattr(kernels, "_sm_count", lambda dev: H100_SMS)
    assert kernels.cell_select_fused(device, *shape) is fused


def _keys(x):
    """K12's order-preserving keys of f32 distances, -0 folded into +0."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & np.uint64(0xFFFFFFFF), u | np.uint64(0x80000000))


def _key_f32(k):
    k = np.asarray(k, np.uint64) & np.uint64(0xFFFFFFFF)
    u = np.where(k & 0x80000000, k & np.uint64(0x7FFFFFFF), ~k & np.uint64(0xFFFFFFFF))
    return u.astype(np.uint32).view(np.float32)


def _compact(buf, p):
    buf.sort()
    del buf[p:]
    return buf[p - 1]


def _replay_segment(x, c0, c1, p):
    """One query's pass over columns [c0, c1) of its distances x [C]: the
    sorted list of its p best (key << 32 | column), ~0 past the buffer.
    Each tile's distances are tested against the threshold it starts with;
    where the passes fit the buffer they all go in, else the tile goes GROUP
    columns at a time; a buffer the next GROUP could overflow is compacted
    (after the tile, or between its groups)."""
    buf, thr = [], np.float32(np.nan)
    first = c0 + kernels.CELLSEL_TC

    def put(cols):
        vals = x[cols]
        take = ~(vals >= thr)                    # a NaN threshold takes every column
        buf.extend(int(k) << 32 | int(c) for k, c in zip(_keys(vals[take]), cols[take]))

    for t in range(c0, c1, kernels.CELLSEL_TC):
        cols = np.arange(t, min(t + kernels.CELLSEL_TC, c1))
        if t < first:
            # the first tile: the p-th least of the 16 threads' two least
            # distances each (thread tn holds columns tn + 16j), inclusively
            two = [np.sort(np.append(x[cols[(cols - t) % GROUP == tn]], [np.inf, np.inf]))[:2]
                   for tn in range(GROUP)]
            lo = np.sort(np.concatenate(two)).astype(np.float32)[p - 1]
            thr = np.float32(np.nan) if np.isinf(lo) else np.nextafter(lo, np.float32(np.inf))
        if len(buf) + int((~(x[cols] >= thr)).sum()) <= CAP:
            put(cols)
            if len(buf) > CAP - GROUP:
                thr = _key_f32(_compact(buf, p) >> 32)
            continue
        for g in range(t, t + kernels.CELLSEL_TC, GROUP):
            put(cols[(cols >= g) & (cols < g + GROUP)])
            if len(buf) > CAP - GROUP:
                thr = _key_f32(_compact(buf, p) >> 32)
    out = sorted(buf)[:p]
    return out + [(1 << 64) - 1] * (p - len(out))


def _replay(x, p, s):
    """K12's selection over a query's distances x [C] in s segments of
    whole tiles: ([p] distances, [p] columns)."""
    c = x.shape[0]
    nt = -(-c // kernels.CELLSEL_TC)
    tps = -(-nt // s)
    lists = [_replay_segment(x, t * kernels.CELLSEL_TC, min(c, (t + tps) * kernels.CELLSEL_TC), p)
             for t in range(0, nt, tps)]
    assert len(lists) == s
    if s == 1:
        best = lists[0]
    else:
        # the last block's merge: a running sorted list of p, each candidate
        # below its p-th put in at its rank
        top = [(1 << 64) - 1] * p
        for v in (v for lst in lists for v in lst):
            if v < top[-1]:
                top = sorted(top + [v])[:p]
        best = top
    keys = np.array(best, np.uint64)
    return _key_f32(keys >> np.uint64(32)), (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _case(seed, b, c, d, dup=0, inf=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32) * 4)
    cents = rng.standard_normal((c, d)).astype(np.float32) * 4
    if dup:
        # exact duplicates: ties the lower column must win, across tiles and segments
        src = rng.choice(c, dup, replace=False)
        cents[rng.choice(c, dup, replace=False)] = cents[src]
    cents = torch.from_numpy(cents)
    cn = (cents * cents).sum(1)
    if inf:
        cn[torch.from_numpy(rng.choice(c, inf, replace=False))] = float("inf")
    return q, prep_norms(q), cents, cn


@pytest.mark.parametrize("b, c, p, s, dup, inf", [
    (5, 300, 5, 1, 0, 0),
    (5, 300, 8, 3, 40, 0),
    (3, 2_000, 1, 16, 0, 0),
    (4, 2_000, 32, 8, 300, 0),        # the widest P: compactions every group or two
    (4, 3_906, 2, 8, 0, 100),         # serve's seeding shape, a few +inf cells
    (3, 1_000, 8, 8, 0, 995),         # fewer finite cells than P: +inf cells by column
    (2, 64, 8, 1, 20, 0),             # one partial tile
    (2, 129, 5, 2, 0, 0),             # a last segment of one column
])
def test_selection_replay_is_the_plain_version(b, c, p, s, dup, inf):
    q, qn, cents, cn = _case(b * c + p, b, c, 16, dup, inf)
    dots = q @ cents.T
    want_d, want_i = kernels.topk_rows_plain(dots, p, qn, cn, epilogue=EPI_L2)
    dist = kernels._row_values(dots, qn, cn, None, EPI_L2, False).numpy()
    for r in range(b):
        got_d, got_i = _replay(dist[r], p, s)
        np.testing.assert_array_equal(got_d, want_d[r].numpy())
        np.testing.assert_array_equal(got_i, want_i[r].numpy())


def test_cell_select_on_the_cpu_is_the_matmul_and_k2():
    q, qn, cents, cn = _case(3, 40, 500, 24, dup=30, inf=20)
    got = kernels.cell_select(q, qn, cents, cn, 8)
    want = topk_rows(q @ cents.T, 8, rown=qn, coln=cn, epilogue=EPI_L2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        kernels.cell_select(q, qn, cents, cn, 501)


def _pair(q, qn, cents, cn, p):
    """The cell selection as it was before K12: the matmul, then K2."""
    return topk_rows(q @ cents.T, p, rown=qn, coln=cn, epilogue=EPI_L2)


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(23)
    c = rng.standard_normal((24, 16)).astype(np.float32) * 4.0
    x = (c[rng.integers(0, 24, 4000)] + rng.standard_normal((4000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 24, 60)] + rng.standard_normal((60, 16))).astype(np.float32)
    return x, q


@pytest.mark.parametrize("flags", [{}, {"sq8": True}, {"sq8": True, "keep_f32": False, "rerank": 0}])
def test_ivf_search_is_unchanged_on_the_cpu(pool, monkeypatch, flags):
    idx = IvfIndex(dim=16, device="cpu", **flags)
    idx.add(pool[0])
    q = torch.from_numpy(pool[1])
    got = tivf.ivf_search_impl(idx.state, q, None, cfg=idx.cfg, k=10, nprobe=6)
    monkeypatch.setattr(tivf, "cell_select", _pair)
    want = tivf.ivf_search_impl(idx.state, q, None, cfg=idx.cfg, k=10, nprobe=6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_serve_seeds_are_unchanged_on_the_cpu(pool, monkeypatch):
    idx = HnswIndex(dim=16, capacity=4000, bulk_threshold=1024, device="cpu")
    idx.add(pool[0])
    idx.pack_serving()
    q = torch.from_numpy(pool[1])
    qn = prep_norms(q)
    args = (idx.serve, q, qn, *quantize_queries(q))
    kw = dict(metric=Metric.L2, ef=32, nprobe=3, nseed=32)
    got = ths.serve_seeds(*args, **kw)
    monkeypatch.setattr(ths, "cell_select", _pair)
    want = ths.serve_seeds(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_dense_path_keeps_the_matmul_and_k2(pool, monkeypatch):
    idx = IvfIndex(dim=16, dense_pack=True, device="cpu")
    idx.add(pool[0])

    def refuse(*a, **kw):
        raise AssertionError("the dense path took cell_select")

    monkeypatch.setattr(tivf, "cell_select", refuse)
    d, i = tivf.ivf_search_impl(idx.state, torch.from_numpy(pool[1]), None, cfg=idx.cfg, k=10,
                                nprobe=6, nblocks=4)
    assert i.shape == (60, 10)
