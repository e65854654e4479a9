"""K4 wide's query-major pass, replayed on the CPU.

Past m = SEL_MAX winners (or d = DIM_MAX) on the query-major route, K4
writes every probed lane's distance (`kernels/csrc/probe_wide.cu`
probe_dist_sq8_run_kernel), K2 selects each row's m best and the wide tail
writes the outputs. The pass runs a 128-thread block a (query, probe,
chunk of lanes), the chunks sized from the SM count (`run_chunk`: about
two CTAs an SM, runs of 32 lanes). Every warp of a block reads a run of 32
lanes' member, flags and metadata; warp 0 writes +inf for the dead ones,
whose rows are never read; the live ones go in groups of PQ_R, group g to
warp g % 4, with K4's fast-form scorers (sq8_rows.cuh): rows in 16-byte
words eight lanes a row (two rows a lane), other rows a warp a row (eight
rows a lane), the first PQ_JG / PQ_JW words of every row loaded before any
is summed; the sums meet in reduce_rows and the lane that holds a row's
sum writes its distance with the scalars of the run lane that read them.
`_replay` does that in numpy, blocks in any order; with K2's selection
and the tail's its distances must give `ivf_probe_sq8_plain`'s outputs bit
for bit, in both modes, with replicas and an `allowed` mask, at d = 100
(4-byte words), 48 and 4,160 (past DIM_MAX; 16-byte words).
"""

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops.quantize import quantize_queries

torch.set_num_threads(1)

H100_SMS = 132
PQ_WARPS, PQ_R, PQ_JG, PQ_JW = 4, 8, 8, 2   # probe_wide.cu
INF = np.float32(np.inf)


def _run_chunk(rows, n, sms=H100_SMS):
    """probe_wide.cu run_chunk: the lanes a CTA takes, runs of 32, as few a
    CTA as spread the (query, probe) rows over about two CTAs an SM."""
    runs = -(-n // 32)
    per = max(1, min(runs, -(-2 * sms // rows)))
    return -(-runs // per) * 32


class _Layout:
    """sq8_rows.cuh RowLayout<PQ_R, W> and the words a lane loads."""

    def __init__(self, groups):
        self.groups = groups
        self.w = 8 if groups else 32
        self.slots = PQ_R * self.w // 32
        self.j = PQ_JG if groups else PQ_JW
        self.word = 16 if groups else 4          # bytes of a word

    def slot_row(self, i, lane):
        return i * (32 // self.w) + lane // self.w

    def held_row(self, lane):
        shift = int(np.log2(self.w)) - int(np.log2(self.slots))
        return self.slot_row((lane % self.w) >> shift, lane)

    def writer(self, lane):
        return (lane & (self.w // self.slots - 1)) == 0


def _reduce_rows(v, lay):
    """row_sums.cuh reduce_rows over v [32, slots] partial sums: the
    transposing butterfly at offsets W/2, W/4, ..., then the plain one."""
    v = [list(row) for row in v]
    n, o = lay.slots, lay.w // 2
    while n > 1:
        new = [list(row) for row in v]
        for lane in range(32):
            partner = lane ^ o
            for i in range(n // 2):
                keep = v[lane][i + n // 2] if lane & o else v[lane][i]
                sent = v[partner][i] if partner & o else v[partner][i + n // 2]
                new[lane][i] = keep + sent
        v, n, o = new, n // 2, o // 2
    s = [row[0] for row in v]
    while o > 0:
        s = [s[lane] + s[lane ^ o] for lane in range(32)]
        o //= 2
    return s


def _distance(dot, mins, scale, pnorm, qs, qsum, qn, metric):
    """sq8_rows.cuh sq8_distance, rounded after every operation."""
    f = np.float32
    qdx = f(f(mins * qsum) + f(scale * f(qs * f(dot))))
    if metric == 1:
        return f(f(1.0) - qdx)
    if metric == 2:
        return -qdx
    return f(f(qn - f(f(2.0) * qdx)) + pnorm)


def _replay(a, metric, rng, sms=H100_SMS):
    """probe_dist_sq8_run_kernel over numpy. Returns dist [B, P*L], the
    writes of every lane, the rows read (code row -> times) and the bytes
    of row words one warp's first round had in flight at most."""
    qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allowed = a
    b_n, p_n = cells.shape
    nb, lcap, d = codes.shape
    lay = _Layout(d % 16 == 0)
    flat = codes.reshape(nb * lcap, d).astype(np.int64)
    words = d // lay.word
    chunk = _run_chunk(b_n * p_n, lcap, sms)
    split = -(-lcap // chunk)
    dist = np.full((b_n, p_n * lcap), np.nan, np.float32)
    writes = np.zeros((b_n, p_n * lcap), int)
    reads = np.zeros(nb * lcap, int)
    in_flight = 0
    for blk in rng.permutation(b_n * p_n * split):      # blocks run in any order
        bp, s = divmod(int(blk), split)
        b, p = divmod(bp, p_n)
        cell = int(cells[b, p])
        q = qc[b].astype(np.int64)
        out = dist[b, p * lcap:(p + 1) * lcap]
        wr = writes[b, p * lcap:(p + 1) * lcap]
        for base in range(s * chunk, min(lcap, (s + 1) * chunk), 32):
            lanes = range(base, min(lcap, (s + 1) * chunk, base + 32))
            live = [l - base for l in lanes
                    if members[cell, l] >= 0 and alive[cell, l]
                    and (allowed is None or allowed[cell, l])]
            for l in lanes:                             # warp 0 writes the dead ones
                if l - base not in live:
                    out[l] = INF
                    wr[l] += 1
            nlive = len(live)
            for warp in range(PQ_WARPS):
                for g0 in range(warp * PQ_R, nlive, PQ_R * PQ_WARPS):
                    v = np.zeros((32, lay.slots), np.int64)
                    first = 0
                    for lane in range(32):
                        rows = []
                        for j in range(lay.slots):
                            r = g0 + lay.slot_row(j, lane)
                            rows.append(cell * lcap + base + live[r] if r < nlive else -1)
                        # lane l of a row's group takes words l, l + W, ...,
                        # J of them a row before any is summed
                        for j0 in range(lane % lay.w, words, lay.w * lay.j):
                            mine = [j0 + lay.w * u for u in range(lay.j)
                                    if j0 + lay.w * u < words]
                            if j0 == lane % lay.w:
                                first += lay.word * len(mine) * sum(r >= 0 for r in rows)
                            for i, row in enumerate(rows):
                                if row < 0:
                                    continue
                                reads[row] += 1
                                for wd in mine:
                                    sl = slice(wd * lay.word, (wd + 1) * lay.word)
                                    v[lane, i] += int(flat[row, sl] @ q[sl])
                    in_flight = max(in_flight, first)
                    sums = _reduce_rows(v, lay)
                    for lane in range(32):
                        h = g0 + lay.held_row(lane)
                        if lay.writer(lane) and h < nlive:
                            src = live[h]
                            row = cell * lcap + base + src
                            out[base + src] = _distance(
                                sums[lane], mins.flat[row], scales.flat[row],
                                pnorms.flat[row] if metric == 0 else np.float32(0.0),
                                qs[b], qsum[b], qn[b], metric)
                            wr[base + src] += 1
    return dist, writes, reads, in_flight


def _case(seed, b, p, lcap, d, nb=24, n_ids=400):
    """Codes, metadata and lane flags of a store with copies of ids (the
    replicas), empty and dead lanes; queries and their probed cells."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, (nb, lcap, d)).astype(np.int8)
    mins = rng.standard_normal((nb, lcap)).astype(np.float32)
    scales = (rng.random((nb, lcap)) / 100 + 1e-3).astype(np.float32)
    pnorms = (rng.random((nb, lcap)) * d).astype(np.float32)
    members = rng.integers(0, n_ids, (nb, lcap)).astype(np.int32)
    members[rng.random((nb, lcap)) < 0.15] = -1
    alive = rng.random((nb, lcap)) < 0.9
    allowed = rng.random((nb, lcap)) < 0.7
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = np.stack([rng.permutation(nb)[:p] for _ in range(b)]).astype(np.int32)
    return (qc.numpy(), qs.numpy(), qsum.numpy(), qn.numpy(), cells, codes, mins, scales,
            pnorms, members, alive, allowed)


# (B, P, L, d): one (query, probe) spread over CTAs of a run; many pairs in
# whole-cell CTAs; rows of 4-byte words, of 16-byte words, past DIM_MAX
CASES = {"d100_spread": (1, 5, 70, 100), "d48_pairs": (34, 8, 40, 48),
         "d4160_spread": (2, 3, 64, 4160)}


@pytest.mark.parametrize("case", list(CASES))
def test_query_major_pass_equals_the_plain_probe(case):
    """Every lane is written once, a live lane's row read once and a dead
    one's never; the distances equal the plain version's bit for bit, and
    with K2's selection and the tail so do the outputs, in top-k and
    candidate mode, with replicas, with and without `allowed`, under the
    three epilogues."""
    b, p, lcap, d = CASES[case]
    a = _case(list(CASES).index(case) + 60, b, p, lcap, d)
    t = [torch.from_numpy(x) for x in a]
    cells, members, alive, allowed = a[4], a[9], a[10], a[11]
    assert (d % 16 == 0) == (case != "d100_spread")
    if case.endswith("spread"):
        assert -(-lcap // _run_chunk(b * p, lcap)) > 1
    else:
        assert _run_chunk(b * p, lcap) >= lcap
    for metric in (0, 1, 2):
        for allow in (None, allowed):
            args = list(a[:11]) + [allow]
            dist, writes, reads, _ = _replay(args, metric, np.random.default_rng(metric))
            assert (writes == 1).all()
            live = (members >= 0) & alive & (True if allow is None else allow)
            lanes = live[cells.astype(np.int64)].reshape(b, -1)
            rows = cells.astype(np.int64)[..., None] * lcap + np.arange(lcap)
            assert (reads[rows[live[cells]]] >= 1).all()
            assert not reads[np.setdiff1d(np.arange(reads.size), rows[live[cells]])].any()
            src = torch.from_numpy(cells).long()
            doti = kernels._int8_dots(t[0], t[5][src])
            want = kernels.sq8_epilogue(doti, t[6][src], t[7][src], t[3][:, None, None],
                                        t[2][:, None, None], t[1][:, None, None], t[8][src],
                                        metric)
            want = torch.where(torch.from_numpy(lanes).reshape(want.shape), want, kernels.INF)
            np.testing.assert_array_equal(dist, want.reshape(b, -1).numpy())
            ids = t[9][src].reshape(b, -1)
            for mode, k, m in ((kernels.MODE_TOPK, 7, 20), (kernels.MODE_CAND, 40, 40)):
                got = kernels._probe_select_plain(torch.from_numpy(dist), ids, t[4], lcap, k, m,
                                                  True, mode)
                tm = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args]
                plain = kernels.ivf_probe_sq8_plain(*tm, k, m, True, mode, metric)
                for x, y in zip(got, plain):
                    assert torch.equal(x, y)


def test_rows_in_flight():
    """A warp's first round loads every row of its group before any is
    summed: eight rows of PQ_JG 16-byte words a lane (8 KB) at 4,160 dims,
    eight whole rows (25 words of 4 bytes each) at 100 dims."""
    for d, want in ((4160, PQ_R * 8 * PQ_JG * 16), (100, PQ_R * 100)):
        a = _case(70, 1, 2, 64, d)
        a = list(a)
        a[9][:] = np.arange(a[9].size, dtype=np.int32).reshape(a[9].shape)
        a[10][:] = True
        _, _, _, in_flight = _replay(a[:11] + [None], 0, np.random.default_rng(0))
        assert in_flight == want


def test_grid_spreads_one_query_over_the_card():
    """At the 3,072-d SQL statements' calls (B = 1, L = 128) LIMIT 50's 50
    probes run 200 CTAs of one run each and LIMIT 600's 600 CTAs of a whole
    cell; a batch of 256 at nprobe 50 takes whole cells too; every chunk
    cover its cell's lanes once."""
    assert _run_chunk(50, 128) == 32 and 50 * 4 == 200
    assert _run_chunk(600, 128) == 128
    assert _run_chunk(256 * 50, 128) == 128
    for rows, n in ((1, 128), (5, 70), (50, 128), (132, 100), (264, 4096), (3, 4096)):
        chunk = _run_chunk(rows, n)
        chunks = -(-n // chunk)
        assert chunk % 32 == 0 and (chunks - 1) * chunk < n <= chunks * chunk
        assert rows * chunks < 2 * H100_SMS + rows
