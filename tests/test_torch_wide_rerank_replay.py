"""K5 wide's distance pass and K8-SQ wide's staged scorer, replayed on the CPU.

K5 past r = SEL_MAX (`kernels/csrc/probe_wide.cu` rerank_dist_chunk_kernel)
runs a grid of (query, chunk of candidates) sized from the SM count
(`run_chunk`: about two CTAs an SM over the batch, runs of 32). Under
replicas each CTA claims the ids of its query's candidates [0, end of its
chunk) in a table in its shared memory, or, past what a CTA holds (r >
8,192 on an H100), one claim pass fills a global table a query; a
candidate keeps its row iff its id is not -1 and its claim (the lowest
index of the id) is its own. A warp reads a run of 32 candidates, marks
the dead ones +inf (+inf probe distance, id -1, a later copy) and takes
the live ones in groups of PD_R, the block's warps in turn. `_k5_replay`
replays that in numpy, blocks and claims in racing orders, and with K2's
selection and the id gather must equal `ivf_rerank_plain` entry for
entry, f32 and SQ16.

K8-SQ past the fast form's widths (`kernels/csrc/graph_wide.cu` wide_beam,
SCORE_STAGED) compacts a step's kept slots, copies their code rows into a
stage in the block's shared memory a batch of `srows` rows at a time (a
warp a row, lane l on words l, l + 32, ...), and thread j scores staged
row j against the query row there. `_stage_scorer` replays the plan inside
the wide loop's replay and must give `hnsw_graph_beam_plain`'s buffers over
an `Sq8Rows` store entry for entry (integer codes and queries, so every
sum order gives the same distances); `sq_stage`'s sizing and the stage's
bank map are replayed at d = 384, 768 and 4,608.
"""

import numpy as np
import pytest
import torch

from test_torch_beam_replay import INF, _graph, _Table, _table_bits
from test_torch_greedy_replay import _read_order
from test_torch_wide_replay import _k8_wide_replay, _mbits
from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops.quantize import Sq8Rows, sq16_decode

torch.set_num_threads(1)

H100_SMS = 132
SMEM_OPTIN = 232_448        # an H100's opted-in shared memory a block
RD_WARPS = 8                # probe_wide.cu RD_THREADS / 32
PD_R = 4                    # rows in flight a warp
WB_WARPS = 8                # graph_wide.cu WB_THREADS / 32
SQ_STAGE_MIN = 32
CODE_BYTES = {"sq8": 1, "sq16": 2}


# ---------------------------------------------------------------------------
# K5 wide

def _rerank_chunk(b, r, sms=H100_SMS):
    """probe_wide.cu run_chunk: candidates a CTA, runs of 32, as few a
    CTA as spread the batch over about two CTAs an SM."""
    runs = -(-r // 32)
    per = max(1, min(runs, -(-2 * sms // b)))
    return -(-runs // per) * 32


def _table_in_smem(r):
    return (8 << _table_bits(r)) <= SMEM_OPTIN


def _claims(ids, upto, bits, rng):
    """The table after ids[0, upto) claim in a racing order (id -1 does not)."""
    tab = _Table(bits)
    for i in rng.permutation(upto):
        if ids[i] != -1:
            tab.claim(int(ids[i]), int(i))
    return tab


def _first_copy(tab, idv, i):
    return tab.tags[tab.insert(int(idv))] == i + 1


def _k5_replay(cand_d, cand_i, exact, replicated, rng, sms=H100_SMS):
    """rerank_dist_chunk_kernel over numpy; exact [B, r] is what a warp's
    sums give a live candidate. Returns ex [B, r] and the number of times
    each entry was written and each candidate's row read."""
    b_n, r = cand_d.shape
    chunk = _rerank_chunk(b_n, r, sms)
    chunks = -(-r // chunk)
    ex = np.full((b_n, r), np.nan, np.float32)
    writes = np.zeros((b_n, r), int)
    reads = np.zeros((b_n, r), int)
    glob = ({b: _claims(cand_i[b], r, _table_bits(r), rng) for b in range(b_n)}
            if replicated and not _table_in_smem(r) else None)
    for blk in rng.permutation(b_n * chunks):          # blocks run in any order
        b, c = divmod(int(blk), chunks)
        c0, c1 = c * chunk, min(r, (c + 1) * chunk)
        tab = None
        if replicated:
            tab = glob[b] if glob else _claims(cand_i[b], c1, _table_bits(c1), rng)
        for base in range(c0, c1, 32):
            live = []
            for i in range(base, min(base + 32, c1)):
                ok = not np.isinf(cand_d[b, i])
                if replicated:
                    ok = ok and cand_i[b, i] != -1 and _first_copy(tab, cand_i[b, i], i)
                if ok:
                    live.append(i)
                else:                                  # warp 0 writes the dead ones
                    ex[b, i] = INF
                    writes[b, i] += 1
            groups = [live[g:g + PD_R] for g in range(0, len(live), PD_R)]
            for warp in range(RD_WARPS):               # group g goes to warp g % 8
                for grp in groups[warp::RD_WARPS]:
                    for i in grp:
                        ex[b, i] = exact[b, i]
                        writes[b, i] += 1
                        reads[b, i] += 1
    return ex, writes, reads


def _k5_case(seed, b, r, store, n_ids):
    """A store, queries and r candidates a query: ids from a pool of n_ids
    (many copies), id -1, +inf probe distances, and dead earlier copies of
    ids that come again later."""
    rng = np.random.default_rng(seed)
    nb, lcap, d = 40, 128, 16
    x = rng.standard_normal((nb, lcap, d)).astype(np.float32)
    pvecs = torch.from_numpy(x)
    pnorms = (pvecs * pvecs).sum(-1)
    mins = scales = None
    if store == "sq16":
        mins = torch.from_numpy(x.min(-1))
        scales = torch.from_numpy((x.max(-1) - x.min(-1)) / 255.0)
        u = rng.integers(0, 65536, (nb, lcap, d))
        pvecs = torch.from_numpy(np.where(u >= 32768, u - 65536, u).astype(np.int16))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    qn = (q * q).sum(1)
    cand_pos = rng.integers(0, nb * lcap, (b, r)).astype(np.int32)
    cand_i = rng.integers(0, n_ids, (b, r)).astype(np.int32)
    cand_i[rng.random((b, r)) < 0.03] = -1
    cand_d = rng.random((b, r)).astype(np.float32)
    cand_d[rng.random((b, r)) < 0.1] = np.inf
    # a dead first copy of an id whose later copy is live: the later one drops
    cand_i[:, 5], cand_d[:, 5] = cand_i[:, r - 3], np.inf
    cand_d[:, r - 3] = 0.5
    return (q, qn, torch.from_numpy(cand_d), torch.from_numpy(cand_i),
            torch.from_numpy(cand_pos), pvecs, pnorms, mins, scales)


def _exact(q, qn, cand_pos, pvecs, pnorms, mins, scales):
    """Each candidate's exact distance, as ivf_rerank_plain computes it."""
    d = pvecs.shape[-1]
    pos = cand_pos.long()
    flat = pvecs.reshape(-1, d)
    if pvecs.dtype == torch.int16:
        vecs = sq16_decode(flat[pos], mins.reshape(-1)[pos], scales.reshape(-1)[pos])
    else:
        vecs = flat[pos]
    dots = torch.einsum("bd,brd->br", q, vecs)
    return (qn[:, None] + pnorms.reshape(-1)[pos]) - 2.0 * dots


K5_CASES = {                 # (B, r, pool of ids, replicated, k's)
    "replicas": (3, 2500, 700, True, (2500, 700)),
    "chunks_uneven": (5, 2500, 900, True, (2500, 1)),
    "no_replicas": (2, 3000, 800, False, (3000, 64)),
    "global_table": (2, 9000, 2500, True, (9000, 4000)),
}


@pytest.mark.parametrize("store", ["f32", "sq16"])
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_wide_chunks_and_claims_equal_the_plain_rerank(case, store):
    """Every candidate is written once, a live one's row read once and a
    dead one's never; the distances, K2's selection and the gathered ids
    equal ivf_rerank_plain's at k = r and below it, with the claim table in
    each CTA's shared memory or (r = 9,000) in the global table."""
    b, r, n_ids, replicated, ks = K5_CASES[case]
    args = _k5_case(list(K5_CASES).index(case) + 40, b, r, store, n_ids)
    q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins, scales = args
    chunk = _rerank_chunk(b, r)
    if case == "chunks_uneven":
        assert r % chunk and -(-r // chunk) > 1
    assert _table_in_smem(r) == (case != "global_table")
    exact = _exact(q, qn, cand_pos, pvecs, pnorms, mins, scales).numpy()
    ex, writes, reads = _k5_replay(cand_d.numpy(), cand_i.numpy(), exact, replicated,
                                   np.random.default_rng(7))
    assert (writes == 1).all()
    live = np.isfinite(cand_d.numpy())
    assert not reads[~live].any()
    want_ex = torch.where(torch.isinf(cand_d), kernels.INF, torch.from_numpy(exact))
    ids = cand_i
    if replicated:
        ids, want_ex = kernels.mask_duplicates(cand_i, want_ex)
        assert bool(torch.isinf(want_ex[:, r - 3]).all())    # its earlier copy was dead
    np.testing.assert_array_equal(ex, want_ex.numpy())
    for k in ks:
        dk, pos = kernels.topk_rows_plain(torch.from_numpy(ex), k)
        ik = torch.where(torch.isinf(dk), -1, torch.gather(cand_i, 1, pos.long()))
        pd, pi = kernels.ivf_rerank_plain(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins,
                                          scales, k, replicated)
        assert torch.equal(dk, pd) and torch.equal(ik, pi), k


def test_k5_wide_grid_spreads_one_query_over_the_card():
    """At the SQL LIMIT 600 call (B = 1, r = 2,400) the pass runs 75 CTAs of
    one run each; a wider batch takes fewer, longer chunks; the chunks
    cover r once; the claim table leaves shared memory past r = 8,192."""
    assert _rerank_chunk(1, 2400) == 32 and -(-2400 // 32) == 75
    for b, r in ((1, 2400), (1, 2500), (3, 2500), (64, 2500), (1024, 2049), (2, 100_000)):
        chunk = _rerank_chunk(b, r)
        chunks = -(-r // chunk)
        assert chunk % 32 == 0 and (chunks - 1) * chunk < r <= chunks * chunk
        assert b * chunks < 2 * H100_SMS + b
    assert _table_in_smem(8192) and not _table_in_smem(8193)


# ---------------------------------------------------------------------------
# K8-SQ wide

def _stage_words(row_bytes):
    return ((row_bytes + 15) >> 4) | 1


def _wide_beam_bytes(deg, ef, iters, expand, k_res):
    """graph_wide.cu wide_beam_bytes (K8 / K8-SQ: no rerank keys)."""
    loops = -(-iters // expand)
    exp_cap, slots = loops * expand, expand * deg
    mbits = _mbits(ef, exp_cap, min(slots, ef))
    words = ((1 << mbits) + (2 << _table_bits(slots)) + 3 * ef + 2 * k_res + 6 * slots + expand
             + exp_cap + 8)
    return (8 * 2 * slots + 4 * words + 15) & ~15


def _sq_stage(deg, ef, iters, expand, k_res, d, bits):
    """graph_wide.cu sq_stage: (state in the global scratch, srows, shared
    bytes of the launch)."""
    pitch = _stage_words(d * bits // 8) * 16
    qb = (4 * d + 15) & ~15
    state = _wide_beam_bytes(deg, ef, iters, expand, k_res)
    slots = expand * deg
    glob = state + qb + min(slots, SQ_STAGE_MIN) * pitch > SMEM_OPTIN
    roff = (0 if glob else state) + qb
    srows = min(slots, max(0, (SMEM_OPTIN - roff) // pitch))
    return glob, srows, roff + srows * pitch


def test_k8sq_stage_sizing():
    """The 768-d SQ8 search at ef 1,600 (deg 32, expand 4): the 68,784-byte
    state, the query row and all 128 slots of a step (784 bytes a staged
    row) share one block's shared memory (SQ16: 103 rows a batch, 1,552
    bytes a staged row); at ef 5,600 the state lies in the
    global scratch and the stage still holds a step; SQ16 rows of 4,608
    codes leave room for 23 rows a batch beside a global state."""
    assert _wide_beam_bytes(32, 1600, 2400, 4, 0) == 68_784
    assert _sq_stage(32, 1600, 2400, 4, 0, 768, 8) == (False, 128, 68_784 + 3072 + 128 * 784)
    assert _sq_stage(32, 1600, 2400, 4, 800, 768, 8)[:2] == (False, 128)
    assert _sq_stage(32, 1600, 2400, 4, 0, 768, 16)[:2] == (False, 103)
    assert _sq_stage(32, 5600, 8400, 4, 0, 768, 8)[:2] == (True, 128)
    assert _sq_stage(32, 1600, 2400, 4, 0, 4608, 16)[:2] == (True, 23)
    for args in ((32, 1600, 2400, 4, 0, 384, 8), (32, 3000, 4500, 4, 0, 768, 16),
                 (32, 1500, 2250, 40, 0, 32, 8), (32, 5600, 8400, 4, 0, 4608, 8)):
        glob, srows, smem = _sq_stage(*args)
        assert 1 <= srows and smem <= SMEM_OPTIN
        assert srows >= min(args[3] * args[0], SQ_STAGE_MIN) or glob


def _stage_scorer(codes, qv, qn, xn, srows, store, rng, log):
    """A step's kept slots scored as wide_beam's SCORE_STAGED branch does:
    compacted in a racing order, staged srows rows a batch (warp r % 8
    copies row r, lane l words l, l + 32, ...), thread j scoring staged row
    j from its bytes in staged_dot's read order."""
    d = qv.shape[1]
    rb = d * CODE_BYTES[store]
    pitch = _stage_words(rb) * 16
    wb = 16 if rb % 16 == 0 else 4
    rw = rb // wb
    raw = codes.view(np.uint8).reshape(len(codes), rb)
    order = [e for _, _, elems in _read_order(d, store) for e in elems]
    assert order == list(range(d))

    def score(b, kept, ids):
        kept_c = [kept[j] for j in rng.permutation(len(kept))]
        out = {}
        for base in range(0, len(kept_c), srows):
            batch = kept_c[base:base + srows]
            stage = np.zeros(srows * pitch, np.uint8)
            copied = np.zeros(srows * pitch, int)
            for r, t in enumerate(batch):
                for lane in range(32):
                    for w in range(lane, rw, 32):
                        at = r * pitch + w * wb
                        assert at + wb <= r * pitch + rb            # inside its row
                        stage[at:at + wb] = raw[ids[t], w * wb:(w + 1) * wb]
                        copied[at:at + wb] += 1
            assert copied.max() <= 1
            for j, t in enumerate(batch):
                row = stage[j * pitch:j * pitch + rb]
                vals = (row.view(np.uint16) if store == "sq16" else row).astype(np.int64)
                np.testing.assert_array_equal(vals, codes[ids[t]].astype(np.int64) & 0xFFFF)
                v = qn[b] + xn[ids[t]] - 2 * int(vals @ qv[b])
                assert t not in out
                out[t] = np.float32(max(v, 0))
            log.append(len(batch))
        assert sorted(out) == sorted(kept)
        return out
    return score


@pytest.mark.parametrize("store", ["sq8", "sq16"])
@pytest.mark.parametrize("d, srows", [(48, 64), (48, 24), (36, 7)])
def test_k8sq_staged_beam_equals_the_plain_beam(store, d, srows):
    """The wide loop with the staged scorer gives hnsw_graph_beam_plain's
    buffers, expanded ids and stats over an Sq8Rows store, every kept slot
    scored exactly once, no batch past the stage: a whole step a batch,
    batches of 24 and of 7 rows, rows of whole 16-byte words and (d = 36)
    of 4-byte copies."""
    rng = np.random.default_rng(d + srows + CODE_BYTES[store])
    n, deg, b = 500, 16, 4
    ef, expand, loops = 40, 4, 16
    adj = _graph(rng, n, deg, repeats=True, mod=1 << _mbits(ef, loops * expand, ef))
    # integer codes (min 0, scale 1) and queries: every sum is exact
    vals = rng.integers(0, 64, (n, d))
    codes = vals.astype(np.uint8) if store == "sq8" else vals.astype(np.int16)
    qv = rng.integers(-3, 4, (b, d))
    qn, xn = (qv * qv).sum(1), (vals * vals).sum(1)
    dist = np.maximum(qn[:, None] + xn[None, :] - 2 * qv @ vals.T, 0).astype(np.float32)
    seed_i = np.stack([rng.choice(n, 4, replace=False) for _ in range(b)]).astype(np.int32)
    seed_d = np.take_along_axis(dist, seed_i, 1)
    log = []
    scorer = _stage_scorer(codes, qv, qn, xn, srows, store, np.random.default_rng(5), log)
    got = _k8_wide_replay(adj, dist, seed_i, seed_d, ef=ef, loops=loops, expand=expand, seed=3,
                          scorer=scorer)
    rows = Sq8Rows(torch.from_numpy(codes), torch.zeros(n), torch.ones(n))
    want = kernels.hnsw_graph_beam_plain(
        torch.from_numpy(adj), rows, torch.from_numpy(xn.astype(np.float32)),
        torch.from_numpy(qv.astype(np.float32)), torch.from_numpy(qn.astype(np.float32)),
        torch.from_numpy(seed_i), torch.from_numpy(seed_d), ef=ef, iters=loops * expand,
        metric=0, expand=expand, return_expanded=True)
    for name, g, w in zip(("cand_d", "cand_i", "exp_ids", "stats"),
                          (got[0], got[1], got[4], got[5]),
                          (want.cand_d, want.cand_i, want.exp_ids, want.stats)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert max(log) <= srows and sum(log) == int(got[5][:, 1].sum())
    if srows < expand * deg:
        assert max(log) == srows                 # a step took several batches


@pytest.mark.parametrize("d", [384, 768, 4608])
@pytest.mark.parametrize("store", ["sq8", "sq16"])
def test_k8sq_stage_bank_map(store, d):
    """Thread j of a warp reads staged row j: each phase of a 16-byte shared
    load (8 lanes, 8 neighbouring rows at one offset) covers the 32 banks
    once; a warp's copies of one row (lane l on 16-byte word l) fill
    neighbouring banks, and a row's words never reach the next row."""
    rb = d * CODE_BYTES[store]
    sw = _stage_words(rb)
    assert sw % 2 == 1 and 16 * sw >= rb and rb % 16 == 0
    for off, size, _ in _read_order(d, store):
        assert size == 16
        for p in range(4):
            banks = [(((8 * p + k) * sw * 16 + off) // 4 + i) % 32
                     for k in range(8) for i in range(4)]
            assert sorted(banks) == list(range(32)), (off, p)
    for w0 in range(0, rb // 16, 32):
        for p in range(4):
            words = [w0 + 8 * p + k for k in range(8) if w0 + 8 * p + k < rb // 16]
            banks = [(w * 4 + i) % 32 for w in words for i in range(4)]
            assert len(set(banks)) == len(banks)
