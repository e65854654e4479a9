"""K7's and K8's step order on the CPU.

K8 (`kernels/csrc/hnsw_beam.cu` run_beam, which K6 and K8-SQ share) keeps
its buffer sorted and takes a step in four phases: the nodes to expand
(the first unflagged entries), a hash table of the buffer's ids and every
id expanded before, a claim of each neighbour slot's id (a member drops
out, the lowest slot of an id wins), then the kept slots scored, those at
or above the buffer's worst dropped, the rest sorted in runs of 32 by
(distance, slot) and merged by ranks (binary searches of the runs and of
the buffer), the filtered result buffer alike. `_k8_replay` replays that
order in numpy, table and all (the inserts and claims in a shuffled order,
as threads race), and must equal `_beam_plain` (the reference's `_beam_level` as
torch ops) entry for entry on the same neighbour distances: small integer
distances (ties everywhere, at the worst too), +inf neighbours, lists that
repeat ids inside and across one step's nodes, ids that share a table
slot, and nodes that leave the buffer and come back into the filtered
result buffer.

K7 (`kernels/csrc/hnsw_select.cu`) dedups through the same table, sorts
(f2key(distance), position) keys in runs of 32 merged by ranks, and scans
the sorted candidates in tiles of 32: one warp decides a tile's takes in
order, and the block folds the tile's takes into the candidates after it.
`_k7_replay` replays it on the pair matrix `_diversity_scan` builds and
must give its sel_i, sel_d and n_pairs exactly, with the deg-th take at
tile position 31, 32 and 33, alpha 1.0 and 1.2, rows with no valid
candidate, W < deg, and COS / IP distances below zero.
"""

from bisect import bisect_left

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels

torch.set_num_threads(1)

INF = np.float32(np.inf)
GOLD = 0x9E3779B1
EMPTY = 0xFFFFFFFF
TILE = 32
BEAM_THREADS = 128


def _f2key(v) -> int:
    """select.cuh f2key of one float32: -0.0 folded into +0.0, then the
    order-preserving flip."""
    v = np.float32(v)
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _table_bits(members: int) -> int:
    b = 1
    while (1 << b) < 2 * members:
        b += 1
    return b


class _Table:
    """graph_util.cuh's table: ids and tags, linear probing from the
    multiplicative hash; a member's tag is 0, a claim by position t lowers
    the tag to t + 1."""

    def __init__(self, bits):
        self.bits = bits
        self.probes = 0
        self.clear()

    def clear(self):
        self.ids = [EMPTY] * (1 << self.bits)
        self.tags = [EMPTY] * (1 << self.bits)

    def insert(self, i):
        p = ((i * GOLD) & 0xFFFFFFFF) >> (32 - self.bits)
        while self.ids[p] not in (i, EMPTY):
            p = (p + 1) & ((1 << self.bits) - 1)
            self.probes += 1
        self.ids[p] = i
        return p

    def member(self, i):
        self.tags[self.insert(i)] = 0

    def claim(self, i, t):
        p = self.insert(i)
        self.tags[p] = min(self.tags[p], t + 1)
        return p


def _runs_sorted(keys, rng):
    """Keys appended in a racing order, cut into runs of 32, each sorted."""
    keys = [keys[j] for j in rng.permutation(len(keys))]
    return [sorted(keys[b:b + 32]) for b in range(0, len(keys), 32)]


def _merge(od, oi, ox, runs, new_of):
    """hnsw_beam.cu merge_into: old entries by their place plus the new
    keys below them, new keys by their place among the new plus the old
    entries at or below their distance."""
    n = len(od)
    td, ti, tx = [None] * n, [None] * n, [None] * n
    for i in range(n):
        x = _f2key(od[i]) << 32
        r = i + sum(bisect_left(run, x) for run in runs)
        if r < n:
            td[r], ti[r], tx[r] = od[i], oi[i], ox[i]
    for a, run in enumerate(runs):
        for p, key in enumerate(run):
            r = p + sum(bisect_left(o, key) for b, o in enumerate(runs) if b != a)
            v, i = new_of(key & 0xFFFFFFFF)
            r += sum(1 for d in od if d <= v)
            if r < n:
                assert td[r] is None, "two entries ranked alike"
                td[r], ti[r], tx[r] = v, i, 0
    assert all(t is not None for t in td), "a rank left empty"
    return td, ti, tx


def _k8_replay(adj, dist, seed_i, seed_d, *, ef, loops, expand, allowed=None, k_res=0,
               seed=0):
    """run_beam over numpy: adj [n, deg], dist [B, n] the neighbour
    distances. Returns (cand_d, cand_i, res_d, res_i, exp_ids, stats,
    events), events counting table probes past a first slot and nodes
    scored a second time that entered the result buffer."""
    rng = np.random.default_rng(seed)
    b_n, s = seed_i.shape
    deg = adj.shape[1]
    slots = expand * deg
    exp_cap = loops * expand
    bits = _table_bits(ef + exp_cap + slots)
    out = [np.full((b_n, ef), INF, np.float32), np.full((b_n, ef), -1, np.int32),
           np.full((b_n, k_res), INF, np.float32), np.full((b_n, k_res), -1, np.int32),
           np.full((b_n, exp_cap), -1, np.int32), np.zeros((b_n, 2), np.int32)]
    events = {"probes": 0, "rescored_in_res": 0}
    for b in range(b_n):
        order = sorted(range(s), key=lambda j: seed_d[b, j])   # stable: ties by position
        cd = [INF] * ef
        ci, cx = [-1] * ef, [0] * ef
        for r, j in enumerate(order):
            cd[r], ci[r] = np.float32(seed_d[b, j]), int(seed_i[b, j])
        rd, ri = [INF] * k_res, [-1] * k_res
        if k_res:
            sk = min(s, k_res)
            init = [(np.float32(seed_d[b, j]), int(seed_i[b, j]))
                    if seed_i[b, j] >= 0 and allowed[seed_i[b, j]] else (INF, -1)
                    for j in range(sk)]
            for r, j in enumerate(sorted(range(sk), key=lambda j: init[j][0])):
                rd[r], ri[r] = init[j]
        exp = [-1] * exp_cap
        n_exp = n_scored = 0
        seen = set()
        table = _Table(bits)
        if (seed_i[b] >= 0).any():
            for it in range(loops):
                picks = [j for j in range(ef) if ci[j] >= 0 and not cx[j] and cd[j] < INF][:expand]
                if not picks:
                    break
                sel = [-1] * expand
                for e, p in enumerate(picks):
                    sel[e] = ci[p]
                    cx[p] = 1
                exp[it * expand:(it + 1) * expand] = sel
                n_exp += len(picks)
                table.clear()
                members = [i for i in ci + exp[:it * expand] if i >= 0]
                for j in rng.permutation(len(members)):
                    table.member(members[j])
                ids = [int(adj[sel[t // deg], t % deg]) if sel[t // deg] >= 0 else -1
                       for t in range(slots)]
                pos = [-1] * slots
                for t in rng.permutation(slots):
                    if ids[t] >= 0:
                        pos[t] = table.claim(ids[t], int(t))
                kept = [t for t in range(slots) if pos[t] >= 0 and table.tags[pos[t]] == t + 1]
                n_scored += len(kept)
                v = {t: np.float32(dist[b, ids[t]]) for t in kept}
                # the warps' runs: warp (t % 128) // 32 appends its survivors
                by_warp_c, by_warp_r = {}, {}
                for t in kept:
                    key = (_f2key(v[t]) << 32) | t
                    w = (t % BEAM_THREADS) // 32
                    if v[t] < cd[ef - 1]:
                        by_warp_c.setdefault(w, []).append(key)
                    if k_res and v[t] < rd[k_res - 1] and allowed[ids[t]]:
                        by_warp_r.setdefault(w, []).append(key)
                        if ids[t] in seen:
                            events["rescored_in_res"] += 1
                    seen.add(ids[t])
                runs_c = [r for w in sorted(by_warp_c) for r in _runs_sorted(by_warp_c[w], rng)]
                runs_r = [r for w in sorted(by_warp_r) for r in _runs_sorted(by_warp_r[w], rng)]

                def new_of(t):
                    return v[t], ids[t]

                cd, ci, cx = _merge(cd, ci, cx, runs_c, new_of)
                if k_res:
                    rd, ri, _ = _merge(rd, ri, [0] * k_res, runs_r, new_of)
        events["probes"] += table.probes
        out[0][b], out[1][b], out[4][b] = cd, ci, exp
        if k_res:
            out[2][b], out[3][b] = rd, ri
        out[5][b] = (n_exp, n_scored)
    return (*out, events)


def _k8_plain(adj, dist, seed_i, seed_d, *, ef, loops, expand, allowed=None, k_res=0):
    """`_beam_plain` on the same neighbour distances, set up as
    `hnsw_graph_beam_plain` sets it up."""
    adj_t, dist_t = torch.as_tensor(adj), torch.as_tensor(dist)
    si, sd = torch.as_tensor(seed_i), torch.as_tensor(seed_d)
    b, s = si.shape
    cand_i, cand_d = kernels._beam_init(si, sd, ef)
    res = None
    allowed_t = None if allowed is None else torch.as_tensor(allowed)
    if allowed is not None:
        sk = min(s, k_res)
        ok = allowed_t[si.clamp_min(0).long()] & (si >= 0)
        ri, rd = kernels._beam_init(torch.where(ok, si, -1)[:, :sk],
                                    torch.where(ok, sd, kernels.INF)[:, :sk], k_res)
        res = (rd, ri)

    def neighbours(sel_i):
        nbrs = adj_t[sel_i.clamp_min(0).long()].reshape(b, -1)
        return nbrs, torch.gather(dist_t, 1, nbrs.clamp_min(0).long())

    ci, cd, rd, ri, exp_ids, stats = kernels._beam_plain(
        cand_i, cand_d, (si < 0).all(1), loops, expand, adj.shape[1], neighbours, allowed_t,
        res, loops * expand)
    return [t.numpy() if t is not None else None for t in (cd, ci, rd, ri, exp_ids, stats)]


def _graph(rng, n, deg, *, repeats, mod):
    """Random lists with -1 holes; `repeats` plants ids twice in a list and
    across lists (a node shares a neighbour with the node before it), and
    two ids of a list that are equal modulo `mod` (the table's size)."""
    adj = rng.integers(0, n, (n, deg))
    adj[rng.random((n, deg)) < 0.1] = -1
    if repeats:
        adj[:, deg - 1] = adj[:, 0]
        adj[1:, 1] = adj[:-1, 2]
        adj[:, 2] = np.minimum(adj[:, 3] % mod + mod * rng.integers(0, n // mod, n), n - 1)
    return adj.astype(np.int32)


@pytest.mark.parametrize("case", ["plain", "filtered", "repeats", "inf", "wide"])
def test_k8_step_order_equals_the_plain_beam(case):
    """The kernel's step order gives `_beam_plain`'s buffers, results,
    expanded ids and stats exactly."""
    rng = np.random.default_rng(["plain", "filtered", "repeats", "inf", "wide"].index(case))
    n, deg, b = (1200, 8, 12) if case == "wide" else (400, 8, 12)
    ef, expand, loops = (48, 8, 6) if case == "wide" else (10, 2, 12)
    adj = _graph(rng, n, deg, repeats=case in ("repeats", "filtered", "wide"),
                 mod=1 << _table_bits(ef + loops * expand + expand * deg))
    # small integer distances: ties at every rank, the worst included
    dist = rng.integers(0, 40, (b, n)).astype(np.float32)
    if case == "inf":
        dist[rng.random((b, n)) < 0.15] = np.inf
    seed_i = np.stack([rng.choice(n, 4, replace=False) for _ in range(b)]).astype(np.int32)
    seed_i[0] = -1                         # a query with no seed
    seed_d = np.take_along_axis(dist, seed_i.clip(0), 1)
    seed_d[seed_i < 0] = np.inf
    kw = dict(ef=ef, loops=loops, expand=expand)
    if case in ("filtered", "wide"):
        kw.update(allowed=rng.random(n) < 0.5, k_res=6)
    got = _k8_replay(adj, dist, seed_i, seed_d, seed=3, **kw)
    want = _k8_plain(adj, dist, seed_i, seed_d, **kw)
    for name, g, w in zip(("cand_d", "cand_i", "res_d", "res_i", "exp_ids", "stats"), got, want):
        if w is None:
            continue
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")
    events = got[-1]
    assert events["probes"] > 0          # ids shared a table slot
    if case == "filtered":
        # nodes left the buffer unexpanded and came back into the results
        assert events["rescored_in_res"] > 0


def test_k8_claims_keep_the_lowest_slot_in_any_order():
    """The table's claims give mask_duplicates' first copy whatever order
    the slots race in, and members drop out: ids equal modulo the table's
    size and ids that hash to one slot included."""
    bits = 6
    rng = np.random.default_rng(5)
    clash = [i for i in range(20000) if ((i * GOLD) & 0xFFFFFFFF) >> (32 - bits) == 9][:6]
    ids = np.array(clash + [3, 3 + 64, 3 + 128, 7, 7, 3, -1] + clash[::-1], np.int64)
    members = {clash[1], 7}
    want = kernels.mask_duplicates(
        torch.as_tensor(np.where(np.isin(ids, list(members)), -1, ids))[None],
        torch.zeros(1, len(ids)))[0][0].numpy()
    for trial in range(20):
        t = _Table(bits)
        for m in members:
            t.member(m)
        pos = [-1] * len(ids)
        for j in rng.permutation(len(ids)):
            if ids[j] >= 0:
                pos[j] = t.claim(int(ids[j]), int(j))
        kept = np.array([ids[j] if pos[j] >= 0 and t.tags[pos[j]] == j + 1 else -1
                         for j in range(len(ids))])
        np.testing.assert_array_equal(kept, want)
        assert t.probes > 0


def _pair(vectors, cand_s, metric):
    """The pair matrix `_diversity_scan` builds (its own expression)."""
    vecs = vectors[cand_s.clamp_min(0).long()]
    dots = torch.einsum("ucd,ukd->uck", vecs, vecs)
    if metric == 0:
        nrm = torch.sum(vecs * vecs, dim=-1)
        return torch.clamp_min(nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots, 0.0)
    return 1.0 - dots if metric == 1 else -dots


def _k7_scan_replay(pair, cand_s, d_s, *, deg, alpha):
    """hnsw_select.cu's tile scan and output over one row's sorted
    candidates: pair[c, k] is the distance of later c to taken k."""
    c = len(cand_s)
    valid = cand_s >= 0
    n_valid = int(valid.sum())
    mins = np.full(c, INF, np.float32)
    taken = np.zeros(c, bool)
    cnt = pairs = before = 0
    a32 = np.float32(alpha)
    t0 = 0
    while t0 < c and cnt < deg:
        nt = min(TILE, c - t0)
        m = mins[t0:t0 + nt].copy()
        takes = []
        for k in range(nt):
            if cnt >= deg:
                break
            if not (valid[t0 + k] and d_s[t0 + k] < a32 * m[k]):
                continue
            takes.append(k)
            cnt += 1
            if cnt < deg:
                pairs += n_valid - before - int(valid[t0:t0 + k + 1].sum())
            for lane in range(k + 1, nt):
                if valid[t0 + lane]:
                    m[lane] = min(m[lane], pair[t0 + lane, t0 + k])
        before += int(valid[t0:t0 + nt].sum())
        taken[[t0 + k for k in takes]] = True
        if takes and cnt < deg:
            for i in range(t0 + TILE, c):
                if valid[i]:
                    mins[i] = min([mins[i]] + [pair[i, t0 + k] for k in takes])
        t0 += TILE
    sel_i = np.full(deg, -1, np.int32)
    sel_d = np.full(deg, INF, np.float32)
    o = 0
    for want in (True, False):
        for j in range(c):
            if o < deg and valid[j] and taken[j] == want:
                sel_i[o] = cand_s[j] if d_s[j] < INF else -1
                sel_d[o] = d_s[j]
                o += 1
    return sel_i, sel_d, pairs


def _k7_sort_replay(d, ids, target):
    """The dedup (claims, first copy wins; the target and -1 out) and the
    sort of (f2key(distance), position) keys in runs of 32 merged by ranks:
    the candidates in scan order with their distances."""
    w = len(ids)
    t = _Table(_table_bits(w))
    pos = [t.claim(int(i), j) if i >= 0 and i != target else -1 for j, i in enumerate(ids)]
    keep = np.array([pos[j] >= 0 and t.tags[pos[j]] == j + 1 for j in range(w)])
    dist = np.where(keep, d, INF).astype(np.float32)
    keys = [(_f2key(dist[j]) << 32) | j for j in range(w)]
    keys += [(1 << 64) - 1] * (-w % 32)
    runs = [sorted(keys[b:b + 32]) for b in range(0, len(keys), 32)]
    rank = np.empty(w, np.int64)
    for a, run in enumerate(runs):
        for p, key in enumerate(run):
            if key >> 32 == 0xFFFFFFFF:
                continue
            rank[key & 0xFFFFFFFF] = p + sum(bisect_left(o, key) for b, o in enumerate(runs)
                                             if b != a)
    order = np.argsort(rank)
    return np.where(keep, ids, -1)[order], dist[order]


def _rows(rng, n, dim, metric):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if metric == 1:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.as_tensor(x)


@pytest.mark.parametrize("deg", [TILE, TILE + 1, TILE + 2])
def test_k7_tile_scan_with_the_last_take_at_the_tile_edge(deg):
    """Every valid candidate is taken (alpha large against small target
    distances), so the deg-th take falls at sorted position deg - 1: the
    last lane of the first tile, the first of the second, the one after."""
    rng = np.random.default_rng(deg)
    vectors = _rows(rng, 200, 16, 0)
    cand_s = torch.as_tensor(np.stack([rng.choice(200, 70, replace=False) for _ in range(6)]),
                             dtype=torch.int32)
    d_s = torch.as_tensor(np.sort(rng.random((6, 70)).astype(np.float32) * 1e-3, 1))
    pair = _pair(vectors, cand_s, 0)
    want = kernels._diversity_scan(vectors, cand_s, d_s, deg=deg, metric=0, alpha=1.2)
    for u in range(6):
        got = _k7_scan_replay(pair[u].numpy(), cand_s[u].numpy(), d_s[u].numpy(), deg=deg,
                              alpha=1.2)
        np.testing.assert_array_equal(got[0], want[0][u].numpy())
        np.testing.assert_array_equal(got[1], want[1][u].numpy())
        assert got[2] == int(want[2][u])
    assert bool((want[0] >= 0).all())


@pytest.mark.parametrize("metric", [0, 1, 2])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_k7_sort_and_tile_scan_equal_the_plain_selection(metric, alpha):
    """Dedup, sort and tile scan from the same distances and pair matrix
    give hnsw_select_plain's rows and n_pairs, with duplicates, -1 and the
    target among W = 80 candidates (three tiles), rows of no valid
    candidate and, for COS / IP, distances below zero."""
    rng = np.random.default_rng(10 * metric + int(alpha * 10))
    n, w, deg = 300, 80, 12
    vectors = _rows(rng, n, 24, metric)
    norms = (vectors * vectors).sum(1)
    targets = torch.as_tensor(rng.choice(n, 9, replace=False), dtype=torch.int32)
    cand = torch.as_tensor(rng.integers(0, n, (9, w)), dtype=torch.int32)
    cand[:, 5] = cand[:, 2]
    cand[:, 40] = cand[:, 39]
    cand[:, 11] = -1
    cand[:, 60] = targets
    cand[3] = -1                          # no valid candidate
    want = kernels.hnsw_select_plain(vectors, norms, targets, cand, deg=deg, metric=metric,
                                     alpha=alpha)
    # the distances hnsw_select_plain sorts (its own expression)
    t = targets.long()
    dots = torch.einsum("ud,uwd->uw", vectors[t], vectors[cand.clamp_min(0).long()])
    d = kernels._gathered_epilogue(dots, metric, norms[t][:, None], norms[cand.clamp_min(0).long()])
    if metric:
        assert bool((d < 0).any())
    cap = kernels.select_cap(w, deg, alpha)
    for u in range(9):
        cs, ds = _k7_sort_replay(d[u].numpy(), cand[u].numpy(), int(targets[u]))
        cs_t = torch.as_tensor(cs[:cap], dtype=torch.int32)[None]
        pair = _pair(vectors, cs_t, metric)[0].numpy()
        got = _k7_scan_replay(pair, cs[:cap], ds[:cap], deg=deg, alpha=alpha)
        np.testing.assert_array_equal(got[0], want[0][u].numpy(), err_msg=f"row {u}")
        np.testing.assert_array_equal(got[1], want[1][u].numpy(), err_msg=f"row {u}")
        assert got[2] == int(want[2][u]), u


def test_k7_sort_keys_order_negative_and_signed_zero_distances():
    """The runs-and-ranks sort of f2key keys is torch's stable argsort:
    negative distances, -0.0 beside +0.0, ties and +inf."""
    rng = np.random.default_rng(7)
    for w in (1, 31, 32, 33, 100, 256):
        d = rng.integers(-5, 5, w).astype(np.float32)
        d[rng.random(w) < 0.2] = -0.0
        d[rng.random(w) < 0.1] = np.inf
        ids = np.arange(w, dtype=np.int32)
        cs, ds = _k7_sort_replay(d, ids, -1)
        order = torch.argsort(torch.as_tensor(d), stable=True).numpy()
        np.testing.assert_array_equal(cs, ids[order])
        np.testing.assert_array_equal(ds.view(np.uint32), d[order].view(np.uint32))


@pytest.mark.parametrize("w", [5, 40])
def test_k7_tile_scan_short_and_empty_rows(w):
    """W < deg pads with -1 / +inf; a row of no valid candidate is all
    padding with n_pairs 0."""
    rng = np.random.default_rng(w)
    vectors = _rows(rng, 100, 8, 0)
    cand_s = torch.as_tensor(np.stack([rng.choice(100, w, replace=False) for _ in range(4)]),
                             dtype=torch.int32)
    cand_s[1] = -1
    cand_s[2, w // 2:] = -1
    d_s = torch.as_tensor(np.sort(rng.random((4, w)).astype(np.float32), 1))
    d_s = torch.where(cand_s >= 0, d_s, kernels.INF)
    for alpha in (1.0, 1.2):
        want = kernels._diversity_scan(vectors, cand_s, d_s, deg=48, metric=0, alpha=alpha)
        pair = _pair(vectors, cand_s, 0)
        for u in range(4):
            got = _k7_scan_replay(pair[u].numpy(), cand_s[u].numpy(), d_s[u].numpy(), deg=48,
                                  alpha=alpha)
            np.testing.assert_array_equal(got[0], want[0][u].numpy())
            np.testing.assert_array_equal(got[1], want[1][u].numpy())
            assert got[2] == int(want[2][u])
        assert int(want[2][1]) == 0 and bool((want[0][1] == -1).all())
