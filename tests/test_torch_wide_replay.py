"""K2's wide form and the wide beams' loop, replayed on the CPU.

K2 past k = SEL_MAX (`kernels/csrc/topk_rows.cu` topk_cluster_kernel)
keeps a row's keys in shared memory over a thread block cluster of
`kernels.topk_wide_ctas(n, k)` CTAs, an equal segment each. Each radix
pass sums the CTAs' histograms, so every CTA finds the same threshold (the tie among equal
keys by the row's positions); each CTA then collects (in the order its
warps' atomics give) and sorts its own winners, and each winner's place in
the row is its place there plus the other CTAs' winners below it.
`_k2_cluster_replay` replays that in numpy and must equal
`topk_rows_plain` bit for bit: ties at the threshold across segment
boundaries, +inf lanes, k = n, any split of a row.

The wide beams (`kernels/csrc/graph_wide.cu` wide_beam: K8, K8-SQ and K6
past their fast forms' widths) keep a member set across steps (open
addressing with tombstones: an id that enters the buffer is inserted, one
the merge evicts unexpanded is deleted, expanded ids stay, the set rebuilt
from its members before it fills), a cursor of the first unexpanded
entry, a claim table reset slot by slot, and a merge in place from the
first place a new key takes, a block of entries at a time from the top.
`_k8_wide_replay` replays that step order and must equal `_beam_plain` (the
reference's `_beam_level` as torch ops) entry for entry: buffers, results,
expanded ids and stats.
"""

from bisect import bisect_left

import numpy as np
import pytest
import torch

from test_torch_beam_replay import (EMPTY, GOLD, INF, _f2key, _graph, _k8_plain, _runs_sorted,
                                    _Table, _table_bits)
from turdb_tpu_torch import kernels

torch.set_num_threads(1)

INF_KEY = 0xFF800000
TOMB = 0xFFFFFFFE
WIDE_CHUNK = 4 * 256  # graph_wide.cu WIDE_SHIFT x WB_THREADS: the merge's block of entries


# ---------------------------------------------------------------------------
# K2's wide form

def _keys(v: np.ndarray) -> np.ndarray:
    """select.cuh f2key of each float32."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.int64) & 0xFFFFFFFF


def _narrow(segs, span: int, want: int):
    """radix_narrow over a cluster: segs are each CTA's values of the set
    (in [0, span]); a pass's histogram is the sum of the CTAs' own."""
    rem, prefix = span.bit_length(), 0
    while rem > 0:
        w = min(8, rem)
        shift = rem - w
        hist = sum(np.bincount((v[(v >> rem) == prefix] >> shift) & ((1 << w) - 1),
                               minlength=256) for v in segs)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, want))
        want -= int(cum[b] - hist[b])
        prefix = (prefix << w) | b
        rem = shift
        if hist[b] == want:
            return True, prefix, rem, want
    return False, prefix, 0, want


def _cluster_win(keys, pos, bounds, want):
    """radix_select + Threshold::win over the segments [a, b) of one row,
    every statistic and histogram combined across them: the mask of the
    `want` smallest (key, position) pairs."""
    fin = keys < INF_KEY
    n_fin = sum(int(fin[a:b].sum()) for a, b in bounds)
    fset = n_fin >= want
    if not fset:
        want -= n_fin
    in_set = fin == fset
    lo = min(int(keys[a:b][in_set[a:b]].min()) for a, b in bounds if in_set[a:b].any())
    hi = max(int(keys[a:b][in_set[a:b]].max()) for a, b in bounds if in_set[a:b].any())
    rel = keys - lo
    done, prefix, rem, want = _narrow([rel[a:b][in_set[a:b]] for a, b in bounds], hi - lo, want)
    r = rel >> rem
    win = in_set & (r < prefix)
    last = in_set & (r == prefix)
    if not done:                     # the threshold ties: the row's lowest positions of it
        plo = min(int(pos[a:b][last[a:b]].min()) for a, b in bounds if last[a:b].any())
        phi = max(int(pos[a:b][last[a:b]].max()) for a, b in bounds if last[a:b].any())
        prel = pos - plo
        _, pprefix, prem, _ = _narrow([prel[a:b][last[a:b]] for a, b in bounds], phi - plo,
                                      want)
        last &= (prel >> prem) <= pprefix
    return win | last | (fin & (not fset))


def _k2_cluster_replay(vals: np.ndarray, k: int, ctas: int, rng):
    """topk_cluster_kernel on the epilogue's values [B, n]: each CTA's
    winners collected in a racing order and sorted, then each one written
    at its place in its CTA's list plus the other CTAs' winners below it.
    Returns ([B, k] values, [B, k] positions, the rows whose threshold tie
    straddled a segment boundary)."""
    b, n = vals.shape
    segw = -(-n // ctas)
    bounds = [(c0, min(n, c0 + segw)) for c0 in range(0, n, segw)]
    assert len(bounds) == ctas
    keys = _keys(vals)
    pos = np.arange(n, dtype=np.int64)
    out_v = np.full((b, k), np.nan, np.float32)
    out_p = np.full((b, k), -1, np.int64)
    straddled = 0
    for r in range(b):
        win = _cluster_win(keys[r], pos, bounds, k)
        lists = []
        for a, e in bounds:
            got = pos[a:e][win[a:e]]
            got = got[rng.permutation(len(got))]                  # the warps' slot order
            lists.append(np.sort((keys[r, got].astype(np.uint64) << np.uint64(32))
                                 | got.astype(np.uint64)))
        for c, mine in enumerate(lists):
            for i, x in enumerate(mine):
                place = i + sum(int(np.searchsorted(o, x)) for d, o in enumerate(lists) if d != c)
                assert out_p[r, place] == -1, "two winners placed alike"
                out_p[r, place] = int(x & np.uint64(0xFFFFFFFF))
                out_v[r, place] = vals[r, out_p[r, place]]
        assert (out_p[r] >= 0).all()
        t = keys[r, out_p[r, -1]]
        straddled += len({i for i, (a, e) in enumerate(bounds) if (keys[r, a:e] == t).any()}) > 1
    return out_v, out_p, straddled


def _tied_rows(rng, b, n, ctas):
    """Values on a coarse grid (ties everywhere), the first 64 columns of
    each CTA's segment copying the 64 before them, about 10 % +inf lanes."""
    x = (np.round(rng.standard_normal((b, n)) * 4) / 4).astype(np.float32)
    w = -(-n // ctas)
    for s in range(w, n, w):
        x[:, s:s + 64] = x[:, s - 64:s]
    x[rng.random((b, n)) < 0.1] = np.inf
    return x


@pytest.mark.parametrize("b,n,k,ctas", [(64, 5000, 3000, 3), (1, 2400, 2400, 3),
                                        (1024, 2400, 2400, 3), (8, 8193, 2049, 3),
                                        (1, 76_800, 4_800, 8), (1, 76_800, 2_400, 8),
                                        (1, 12_000, 12_000, 8), (256, 131_072, 3_000, 8)])
def test_k2_wide_routes_equal_plain(b, n, k, ctas):
    """The split `topk_wide_ctas` gives at each caller's shape [b, n] (3
    CTAs a row at [64, 5000], at K5 wide's [1, 2400] and [1024, 2400] and
    just past one segment's 8,192 columns, 8 at the wide probes' [1,
    76,800], at k = n = 12,000 and at the flat chunk's [256, 131,072];
    tests/test_torch_cuda.py asks the card for it), replayed on three rows
    of that width: bit-equal to `topk_rows_plain`, with the threshold's
    ties across CTA boundaries."""
    rng = np.random.default_rng(n + k)
    x = _tied_rows(rng, 3, n, ctas)
    ev, ep, straddled = _k2_cluster_replay(x, k, ctas, rng)
    pv, pp = kernels.topk_rows_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ev, pv.numpy())
    np.testing.assert_array_equal(ep, pp.numpy())
    assert straddled == 3, "the threshold's ties should span CTAs in every row"


@pytest.mark.parametrize("ctas", [2, 5, 16])
def test_k2_cluster_any_split_equals_plain(ctas):
    """Any split of a row over a cluster gives the plain answer: the
    threshold's tie spread over every CTA, fewer finite lanes than k."""
    rng = np.random.default_rng(ctas)
    n = 9_000
    x = (rng.integers(0, 6, (4, n)) / 2).astype(np.float32)
    x[1, rng.random(n) < 0.8] = np.inf        # 1,800 finite lanes for k = 2,500
    for k in (2_049, 2_500, n):
        ev, ep, _ = _k2_cluster_replay(x, k, ctas, rng)
        pv, pp = kernels.topk_rows_plain(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ev, pv.numpy())
        np.testing.assert_array_equal(ep, pp.numpy())


# ---------------------------------------------------------------------------
# the wide beams' loop

class _MemberSet:
    """graph_wide.cu's member set: ids by linear probing from the
    multiplicative hash; a deleted id's entry becomes TOMB (probed past,
    never reused); `used` counts the entries no longer empty."""

    def __init__(self, bits):
        self.bits, self.used, self.tombs = bits, 0, 0
        self.ids = [EMPTY] * (1 << bits)

    def _home(self, i):
        return ((i * GOLD) & 0xFFFFFFFF) >> (32 - self.bits)

    def has(self, i):
        p = self._home(i)
        while True:
            if self.ids[p] == i:
                return True
            if self.ids[p] == EMPTY:
                return False
            p = (p + 1) & ((1 << self.bits) - 1)

    def add(self, i):
        p = self._home(i)
        while self.ids[p] not in (i, EMPTY):
            p = (p + 1) & ((1 << self.bits) - 1)
        if self.ids[p] == EMPTY:
            self.ids[p] = i
            self.used += 1
        assert self.used < len(self.ids)

    def delete(self, i):
        p = self._home(i)
        while self.ids[p] != i:
            assert self.ids[p] != EMPTY, "an evicted id was no member"
            p = (p + 1) & ((1 << self.bits) - 1)
        self.ids[p] = TOMB
        self.tombs += 1

    def members(self):
        return {i for i in self.ids if i not in (EMPTY, TOMB)}


def _mbits(ef, exp_cap, ins):
    b = 1
    while (1 << b) < 2 * (ef + exp_cap) + ins:
        b += 1
    return b


def _places(old_d, runs, new_of, n):
    """wide_new_places: each key's rank among the keys plus the old
    entries at or below its distance."""
    out = {}
    for a, run in enumerate(runs):
        for p, key in enumerate(run):
            r = p + sum(bisect_left(o, key) for c, o in enumerate(runs) if c != a)
            if r < n:
                v = new_of(key & 0xFFFFFFFF)[0]
                r += sum(1 for d in old_d if d <= v)
            out[key] = r
    return out


def _shift(d, i_, x, runs, first, chunk, evicted):
    """wide_shift: entries at or past `first` move up by the keys below
    them, a block of `chunk` entries at a time from the top; those pushed
    past the end go to evicted(id, flag)."""
    n = len(d)
    hi = n
    while hi > first:
        moves = [(i, i + sum(bisect_left(run, _f2key(d[i]) << 32) for run in runs), d[i], i_[i],
                  x[i]) for i in range(max(first, hi - chunk), hi)]
        for i, r, v, idv, xv in moves:
            assert r >= hi - chunk
            if r < n:
                d[r], i_[r], x[r] = v, idv, xv
            else:
                evicted(idv, xv)
        hi -= chunk


def _k8_wide_replay(adj, dist, seed_i, seed_d, *, ef, loops, expand, allowed=None, k_res=0,
                    seed=0, chunk=WIDE_CHUNK, smaller_set=0, scorer=None):
    """wide_beam over numpy: adj [n, deg], dist [B, n] the neighbour
    distances; `smaller_set` halves the member set that many times below
    the kernel's size (its rebuilds then come within a few steps);
    `scorer(b, kept, ids)` -> {slot: distance} scores a step's kept slots
    in place of the lookup in dist. Returns (cand_d, cand_i, res_d, res_i,
    exp_ids, stats, events)."""
    rng = np.random.default_rng(seed)
    b_n, s = seed_i.shape
    deg = adj.shape[1]
    slots = expand * deg
    exp_cap = loops * expand
    ins = min(slots, ef)
    mbits = _mbits(ef, exp_cap, ins) - smaller_set
    out = [np.full((b_n, ef), INF, np.float32), np.full((b_n, ef), -1, np.int32),
           np.full((b_n, k_res), INF, np.float32), np.full((b_n, k_res), -1, np.int32),
           np.full((b_n, exp_cap), -1, np.int32), np.zeros((b_n, 2), np.int32)]
    ev = {"tombs": 0, "rebuilds": 0, "reentered": 0, "cursor_skips": 0, "in_place_from": 0}
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
        mset = _MemberSet(mbits)
        for j in rng.permutation(s):
            if ci[j] >= 0:
                mset.add(ci[j])
        claims = _Table(_table_bits(slots))
        evicted_ids = set()
        cursor = 0
        if (seed_i[b] >= 0).any():
            for it in range(loops):
                # 1. the first unflagged finite entries from the cursor on
                assert all(not (ci[j] >= 0 and not cx[j] and cd[j] < INF) for j in range(cursor))
                ev["cursor_skips"] += cursor
                picks = [j for j in range(cursor, ef)
                         if ci[j] >= 0 and not cx[j] and cd[j] < INF][:expand]
                if not picks:
                    break
                sel = [-1] * expand
                for e, p in enumerate(picks):
                    sel[e] = ci[p]
                    cx[p] = 1
                cursor = picks[-1] + 1 if len(picks) == expand else ef
                exp[it * expand:(it + 1) * expand] = sel
                n_exp += len(picks)
                # the set holds the buffer's ids and every id expanded before
                assert mset.members() == {i for i in ci + exp[:it * expand] if i >= 0}
                # 2. members drop out, the others claim
                ids = [int(adj[sel[t // deg], t % deg]) if sel[t // deg] >= 0 else -1
                       for t in range(slots)]
                pos = [-1] * slots
                for t in rng.permutation(slots):
                    if ids[t] >= 0 and not mset.has(ids[t]):
                        pos[t] = claims.claim(ids[t], int(t))
                kept = [t for t in range(slots) if pos[t] >= 0 and claims.tags[pos[t]] == t + 1]
                # 3. the claims reset, an entry a slot: the table is empty again
                for t in range(slots):
                    if pos[t] >= 0:
                        claims.ids[pos[t]], claims.tags[pos[t]] = EMPTY, EMPTY
                assert all(i == EMPTY for i in claims.ids)
                n_scored += len(kept)
                v = (scorer(b, kept, ids) if scorer else
                     {t: np.float32(dist[b, ids[t]]) for t in kept})
                keys_c = [(_f2key(v[t]) << 32) | t for t in kept if v[t] < cd[ef - 1]]
                keys_r = [(_f2key(v[t]) << 32) | t for t in kept
                          if k_res and v[t] < rd[k_res - 1] and allowed[ids[t]]]
                runs_c, runs_r = _runs_sorted(keys_c, rng), _runs_sorted(keys_r, rng)

                def new_of(t):
                    return v[t], ids[t]

                # 4. the places, then the merges in place
                place_c = _places(cd, runs_c, new_of, ef)
                first = min([r for r in place_c.values() if r < ef], default=ef)
                ev["in_place_from"] += first

                def evicted(i, x):
                    if not x and i >= 0:
                        mset.delete(i)
                        evicted_ids.add(i)

                _shift(cd, ci, cx, runs_c, first, chunk, evicted)
                entering = []
                for key, r in place_c.items():
                    if r < ef:
                        t = key & 0xFFFFFFFF
                        cd[r], ci[r], cx[r] = v[t], ids[t], 0
                        entering.append(ids[t])
                        ev["reentered"] += ids[t] in evicted_ids
                for j in rng.permutation(len(entering)):
                    mset.add(entering[j])
                cursor = min(cursor, first)
                if k_res:
                    place_r = _places(rd, runs_r, new_of, k_res)
                    first_r = min([r for r in place_r.values() if r < k_res], default=k_res)
                    _shift(rd, ri, [0] * k_res, runs_r, first_r, chunk, lambda i, x: None)
                    for key, r in place_r.items():
                        if r < k_res:
                            t = key & 0xFFFFFFFF
                            rd[r], ri[r] = v[t], ids[t]
                if mset.used > 3 * ((1 << mbits) >> 2) - ins:
                    ev["rebuilds"] += 1
                    ev["tombs"] += mset.tombs
                    mset = _MemberSet(mbits)
                    for i in ci + exp[:(it + 1) * expand]:
                        if i >= 0:
                            mset.add(i)
        ev["tombs"] += mset.tombs
        out[0][b], out[1][b], out[4][b] = cd, ci, exp
        if k_res:
            out[2][b], out[3][b] = rd, ri
        out[5][b] = (n_exp, n_scored)
    return (*out, ev)


CASES = ["plain", "filtered", "repeats", "inf", "wide", "reenter", "rebuild"]


@pytest.mark.parametrize("case", CASES)
def test_k8_wide_loop_equals_the_plain_beam(case):
    """The wide loop's incremental member set, cursor, per-slot claim resets
    and in-place merges give `_beam_plain`'s buffers, results, expanded ids
    and stats exactly. `wide` runs the merge a block of 16 entries at a
    time, so a merge spans several blocks as at ef 1,600; `reenter` seeds
    half the buffer above its true distances, so seeds are evicted
    unexpanded and come back into the buffer through a later expansion;
    `rebuild` expands one node a step over a member set a quarter of the
    kernel's size, which passes its threshold and is rebuilt from its
    members."""
    rng = np.random.default_rng(CASES.index(case) + 10)
    n, deg, b = (1200, 8, 12) if case == "wide" else (400, 8, 12)
    ef, expand, loops = (48, 8, 6) if case == "wide" else (10, 2, 12)
    if case == "reenter":
        n, ef, expand, loops = 120, 12, 1, 30
    if case == "rebuild":
        expand, loops = 1, 40
    adj = _graph(rng, n, deg, repeats=case in ("repeats", "filtered", "wide"),
                 mod=1 << _mbits(ef, loops * expand, min(ef, expand * deg)))
    # small integer distances: ties at every rank, the worst included
    dist = rng.integers(0, 40, (b, n)).astype(np.float32)
    if case == "inf":
        dist[rng.random((b, n)) < 0.15] = np.inf
    n_seed = 8 if case == "reenter" else 4
    seed_i = np.stack([rng.choice(n, n_seed, replace=False) for _ in range(b)]).astype(np.int32)
    seed_i[0] = -1                         # a query with no seed
    seed_d = np.take_along_axis(dist, seed_i.clip(0), 1)
    if case == "reenter":
        seed_d[:, n_seed // 2:] += 100     # above their distances as neighbours
    seed_d[seed_i < 0] = np.inf
    kw = dict(ef=ef, loops=loops, expand=expand)
    if case in ("filtered", "wide"):
        kw.update(allowed=rng.random(n) < 0.5, k_res=6)
    got = _k8_wide_replay(adj, dist, seed_i, seed_d, seed=3,
                          chunk=16 if case == "wide" else WIDE_CHUNK,
                          smaller_set=2 if case == "rebuild" else 0, **kw)
    want = _k8_plain(adj, dist, seed_i, seed_d, **kw)
    for name, g, w in zip(("cand_d", "cand_i", "res_d", "res_i", "exp_ids", "stats"), got, want):
        if w is None:
            continue
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")
    events = got[-1]
    assert events["tombs"] > 0             # evicted ids left the set
    assert events["cursor_skips"] > 0 and events["in_place_from"] > 0
    if case == "reenter":
        assert events["reentered"] > 0
    assert (events["rebuilds"] > 0) == (case == "rebuild")


def test_member_set_rebuild_bound():
    """The set never fills: with MT = 2^mbits >= 2 (ef + exp_cap) + ins,
    a rebuild leaves at most ef + exp_cap entries in use, below the
    threshold 3 MT / 4 - ins, and one step adds at most ins = min(slots,
    ef), so the entries in use stay under 3 MT / 4."""
    for ef in (1, 10, 64, 1500, 1600, 4000):
        for loops, expand, deg in ((12, 2, 8), (600, 4, 32), (1, 40, 32), (3, 1, 2000)):
            exp_cap, slots = loops * expand, expand * deg
            if expand > ef:
                continue
            ins = min(slots, ef)
            mt = 1 << _mbits(ef, exp_cap, ins)
            thresh = 3 * (mt >> 2) - ins
            assert ef + exp_cap <= thresh
            assert thresh + ins <= 3 * mt // 4 < mt
