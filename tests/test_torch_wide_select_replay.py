"""K1 wide's dedup tail and K7 wide's cluster scan, replayed on the CPU.

K1's wide form (`kernels/csrc/probe_wide.cu` probe_tail_wide_kernel) turns
K2's m winners of a row into the probe's outputs. Under replicas every id
claims its entry of a table (graph_util.cuh: linear probing, the claim by
rank t lowers the tag to t + 1 with atomicMin, in whatever order the
threads race; an id claims as id + 1, so -1 is a key too), and a winner
survives when it is finite and its own claim holds the tag: the first
copy of each id. The survivors' places come from a prefix count by tiles
of 1024 winners (a ballot and popc a warp, a scan of the 32 warps'
counts), and the first k are written. `_tail_replay` replays that in numpy
and must equal `_probe_select_plain` (the reference's mask_duplicates and
top-k as torch ops) entry for entry: m in the thousands with many
repeated ids, k above and below the survivors, +inf lanes, candidate mode.

K7's wide form (`kernels/csrc/hnsw_select_wide.cu` select_cluster_kernel)
holds a target's window of rows over a cluster of `ctas` CTAs, an equal
share of the candidate positions each. Every CTA dedups and sorts all W;
the scan then runs in batches of up to 8 alive candidates (valid,
undecided, below alpha times their min). A batch's pair columns are
computed first; every CTA decides the batch in order from the batch
members' mins before it (read from their owners' published copies) and
the triangle of the batch's own pairs; each owner folds the takes into its
own later candidates' mins and publishes them and their alive bits, in the
buffer of the next batch's parity. `_k7_cluster_replay` replays that, CTA
by CTA, and must give `hnsw_select_plain`'s (and the presorted mode's
`hnsw_select_sorted_plain`'s) sel_i, sel_d and n_pairs exactly: W not a
multiple of the CTAs, duplicates and the target among the candidates,
alpha 1.0 and 1.2, every metric, and batches of 1 to 8.
"""

import numpy as np
import pytest
import torch

from test_torch_beam_replay import EMPTY, INF, _f2key, _pair, _rows, _Table, _table_bits
from turdb_tpu_torch import kernels

torch.set_num_threads(1)

TAIL_THREADS = 1024   # probe_wide.cu PT_THREADS: a tile of the prefix count


# ---------------------------------------------------------------------------
# K1 wide's tail

def _tail_replay(sel_d, sel_pos, cells, members, k, m, replicated, mode, rng):
    """probe_tail_wide_kernel over one row: (distances, ids[, positions])."""
    lcap = members.shape[1]
    p, lane = sel_pos // lcap, sel_pos % lcap
    cell = cells[p]
    ids = members[cell, lane].astype(np.int64)
    d = np.where(sel_d == 0, np.float32(0), sel_d).astype(np.float32)   # key2f(f2key(.))
    if mode == kernels.MODE_CAND:
        return d, ids, cell * lcap + lane
    finite = np.isfinite(d)
    keep = finite.copy()
    if replicated:
        table = _Table(_table_bits(m))
        for i in rng.permutation(m):                  # the claims race
            assert ids[i] + 1 != EMPTY
            table.claim(int(ids[i]) + 1, int(i))
        keep &= np.array([table.tags[table.insert(int(ids[i]) + 1)] == i + 1
                          for i in range(m)])
    out_d = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    base = 0
    for t0 in range(0, m, TAIL_THREADS):
        if base >= k:
            break
        tile = np.zeros(TAIL_THREADS, bool)
        n = min(TAIL_THREADS, m - t0)
        tile[:n] = keep[t0:t0 + n]
        warps = tile.reshape(-1, 32)
        counts = warps.sum(1)
        before = np.concatenate([[0], np.cumsum(counts)[:-1]])   # the scan of the warps' counts
        for w, lanes in enumerate(warps):
            for lane_i in np.nonzero(lanes)[0]:
                o = base + before[w] + int(lanes[:lane_i].sum())   # popc of the lanes below
                if o < k:
                    out_d[o], out_i[o] = d[t0 + 32 * w + lane_i], ids[t0 + 32 * w + lane_i]
        base += int(counts.sum())
    return out_d, out_i


def _tail_case(seed, b, p, lcap, n_ids):
    """Per-row distances over P cells of L lanes whose ids repeat (replicas
    of a few hundred ids), with +inf lanes and ties."""
    rng = np.random.default_rng(seed)
    nb = 3 * p
    members = rng.integers(0, n_ids, (nb, lcap)).astype(np.int32)
    members[rng.random((nb, lcap)) < 0.05] = -1
    cells = np.stack([rng.choice(nb, p, replace=False) for _ in range(b)]).astype(np.int32)
    dist = rng.integers(0, 400, (b, p * lcap)).astype(np.float32) / 8   # ties everywhere
    ids = members[cells].reshape(b, -1)
    dist[(ids < 0) | (rng.random(dist.shape) < 0.3)] = np.inf
    return rng, torch.as_tensor(dist), torch.as_tensor(cells), torch.as_tensor(members)


@pytest.mark.parametrize("m, k", [(2500, 300), (4800, 2400), (4800, 4800), (9000, 700)])
def test_tail_claims_and_prefix_count_equal_the_plain_dedup(m, k):
    """Top-k mode under replicas: the claim table's first copies and the
    tiled prefix count give the plain version's mask_duplicates + top-k;
    k = 2,400 and 4,800 of 4,800 run past the survivors (padded rows),
    the others stop inside the first tiles."""
    rng, dist, cells, members = _tail_case(m + k, 3, 60, 160, 700)
    lcap = members.shape[1]
    ids = torch.gather(members[cells.long()].reshape(3, -1), 1,
                       torch.arange(dist.shape[1]).expand(3, -1))
    want_d, want_i = kernels._probe_select_plain(dist, ids, cells, lcap, k, m, True,
                                                 kernels.MODE_TOPK)
    sel_d, sel_pos = kernels.topk_rows_plain(dist, m)
    short = 0
    for r in range(3):
        got_d, got_i = _tail_replay(sel_d[r].numpy(), sel_pos[r].numpy(), cells[r].numpy(),
                                    members.numpy(), k, m, True, kernels.MODE_TOPK, rng)
        np.testing.assert_array_equal(got_d, want_d[r].numpy())
        np.testing.assert_array_equal(got_i, want_i[r].numpy())
        short += int((got_i < 0).sum() > 0)
    assert short == (3 if k >= 2400 else 0)


@pytest.mark.parametrize("mode", [kernels.MODE_TOPK, kernels.MODE_CAND])
def test_tail_without_replicas_and_in_candidate_mode(mode):
    """Without replicas the first k finite winners are written as they
    come (m = k); candidate mode writes all m with their flat positions
    cell*L + lane, repeated ids and +inf lanes included."""
    m = 3000
    rng, dist, cells, members = _tail_case(7 + mode, 2, 40, 128, 300)
    lcap = members.shape[1]
    ids = members[cells.long()].reshape(2, -1)
    want = kernels._probe_select_plain(dist, ids, cells, lcap, m, m, False, mode)
    sel_d, sel_pos = kernels.topk_rows_plain(dist, m)
    for r in range(2):
        got = _tail_replay(sel_d[r].numpy(), sel_pos[r].numpy(), cells[r].numpy(),
                           members.numpy(), m, m, False, mode, rng)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[r].numpy())


# ---------------------------------------------------------------------------
# K7 wide's cluster scan

def _k7_sort(d, ids, target, presorted):
    """The dedup (claims, first copy wins; the target and -1 out) and the
    sort by (f2key(distance), position): (ids, distances) by position with
    the dropped at -1 / +inf, and the positions in sorted order."""
    w = len(ids)
    if presorted:
        return ids.copy(), np.where(ids >= 0, d, INF).astype(np.float32), np.arange(w)
    t = _Table(_table_bits(w))
    pos = [t.claim(int(i), j) if i >= 0 and i != target else -1 for j, i in enumerate(ids)]
    keep = np.array([pos[j] >= 0 and t.tags[pos[j]] == j + 1 for j in range(w)])
    dist = np.where(keep, d, INF).astype(np.float32)
    order = np.array(sorted(range(w), key=lambda j: (_f2key(dist[j]), j)))
    return np.where(keep, ids, -1), dist, order


def _k7_cluster_replay(pair, cid, dist, order, sel_cap, *, deg, alpha, ctas, nspec):
    """select_cluster_kernel's scan and output for one target. cid / dist
    by position; order: sorted place -> position; pair[s, k]: the pair
    distance of sorted later s to sorted take k."""
    w = len(cid)
    share = -(-w // ctas)
    assert (ctas - 1) * share < w
    owner = order // share                      # by sorted place
    a32 = np.float32(alpha)
    cs = cid[order][:sel_cap]
    ds = dist[order][:sel_cap]
    valid = cs >= 0
    n_valid = int(valid.sum())
    mins = [np.full(sel_cap, INF, np.float32) for _ in range(ctas)]   # each CTA its own
    pub = [[np.full(sel_cap, INF, np.float32) for _ in range(2)] for _ in range(ctas)]
    pub_alive = [[None, None] for _ in range(ctas)]
    alive = valid & (ds < a32 * INF)
    taken = np.zeros(sel_cap, bool)
    nxt = cnt = pairs = batch = 0
    while cnt < deg:
        par = batch & 1
        if batch > 0:                           # the owners' published alive bits
            alive = np.logical_or.reduce([pub_alive[r][par] for r in range(ctas)])
        spec = [s for s in range(nxt, sel_cap) if alive[s]][:nspec]
        if not spec:
            break
        last = spec[-1]
        tri = {(i, k): pair[spec[k], spec[i]] for k in range(len(spec)) for i in range(k)}
        decisions = []
        for reader in range(ctas):              # every CTA decides the batch alike
            premin = [mins[reader][s] if owner[s] == reader else pub[owner[s]][par][s]
                      for s in spec]
            c, p, tk = cnt, pairs, []
            for k, s in enumerate(spec):
                if c >= deg:
                    break
                m = premin[k]
                for i in tk:
                    m = min(m, tri[i, k])
                if ds[s] < a32 * m:
                    tk.append(k)
                    c += 1
                    if c < deg:
                        p += n_valid - int(valid[:s + 1].sum())
            decisions.append((c, p, tuple(tk)))
        assert len(set(decisions)) == 1
        cnt, pairs, tk = decisions[0]
        taken[[spec[k] for k in tk]] = True
        nxt = last + 1
        batch += 1
        if cnt >= deg:
            break
        npar = batch & 1
        for r in range(ctas):                   # each owner folds its own candidates
            mine = np.zeros(sel_cap, bool)
            for s in range(last + 1, sel_cap):
                if owner[s] != r or not alive[s]:
                    continue
                m = mins[r][s]
                for k in tk:
                    m = min(m, pair[s, spec[k]])
                mins[r][s] = pub[r][npar][s] = m
                mine[s] = ds[s] < a32 * m
            pub_alive[r][npar] = mine
    sel_i = np.full(deg, -1, np.int32)
    sel_d = np.full(deg, INF, np.float32)
    o = 0
    for want in (True, False):
        for s in range(sel_cap):
            if o < deg and valid[s] and taken[s] == want:
                sel_i[o] = cs[s] if ds[s] < INF else -1
                sel_d[o] = ds[s]
                o += 1
    return sel_i, sel_d, pairs


def _check_k7(vectors, norms, targets, cand, cand_d, *, deg, metric, alpha, ctas, nspec):
    u, w = cand.shape
    presorted = cand_d is not None
    if presorted:
        want = kernels.hnsw_select_sorted_plain(vectors, cand, cand_d, deg=deg, metric=metric,
                                                alpha=alpha)
        d = cand_d.numpy()
        cap = w
    else:
        want = kernels.hnsw_select_plain(vectors, norms, targets, cand, deg=deg, metric=metric,
                                         alpha=alpha)
        t = targets.long()
        dots = torch.einsum("ud,uwd->uw", vectors[t], vectors[cand.clamp_min(0).long()])
        d = kernels._gathered_epilogue(dots, metric, norms[t][:, None],
                                       norms[cand.clamp_min(0).long()]).numpy()
        cap = kernels.select_cap(w, deg, alpha)
    for r in range(u):
        cid, dist, order = _k7_sort(d[r], cand[r].numpy(), -1 if presorted else int(targets[r]),
                                    presorted)
        cs = torch.as_tensor(cid[order][:cap], dtype=torch.int32)[None]
        pair = _pair(vectors, cs, metric)[0].numpy()
        got = _k7_cluster_replay(pair, cid, dist, order, cap, deg=deg, alpha=alpha, ctas=ctas,
                                 nspec=nspec)
        np.testing.assert_array_equal(got[0], want[0][r].numpy(), err_msg=f"row {r}")
        np.testing.assert_array_equal(got[1], want[1][r].numpy(), err_msg=f"row {r}")
        assert got[2] == int(want[2][r]), r


@pytest.mark.parametrize("ctas", [1, 2, 3, 4])
@pytest.mark.parametrize("metric, alpha", [(0, 1.2), (0, 1.0), (1, 1.2), (2, 1.0)])
def test_k7_cluster_scan_equals_the_plain_selection(ctas, metric, alpha):
    """Dedup, sort and the batched scan over 1-4 CTAs (W = 80: shares of
    80, 40, 27 / 27 / 26, 20) give hnsw_select_plain's rows and n_pairs,
    with duplicates, -1 and the target among the candidates, a row of no
    valid candidate, and COS / IP distances below zero."""
    rng = np.random.default_rng(100 * ctas + 10 * metric + int(alpha * 10))
    n, w, deg = 300, 80, 12
    vectors = _rows(rng, n, 24, metric)
    norms = (vectors * vectors).sum(1)
    targets = torch.as_tensor(rng.choice(n, 6, replace=False), dtype=torch.int32)
    cand = torch.as_tensor(rng.integers(0, n, (6, w)), dtype=torch.int32)
    cand[:, 5] = cand[:, 2]
    cand[:, 41] = cand[:, 39]
    cand[:, 11] = -1
    cand[:, 60] = targets
    cand[3] = -1                          # no valid candidate
    _check_k7(vectors, norms, targets, cand, None, deg=deg, metric=metric, alpha=alpha,
              ctas=ctas, nspec=8)


@pytest.mark.parametrize("nspec", [1, 2, 8])
@pytest.mark.parametrize("alpha", [1.0, 1.2, 50.0])
def test_k7_cluster_scan_presorted_and_batch_sizes(nspec, alpha):
    """The presorted mode (a beam's buffer: ascending, -1 / +inf at the
    end, no dedup) over 2 CTAs with batches of 1, 2 and 8 (a cluster's CTAs
    copy fewer of a batch's rows where d is wide): the plain version's
    rows and n_pairs; at alpha 50 every candidate is taken, so the deg-th
    take falls inside a batch."""
    rng = np.random.default_rng(nspec + int(alpha))
    n, w, deg = 200, 70, 16
    vectors = _rows(rng, n, 16, 0)
    cand = torch.as_tensor(np.stack([rng.choice(n, w, replace=False) for _ in range(5)]),
                           dtype=torch.int32)
    cand[1, 50:] = -1
    cand[2] = -1
    d_s = torch.as_tensor(np.sort(rng.random((5, w)).astype(np.float32) * 4, 1))
    d_s = torch.where(cand >= 0, d_s, kernels.INF)
    _check_k7(vectors, None, None, cand, d_s, deg=deg, metric=0, alpha=alpha, ctas=2,
              nspec=nspec)
