"""HNSW graph index on PyTorch (port of turdb_tpu/models/hnsw.py): the
bulk build, the insert waves, the graph search, the SQ8 / SQ16 graph store,
vacuum and the serving pack's entry points.

Graph layout (the reference's, after mod.rs:125-127): MAX_LEVELS = 4
levels, `adj0` [cap, M0 = 2M] int32 at level 0 and `adj_hi` 3 × [cap, M]
above it, -1 padded; `vectors` [cap, d] f32 (unit rows under COSINE),
`norms` [cap] ‖x‖² (+inf for empty slots), `levels` [cap] (-1 empty); the
entry point and the top level are host ints. `quantize_sq8` / `_sq16`
swap `vectors` for an `Sq8Rows` store (u8 / u16 codes with a per-row min
and scale; the norms stay exact f32) that the kernels dequantize on the
gather; `add`, `vacuum` and `pack_serving` dequantize first.

Search (`hnsw_search_impl`): the entry point seeds a beam per upper level
(K8 `hnsw_graph_beam`, ef = descent_ef, expand 2) whose whole sorted buffer
seeds the next level, or, when descent_ef is 1, the greedy walk through
all upper levels (K9 `hnsw_greedy`, up to GREEDY_LEVELS_MAX levels a
launch, top first); then the level-0 beam
(K8) with the filtered result buffer when a visibility mask applies, and
the k best (K2).

Insert waves (`build_wave_impl`, every `add` but the bulk load): stage
the rows; the descent of every row through the levels above its own;
from the top level down, for the rows connecting there, the
ef_construction beam (K8) and the diversity selection over its sorted
buffer (K7's presorted mode), their forward rows written at once; then,
level by level, each neighbour's reverse edges grouped by a stable sort
and its row re-selected (K7); then the entry point. The descent is the
one the graph's own search takes: the reference's greedy walk (K9, one
launch) when descent_ef is 1 (a graph built by waves), else, on a bulk
graph, a K8 beam of descent_ef a level (expand 2, `active` for the rows
that still descend there), whose best seeds the next level and then the
row's own connecting levels. This departs from the reference, whose
waves walk greedily into a bulk graph too: a bulk graph's level 0 is one
island per blob, so a greedy walk starts a row's level-0 beam in the
wrong island and links the row where its own query never goes.

Bulk build (`HnswIndex.add` on an empty index, n >= bulk_threshold): per
level, top-r candidates for every node, from the numpy host route
(n <= _BULK_BRUTE), the exact chunked scan (`torch.matmul` + K2, n <=
_BULK_EXACT) or the self-probe of a temporary probe-only IVF store (K3 to
build it, K2 + K4 to probe it); the alpha-diversity selection (K7
`hnsw_select`); the reverse edges (host C, or numpy); a union that keeps a
quota of them; then two rounds of navigability refinement of every upper level
(K8 beams with the expanded path as extra candidates, K7, reverse edges,
union). Vacuum rebuilds over the survivors through `add`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from turdb_tpu_torch.kernels import (
    EPI_IP,
    EPI_L2,
    GREEDY_LEVELS_MAX,
    hnsw_graph_beam,
    hnsw_greedy,
    hnsw_select,
    hnsw_select_sorted,
    topk_rows,
)
from turdb_tpu_torch.ops.distance import Metric, gathered_distances, normalize_rows, prep_norms
from turdb_tpu_torch.ops.quantize import Sq8Rows, sq_rows_encode
from turdb_tpu_torch.ops.topk import topk_smallest
from turdb_tpu_torch.utils.timing import count, span, tracing

# the reference's graph constants (turdb_tpu/config.py HNSW_*)
HNSW_M0 = 32
HNSW_M = 16
HNSW_MAX_LEVELS = 4
HNSW_DEFAULT_EF_CONSTRUCTION = 100
HNSW_DEFAULT_EF_SEARCH = 64
HNSW_BUILD_BATCH = 512

NIL = -1
INF = float("inf")


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    dim: int
    m0: int = HNSW_M0
    m: int = HNSW_M
    max_levels: int = HNSW_MAX_LEVELS
    metric: Metric = Metric.L2
    ef_construction: int = HNSW_DEFAULT_EF_CONSTRUCTION
    ef_search: int = HNSW_DEFAULT_EF_SEARCH

    @property
    def ml(self) -> float:
        return 1.0 / math.log(self.m)


class HnswState(NamedTuple):
    """The graph on the device; see the module docstring."""

    vectors: torch.Tensor   # [cap, d] f32, or an Sq8Rows store
    norms: torch.Tensor     # [cap] f32 ‖x‖², +inf when empty
    adj0: torch.Tensor      # [cap, M0] int32, -1 padded
    adj_hi: tuple           # (max_levels - 1) × [cap, M] int32
    levels: torch.Tensor    # [cap] int32, -1 when empty
    entry: int              # -1 when empty
    max_level: int          # -1 when empty


def init_state(cfg: HnswConfig, capacity: int, device) -> HnswState:
    return HnswState(
        vectors=torch.zeros((capacity, cfg.dim), device=device),
        norms=torch.full((capacity,), INF, device=device),
        adj0=torch.full((capacity, cfg.m0), NIL, dtype=torch.int32, device=device),
        adj_hi=tuple(torch.full((capacity, cfg.m), NIL, dtype=torch.int32, device=device)
                     for _ in range(cfg.max_levels - 1)),
        levels=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        entry=-1,
        max_level=-1,
    )


# ---------------------------------------------------------------------------
# level selection: deterministic from the row id
# ---------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
        0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(
        0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


def select_levels(row_ids: np.ndarray, cfg: HnswConfig) -> np.ndarray:
    """floor(-ln(u)·ml) with u from a hash of the row id, capped to the
    graph's levels (the reference's scheme, bit for bit)."""
    h = _splitmix64(np.asarray(row_ids, np.uint64))
    u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    u = np.clip(u, 1e-18, 1.0 - 1e-18)
    lvl = np.floor(-np.log(u) * cfg.ml).astype(np.int32)
    return np.minimum(lvl, cfg.max_levels - 1)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _greedy_level(adj, vectors, norms, q, qn, cur_i, cur_d, metric: Metric, lowest=None):
    """Best-neighbour walk of each query until it stops improving, at most
    GREEDY_CAP steps a level (K9): through `adj`, one level or a sequence
    walked top first, each query down to its `lowest` (see `hnsw_greedy`).
    A sequence runs in launches of at most GREEDY_LEVELS_MAX levels, top
    first, each from where the last left the queries: the walk is a chain,
    so this is the one walk (each launch's `lowest` counted from its own
    last level)."""
    adjs = [adj] if isinstance(adj, torch.Tensor) else list(adj)
    cur_i, cur_d = cur_i.contiguous(), cur_d.contiguous()
    for start in range(0, len(adjs), GREEDY_LEVELS_MAX):
        part = adjs[start:start + GREEDY_LEVELS_MAX]
        # levels are numbered from len - 1 (the first) down to 0; this part's
        # last level is numbered len(adjs) - start - len(part)
        low = (None if lowest is None else
               (lowest - (len(adjs) - start - len(part))).contiguous())
        cur_i, cur_d, _ = hnsw_greedy(part, vectors, norms, q, qn, cur_i, cur_d,
                                      metric=metric.value, lowest=low)
    return cur_i, cur_d


def count_beam(prefix: str, stats: torch.Tensor, deg: int, seeds: int) -> None:
    """The work counters of one beam launch while tracing (`utils.timing`):
    `<prefix>.queries` and `.seeds` (B, B × S), and from the launch's
    `stats` [B, 2] (nodes expanded, neighbours scored), summed on the
    device by one reduction: `.scored` and `.list_entries` (expanded × the
    level's degree)."""
    if not tracing():
        return
    b = stats.shape[0]
    tot = stats.sum(0, dtype=torch.int64)
    count(prefix + ".queries", b)
    count(prefix + ".seeds", b * seeds)
    count(prefix + ".scored", lambda: tot[1])
    count(prefix + ".list_entries", lambda: tot[0] * deg)


def _beam_level(adj, vectors, norms, q, qn, seed_i, seed_d, ef: int, iters: int,
                metric: Metric, active=None, allowed=None, k_res: int | None = None,
                expand: int = 4, return_expanded: bool = False, count_as: str | None = None):
    """The ef-beam over one adjacency level (K8, over the f32 rows or an
    Sq8Rows store), with the reference's returns: (cand_d, cand_i), plus (res_d,
    res_i) under `allowed`, or plus the expanded ids under
    `return_expanded`. Seeds are [B] or [B, S]; the first min(S, ef) are
    used. `count_as` names the launch's work counters (`count_beam`)."""
    if seed_i.dim() == 1:
        seed_i, seed_d = seed_i[:, None], seed_d[:, None]
    s = min(seed_i.shape[1], ef)
    out = hnsw_graph_beam(adj, vectors, norms, q, qn, seed_i[:, :s].contiguous(),
                          seed_d[:, :s].contiguous(), allowed, ef=ef, iters=iters,
                          metric=metric.value, expand=expand, k_res=k_res, active=active,
                          return_expanded=return_expanded)
    if count_as is not None:
        count_beam(count_as, out.stats, adj.shape[1], s)
    if allowed is not None:
        return out.cand_d, out.cand_i, out.res_d, out.res_i
    if return_expanded:
        return out.cand_d, out.cand_i, out.exp_ids
    return out.cand_d, out.cand_i


def _seed_from_entry(vectors, norms, q, qn, entry: int, metric: Metric):
    b = q.shape[0]
    cur_i = torch.full((b,), entry, dtype=torch.int32, device=q.device)
    if entry < 0:
        return cur_i, torch.full((b,), INF, device=q.device)
    ed = gathered_distances(q, vectors[entry].expand(b, 1, -1), metric,
                            vec_norms=norms[entry].expand(b, 1), q_norms=qn)[:, 0]
    return cur_i, ed.contiguous()


def hnsw_search_impl(state: HnswState, queries: torch.Tensor, allowed, *, cfg: HnswConfig,
                     k: int, ef: int, iters: int, filtered: bool, expand: int = 4,
                     descent_ef: int = 1):
    """Full k-NN query: descent from the top level to level 1, then the
    ef-beam at level 0 (see the module docstring). `allowed` is a [cap]
    bool mask (with `filtered`) or None. Returns ([B, k] distances
    ascending, [B, k] int32 slots, -1 padded)."""
    with span("turdb.hnsw.descent"):
        q = queries.float().contiguous()
        qn = prep_norms(q)
        cur_i, cur_d = _seed_from_entry(state.vectors, state.norms, q, qn, state.entry,
                                        cfg.metric)
        if descent_ef <= 1 and state.adj_hi:
            # levels max_levels - 1 .. 1 in one launch
            cur_i, cur_d = _greedy_level(state.adj_hi[::-1], state.vectors, state.norms, q, qn,
                                         cur_i, cur_d, cfg.metric)
        seeds_i, seeds_d = cur_i[:, None], cur_d[:, None]
        for lvl in range(cfg.max_levels - 1, 0, -1) if descent_ef > 1 else ():
            # the whole sorted beam seeds the next level
            seeds_d, seeds_i = _beam_level(state.adj_hi[lvl - 1], state.vectors, state.norms,
                                           q, qn, seeds_i, seeds_d, descent_ef, 2 * descent_ef,
                                           cfg.metric, expand=2, count_as="turdb.hnsw.descent")
    if filtered:
        with span("turdb.hnsw.beam"):
            _, _, res_d, res_i = _beam_level(state.adj0, state.vectors, state.norms, q, qn,
                                             seeds_i, seeds_d, ef, iters, cfg.metric,
                                             allowed=allowed, k_res=max(k, 16), expand=expand,
                                             count_as="turdb.hnsw.beam")
        return res_d[:, :k], res_i[:, :k]
    with span("turdb.hnsw.beam"):
        cand_d, cand_i = _beam_level(state.adj0, state.vectors, state.norms, q, qn, seeds_i,
                                     seeds_d, ef, iters, cfg.metric, expand=expand,
                                     count_as="turdb.hnsw.beam")
    with span("turdb.hnsw.merge"):
        return topk_smallest(cand_d, cand_i, k)


# ---------------------------------------------------------------------------
# build: neighbour selection
# ---------------------------------------------------------------------------

def _select_from_candidates(vectors, norms, targets, cand, deg: int, metric: Metric,
                            alpha: float = 1.0):
    """Diversity-select `deg` edges for each target from its candidates
    (K7): (sel_i [U, deg], sel_d [U, deg])."""
    sel_i, sel_d, _ = hnsw_select(vectors, norms, targets, cand, deg=deg,
                                  metric=metric.value, alpha=alpha)
    return sel_i, sel_d


def _union_rows(cand, deg: int):
    """First-occurrence dedup + compact to `deg` lanes, keeping the given
    priority order (duplicates and -1 sink to the end)."""
    w = cand.shape[-1]
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=cand.device), -1)
    dup = torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, dim=-1) | (cand < 0)
    key = torch.where(dup, w + 1, torch.arange(w, device=cand.device))
    order = torch.argsort(key, dim=-1, stable=True)[:, :deg]
    out = torch.gather(cand, 1, order)
    return torch.where(torch.gather(key, 1, order) <= w, out, NIL).to(torch.int32)


def _scatter_rows(adj, idx, rows):
    """adj[idx] = rows, in place (the reference's `_scatter_rows`)."""
    adj[idx] = rows
    return adj


def _merge_reverse(adj, rev, deg: int, rcap: int, chunk: int = 16384):
    """The union with a guaranteed reverse quota: forward head, reverse
    edges by rank, forward tail, deduplicated in that order (no re-pruning:
    re-pruning re-creates directed dead ends). `chunk` rows at a time bound
    the [chunk, w, w] comparison."""
    keep = max(deg - rcap, deg // 2)
    merged = torch.cat([adj[:, :keep], rev, adj[:, keep:]], dim=1)
    out = torch.empty((len(merged), deg), dtype=torch.int32, device=merged.device)
    for s in range(0, len(merged), chunk):
        out[s:s + chunk] = _union_rows(merged[s:s + chunk], deg)
    return out


# ---------------------------------------------------------------------------
# build: bulk (initial load)
# ---------------------------------------------------------------------------

_BULK_MIN = 8192           # below this the reference's wave path builds
_BULK_BRUTE = 4096         # subsets up to this take the numpy host route
_BULK_EXACT = 1 << 17      # subsets up to this get chunked exact kNN; above,
                           # the self-probe of a temporary IVF store


def _topr_vs_subset(xc, xcn, sub_vecs, sub_norms, r: int, metric: Metric):
    """Top-r nearest within a SUBSET for a chunk of rows: `torch.matmul`
    and K2 with the L2 (or IP) epilogue; +inf-norm subset rows are
    padding under every metric. Returns subset positions [B, r] (-1 pad)."""
    dots = xc @ sub_vecs.T
    valid = torch.isfinite(sub_norms)
    if metric is Metric.IP:
        nd, pos = topk_rows(dots, r, colvalid=valid, epilogue=EPI_IP)
    else:
        nd, pos = topk_rows(dots, r, rown=xcn, coln=sub_norms, colvalid=valid, epilogue=EPI_L2)
    return torch.where(torch.isinf(nd), NIL, pos)


def _bulk_reverse_lists(sub_slots, adj, seld, rcap: int):
    """Host-side reverse-edge lists: for each node, the up-to-rcap NEAREST
    nodes that selected it as a forward edge (the batched analog of the
    reference's bidirectional edge write, mod.rs:1067-1077). The host C
    pass of native/hnsw_host.cpp where g++ built it, as the reference
    does; else numpy, whose (target, distance) sort is one radix argsort of
    a packed uint64. Both give the same lists (the C pass keeps the stable
    argsort's order)."""
    from turdb_tpu_torch.native.build import reverse_topk

    sub_slots = np.ascontiguousarray(sub_slots, np.int64)
    ns, deg = adj.shape
    pos_arr = np.full(int(sub_slots.max()) + 1, -1, np.int64)
    pos_arr[sub_slots] = np.arange(ns)
    nat = reverse_topk(sub_slots, adj, seld, pos_arr, rcap)
    if nat is not None:
        return nat
    src = np.repeat(sub_slots, deg)
    tgt = adj.reshape(-1)
    dist = seld.reshape(-1)
    v = tgt >= 0
    src, tgt, dist = src[v], tgt[v], dist[v]
    rev = np.full((ns, rcap), -1, np.int32)
    if len(tgt) == 0:
        return rev
    u = np.ascontiguousarray(dist, np.float32).view(np.uint32)
    flip = np.where((u >> 31) != 0, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
    key = (tgt.astype(np.uint64) << np.uint64(32)) | (u ^ flip).astype(np.uint64)
    order = np.argsort(key, kind="stable")
    t_s, s_s = tgt[order], src[order]
    first = np.zeros(len(t_s), bool)
    first[0] = True
    first[1:] = t_s[1:] != t_s[:-1]
    starts = np.flatnonzero(first)
    run_id = np.cumsum(first) - 1
    rank = np.arange(len(t_s)) - starts[run_id]
    keep = rank < rcap
    rev[pos_arr[t_s[keep]], rank[keep]] = s_s[keep]
    return rev


def _bulk_layer_adj_host(sub_slots, x_sub, deg: int, metric: Metric, rcap: int = 16,
                         r_mult: int = 2, alpha: float = 1.0):
    """numpy build of one small layer (n <= _BULK_BRUTE): all-pairs
    distances, top-r, the diversity rule, the reverse quota and the union,
    as the device route does them."""
    n = len(sub_slots)
    slots = np.asarray(sub_slots, np.int64)
    if n <= 1:
        return np.full((n, deg), NIL, np.int32)
    x = np.asarray(x_sub, np.float32)
    dots = x @ x.T
    if metric is Metric.COSINE:
        D = 1.0 - dots               # rows pre-normalized upstream
    elif metric is Metric.IP:
        D = -dots
    else:
        nrm = np.einsum("ij,ij->i", x, x)
        D = np.maximum(nrm[:, None] + nrm[None, :] - 2.0 * dots, 0.0)
    np.fill_diagonal(D, np.inf)
    r = min(r_mult * deg, n - 1)
    pos = np.argpartition(D, r - 1, axis=1)[:, :r]
    dr = np.take_along_axis(D, pos, axis=1).astype(np.float32)
    o = np.argsort(dr, axis=1, kind="stable")
    pos = np.take_along_axis(pos, o, axis=1)          # ascending by dist
    dr = np.take_along_axis(dr, o, axis=1)
    pair = D[pos[:, :, None], pos[:, None, :]]        # [n, r, r]
    min_sel = np.full((n, r), np.inf, np.float32)
    count = np.zeros(n, np.int64)
    sel = np.zeros((n, r), bool)
    for j in range(r):
        take = (dr[:, j] < alpha * min_sel[:, j]) & (count < deg)
        sel[:, j] = take
        min_sel = np.where(take[:, None], np.minimum(min_sel, pair[:, :, j]), min_sel)
        count += take
    # selected (asc dist) first, skipped backfill (asc dist) after
    key = dr + np.where(sel, np.float32(0.0), np.float32(1e30))
    order = np.argsort(key, axis=1, kind="stable")[:, :deg]
    adj = slots[np.take_along_axis(pos, order, axis=1)].astype(np.int32)
    seld = np.take_along_axis(dr, order, axis=1)
    if r < deg:
        adj = np.concatenate([adj, np.full((n, deg - r), NIL, np.int32)], axis=1)
        seld = np.concatenate([seld, np.full((n, deg - r), np.inf, np.float32)], axis=1)
    rev = _bulk_reverse_lists(slots, adj, seld, rcap)
    keep = max(deg - rcap, deg // 2)
    merged = np.concatenate([adj[:, :keep], rev, adj[:, keep:]], axis=1)
    w2 = merged.shape[1]
    eq = merged[:, :, None] == merged[:, None, :]
    earlier = np.tril(np.ones((w2, w2), bool), k=-1)
    dup = (eq & earlier).any(-1) | (merged < 0)
    keyu = np.where(dup, w2 + 1, np.arange(w2))
    orderu = np.argsort(keyu, axis=1, kind="stable")[:, :deg]
    out = np.take_along_axis(merged, orderu, axis=1)
    kept = np.take_along_axis(keyu, orderu, axis=1) <= w2
    return np.where(kept, out, NIL).astype(np.int32)


def _self_probe_scan(vectors, sslots, x_sub, r: int, metric: Metric, chunk: int = 4096):
    """Candidates of a large layer: cluster it into a temporary probe-only
    IVF store (sq8, no rows, no rerank, boundary replicas) and let every
    row query it for its top r. Self hits come back; the selection drops
    them. The IP index keeps IP; every other metric probes by L2."""
    from turdb_tpu_torch.models.ivf import IvfIndex, ivf_search_impl

    tmp = IvfIndex(dim=x_sub.shape[1], metric=Metric.IP if metric is Metric.IP else Metric.L2,
                   replicate=True, sq8=True, keep_f32=False, rerank=0, device=vectors.device)
    tmp.add(x_sub)
    if tmp.state is None:
        tmp.train()
    n = len(sslots)
    nprobe = min(8, tmp.cfg.n_clusters)
    cand = torch.empty((n, r), dtype=torch.int32, device=vectors.device)
    for s in range(0, n, chunk):
        qb = vectors[sslots[s:s + chunk]]
        _, ids = ivf_search_impl(tmp.state, qb, None, cfg=tmp.cfg, k=r, nprobe=nprobe)
        cand[s:s + chunk] = torch.where(ids >= 0, sslots[ids.clamp_min(0).long()], NIL)
    return cand


def _bulk_layer_adj(vectors, norms, sub_slots, x_sub, deg: int, metric: Metric,
                    rcap: int = 16, chunk: int = 16384, r_mult: int = 2, alpha: float = 1.0):
    """One layer's adjacency for the subset `sub_slots` (global slot ids):
    candidates by the route its size picks, the forward selection (K7), the
    reverse edges (host C, or numpy) and the union. Returns [len(sub), deg]
    int32 rows of global slot ids on the vectors' device.

    Upper layers pass r_mult=8 and alpha>1: a pure exact-kNN pool yields
    only short edges, and the wide pool with the relaxed rule restores the
    mid-range ones."""
    n = len(sub_slots)
    r = r_mult * deg
    dev = vectors.device
    if n <= _BULK_BRUTE:
        rows = _bulk_layer_adj_host(sub_slots, x_sub, deg, metric, rcap=rcap, r_mult=r_mult,
                                    alpha=alpha)
        return torch.as_tensor(rows, device=dev)
    sslots = torch.as_tensor(np.asarray(sub_slots, np.int64), device=dev)
    if n <= _BULK_EXACT:
        # chunked exact kNN against the whole subset
        sv, sn = vectors[sslots], norms[sslots]
        rr = min(r, n - 1)
        cand = torch.empty((n, rr), dtype=torch.int32, device=dev)
        for s in range(0, n, 4096):
            rows = sslots[s:s + 4096]
            pos = _topr_vs_subset(vectors[rows], norms[rows], sv, sn, rr, metric)
            cand[s:s + 4096] = torch.where(pos >= 0, sslots[pos.clamp_min(0).long()], NIL)
        del sv, sn
    else:
        cand = _self_probe_scan(vectors, sslots, x_sub, r, metric)
    targets = sslots.to(torch.int32)
    adj = torch.empty((n, deg), dtype=torch.int32, device=dev)
    seld = torch.empty((n, deg), device=dev)
    for s in range(0, n, chunk):
        adj[s:s + chunk], seld[s:s + chunk] = _select_from_candidates(
            vectors, norms, targets[s:s + chunk], cand[s:s + chunk], deg, metric, alpha)
    del cand
    rev = _bulk_reverse_lists(sub_slots, adj.cpu().numpy(), seld.cpu().numpy(), rcap)
    return _merge_reverse(adj, torch.as_tensor(rev, device=dev), deg, rcap)


def _refine_chunk(adj, vectors, norms, rows, entry: int, *, deg: int, ef: int, iters: int,
                  metric: Metric):
    """One refinement step for a chunk of layer nodes: beam-search each
    node through the current layer from the entry point (K8), then
    alpha-select `deg` edges (K7) from the beam, the expanded path and the
    current edges. The path nodes are the long-range candidates an
    exact-kNN pool lacks."""
    q = vectors[rows.long()]
    qn = norms[rows.long()]
    seed_i, seed_d = _seed_from_entry(vectors, norms, q, qn, entry, metric)
    _, cand_i, exp_ids = _beam_level(adj, vectors, norms, q, qn, seed_i, seed_d, ef, iters,
                                     metric, return_expanded=True)
    cand = torch.cat([cand_i, exp_ids, adj[rows.long()]], dim=1)
    return _select_from_candidates(vectors, norms, rows, cand, deg, metric, alpha=1.2)


def _refine_layer_adj(adj_full, vectors, norms, sub_slots, deg: int, metric: Metric,
                      entry: int, rounds: int = 2, chunk: int = 4096, rcap: int = 16):
    """Vamana-style navigability refinement of one upper layer, in place:
    each round searches every layer node through the current graph,
    re-selects its edges from path-derived candidates, then re-applies the
    reverse merge. Every row of a round reads the same snapshot (Jacobi
    order), so the round is one batch."""
    n = len(sub_slots)
    ef = max(2 * deg, 32)
    iters = ef + ef // 2
    gslots = torch.as_tensor(np.asarray(sub_slots, np.int64), device=vectors.device)
    rows32 = gslots.to(torch.int32)
    for _ in range(rounds):
        parts = [_refine_chunk(adj_full, vectors, norms, rows32[s:s + chunk], entry, deg=deg,
                               ef=ef, iters=iters, metric=metric) for s in range(0, n, chunk)]
        rows_out = torch.cat([p[0] for p in parts])
        seld = torch.cat([p[1] for p in parts])
        rev = _bulk_reverse_lists(sub_slots, rows_out.cpu().numpy(), seld.cpu().numpy(), rcap)
        _scatter_rows(adj_full, gslots, _merge_reverse(
            rows_out, torch.as_tensor(rev, device=vectors.device), deg, rcap))
    return adj_full


# ---------------------------------------------------------------------------
# build: the insert waves (every add but the bulk load)
# ---------------------------------------------------------------------------

def _level_adj(state: HnswState, lvl: int):
    return state.adj0 if lvl == 0 else state.adj_hi[lvl - 1]


def _stage_vectors_core(vectors, norms, levels, vecs, slots, lvls):
    """Write a wave's rows, norms and levels into the state (in place) and
    return the rows and norms as the wave's queries."""
    q = vecs.float()
    qn = prep_norms(q)
    vectors[slots] = q
    norms[slots] = qn
    levels[slots] = lvls
    return q, qn


def _wave_level_core(adj, vectors, norms, q, qn, cur_i, cur_d, connect, *, metric: Metric,
                     efc: int, iters: int, deg_out: int, count_as: str | None = None):
    """One level of an insert wave (the reference's insert connection
    phase): for the rows that connect here (`connect`, a host bool array)
    the ef_construction beam (K8 with `active`) from their seeds cur_i /
    cur_d and the diversity selection over its whole sorted buffer (K7's
    presorted mode, alpha 1); the other rows pass their seeds through
    (their greedy descent, the reference's insert descent phase, ran for
    all levels at once before: `build_wave_impl`). The beam and the
    selection are skipped when no row connects, as the reference's masks
    discard them. Returns the next level's seeds (the beam's best where a
    row connects, else cur) and the selection [B, deg_out] with its
    distances, -1 / +inf where a row does not connect. `count_as` names
    the beam's work counters (`count_beam`)."""
    b, dev = q.shape[0], q.device
    if not connect.any():
        return (cur_i, cur_d, torch.full((b, deg_out), NIL, dtype=torch.int32, device=dev),
                torch.full((b, deg_out), INF, device=dev))
    conn = torch.as_tensor(connect, device=dev)
    cand_d, cand_i = _beam_level(adj, vectors, norms, q, qn, cur_i, cur_d, efc, iters, metric,
                                 active=conn, count_as=count_as)
    sel_i, sel_d, _ = hnsw_select_sorted(vectors, cand_i, cand_d, deg=deg_out,
                                         metric=metric.value, alpha=1.0)
    keep = conn[:, None]
    return (torch.where(conn, cand_i[:, 0], cur_i), torch.where(conn, cand_d[:, 0], cur_d),
            torch.where(keep, sel_i, NIL), torch.where(keep, sel_d, INF))


def _write_forward(adj, slots, sel):
    """The wave's rows at one level: its selections, -1 padded to deg."""
    row = torch.full((len(slots), adj.shape[1]), NIL, dtype=torch.int32, device=adj.device)
    w = min(sel.shape[1], adj.shape[1])
    row[:, :w] = sel[:, :w]
    adj[slots] = row


def _reverse_dense_core(adj, vectors, norms, targets, new_ids, dists, metric: Metric,
                        rcap: int = 16):
    """Apply a wave level's reverse edges, in place: the new node
    `new_ids[e]` becomes a candidate edge of `targets[e]` (-1: none) at
    distance `dists[e]`. The edges are grouped by target, nearest first,
    by one stable sort of a packed int64 key (the target in the high 32
    bits, the distance's f32 bits flipped to sort as unsigned in the low
    32: the reference's lexsort on (target, distance)); each target's
    first rcap are appended to its current row and the row is re-selected
    (K7, `_prune_rows`: alpha 1, whose window of the deg + rcap candidates
    never binds). The reference re-selects the targets in chunks of 2048
    under a fori_loop; the targets are unique and a chunk reads only its
    own rows, so one launch over all of them gives the same rows."""
    valid = targets >= 0
    t, n, d = targets[valid].long(), new_ids[valid], dists[valid]
    if t.numel() == 0:
        return adj
    # -0.0 + 0.0 is +0.0: the two zeros tie in the lexsort, so one key
    u = (d + 0.0).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    flip = torch.where(u >= 0x80000000, 0xFFFFFFFF, 0x80000000)
    order = torch.sort((t << 32) | (u ^ flip), stable=True).indices
    t_s, n_s = t[order], n[order]
    pos = torch.arange(len(t_s), device=t.device)
    first = torch.ones_like(t_s, dtype=torch.bool)
    first[1:] = t_s[1:] != t_s[:-1]
    grp = torch.cumsum(first, 0) - 1
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    uniq = t_s[first]
    # edges ranked past rcap (the farthest) land in a last column, dropped
    appends = torch.full((len(uniq), rcap + 1), NIL, dtype=torch.int32, device=adj.device)
    appends[grp, rank.clamp_max(rcap)] = n_s.to(torch.int32)
    cand = torch.cat([adj[uniq], appends[:, :rcap]], dim=1)
    rows, _, _ = hnsw_select(vectors, norms, uniq.to(torch.int32), cand, deg=adj.shape[1],
                             metric=metric.value, alpha=1.0)
    adj[uniq] = rows
    return adj


def _entry_update_core(entry: int, max_level: int, slots, lvls):
    """Entry-point promotion (reference mod.rs:1079-1081) and the
    empty-graph bootstrap, on host ints: the wave's first row of its
    highest level becomes the entry when that level passes max_level or
    the graph has no entry."""
    if len(lvls) == 0:
        return entry, max_level
    best = int(np.argmax(lvls))
    top = int(lvls[best])
    if top > max_level or entry < 0:
        entry = int(slots[best])
    return entry, max(max_level, top)


def _beam_descent(state: HnswState, q, qn, cur_i, cur_d, levels: np.ndarray, *,
                  cfg: HnswConfig, descent_ef: int):
    """The descent of a wave's rows into a bulk graph, as its search takes
    it: from the top level down to level 1, a K8 beam of descent_ef (expand
    2) for the rows whose own level lies below (`active`), seeded by each
    row's best so far; its best seeds the next level. Levels no row
    descends through launch nothing."""
    dev = q.device
    for lvl in range(cfg.max_levels - 1, 0, -1):
        walks = levels < lvl
        if not walks.any():
            continue
        act = torch.as_tensor(walks, device=dev)
        cand_d, cand_i = _beam_level(state.adj_hi[lvl - 1], state.vectors, state.norms, q, qn,
                                     cur_i, cur_d, descent_ef, 2 * descent_ef, cfg.metric,
                                     active=act, expand=2, count_as="turdb.hnsw.insert.descent")
        cur_i = torch.where(act, cand_i[:, 0], cur_i)
        cur_d = torch.where(act, cand_d[:, 0], cur_d)
    return cur_i, cur_d


def build_wave_impl(state: HnswState, new_vecs, new_slots, new_levels, *, cfg: HnswConfig,
                    efc: int, iters: int, descent_ef: int = 1) -> HnswState:
    """One insert wave (the reference's `build_wave_impl`): stage the rows,
    descend each through the levels above its own, search and select their
    forward edges from the top level down (each level's rows written before
    the next level runs), apply the reverse edges level by level from 0,
    then update the entry point. The descent is greedy (K9) when
    `descent_ef` is 1, as in the reference, else the search's beam
    (`_beam_descent`; see the module docstring).
    `new_vecs` [B, d] on the state's device, `new_slots` / `new_levels`
    [B] host ints. The state's tensors are updated in place; the returned
    state carries the new entry point and top level. Every lane is a row:
    the reference pads waves to one compiled shape with masked lanes,
    which are no-ops in every stage, so unpadded waves build the same
    graph (tests/test_torch_hnsw_wave.py). While tracing, the wave is the
    span `turdb.hnsw.insert` (> `.descent`, `.connect`, `.reverse`), its
    rows and waves are counted, and the descent's and the connecting
    levels' beams count their work (`count_beam`)."""
    with span("turdb.hnsw.insert"):
        count("turdb.hnsw.insert.rows", len(new_slots))
        count("turdb.hnsw.insert.waves", 1)
        dev = state.vectors.device
        slots = np.asarray(new_slots, np.int64)
        levels = np.asarray(new_levels, np.int32)
        sl, lv = torch.as_tensor(slots, device=dev), torch.as_tensor(levels, device=dev)
        q, qn = _stage_vectors_core(state.vectors, state.norms, state.levels, new_vecs, sl, lv)
        with span("turdb.hnsw.insert.descent"):
            cur_i, cur_d = _seed_from_entry(state.vectors, state.norms, q, qn, state.entry,
                                            cfg.metric)
            if state.entry >= 0 and (levels < len(state.adj_hi)).any():
                if descent_ef > 1:
                    cur_i, cur_d = _beam_descent(state, q, qn, cur_i, cur_d, levels, cfg=cfg,
                                                 descent_ef=descent_ef)
                else:
                    # The greedy descent of every row through the levels
                    # above its own, in one K9 launch before the level loop
                    # (levels numbered from 0 at level 1, so a row's lowest
                    # is its own level; a row at the top does not descend).
                    # This is the reference's level-by-level order exactly:
                    # a row's greedy levels all lie strictly above the
                    # levels it connects at, the beams below write no
                    # adjacency, and _write_forward writes only the wave's
                    # own rows, which nothing links to until the reverse
                    # pass after the loop; so no walk can see a write made
                    # before it in the reference's order.
                    cur_i, cur_d = _greedy_level(state.adj_hi[::-1], state.vectors, state.norms,
                                                 q, qn, cur_i, cur_d, cfg.metric, lowest=lv)
        fwd = {}
        with span("turdb.hnsw.insert.connect"):
            for lvl in range(cfg.max_levels - 1, -1, -1):
                adj = _level_adj(state, lvl)
                connect = (levels >= lvl) & (state.entry >= 0)
                cur_i, cur_d, sel_i, sel_d = _wave_level_core(
                    adj, state.vectors, state.norms, q, qn, cur_i, cur_d, connect,
                    metric=cfg.metric, efc=efc, iters=iters,
                    deg_out=cfg.m0 if lvl == 0 else cfg.m, count_as="turdb.hnsw.insert.connect")
                _write_forward(adj, sl, sel_i)
                if connect.any():
                    fwd[lvl] = (sel_i, sel_d)
        with span("turdb.hnsw.insert.reverse"):
            src = sl.to(torch.int32)
            for lvl, (sel_i, sel_d) in sorted(fwd.items()):
                _reverse_dense_core(_level_adj(state, lvl), state.vectors, state.norms,
                                    sel_i.reshape(-1), src[:, None].expand_as(sel_i).reshape(-1),
                                    sel_d.reshape(-1), cfg.metric)
        entry, max_level = _entry_update_core(state.entry, state.max_level, slots, levels)
        return state._replace(entry=entry, max_level=max_level)


# ---------------------------------------------------------------------------
# host-side handle
# ---------------------------------------------------------------------------

class HnswIndex:
    """Host orchestration over the device graph: slots, tombstones, the
    bulk build and the insert waves, search, vacuum, the SQ store and the
    serving pack. Runs on the card unless `device` says otherwise."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        m: int = HNSW_M,
        ef_construction: int = HNSW_DEFAULT_EF_CONSTRUCTION,
        ef_search: int = HNSW_DEFAULT_EF_SEARCH,
        capacity: int = 4096,
        build_batch: int = HNSW_BUILD_BATCH,
        bulk_threshold: int = _BULK_MIN,
        *,
        device="cuda",
    ):
        self.cfg = HnswConfig(dim=dim, m0=2 * m, m=m, metric=metric,
                              ef_construction=ef_construction, ef_search=ef_search)
        self.device = torch.device(device)
        self.capacity = _pow2(max(capacity, 1024))
        self.state = init_state(self.cfg, self.capacity, self.device)
        self.size = 0
        self.build_batch = build_batch
        self.bulk_threshold = bulk_threshold
        self._descent_ef = 1   # bulk-built graphs raise this (see add)
        self._alive = np.zeros(self.capacity, bool)  # tombstones (host)
        self.serve = None      # HnswServeState (see pack_serving)

    def __len__(self):
        return self.size

    # -- build ------------------------------------------------------------

    def add(self, vecs, row_ids=None) -> np.ndarray:
        """Insert vectors; returns their slot ids. An empty index given at
        least `bulk_threshold` rows takes the bulk build, every other add
        the insert waves. Levels follow from row_ids (default: the slot
        ids), as in the reference. An SQ store is dequantized first."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = vecs.shape[0]
        bulk = self.size == 0 and n >= self.bulk_threshold
        if isinstance(self.state.vectors, Sq8Rows):
            self.dequantize()   # writes need the f32 store
        self.serve = None   # graph mutation invalidates the serving pack
        slots = np.arange(self.size, self.size + n, dtype=np.int32)
        if row_ids is None:
            row_ids = slots.astype(np.uint64)
        levels = select_levels(row_ids, self.cfg)
        self._ensure(self.size + n)
        if self.cfg.metric is Metric.COSINE:
            vecs = normalize_rows(torch.from_numpy(vecs)).numpy()
        if bulk:
            self._bulk_add(vecs, slots, levels)
            self._alive[slots] = True
            self.size += n
            # bulk graphs lack beam-path long edges: a narrow beam per upper
            # level instead of the greedy walk, in the search and in the
            # later insert waves
            self._descent_ef = 32
            return slots
        # Wave sizes grow 1, 2, 4, ... up to build_batch, so that every wave
        # connects into a graph at least as large as itself (wave-mates do
        # not see each other); this schedule decides the graph, so it is
        # the reference's letter for letter
        jv = torch.as_tensor(vecs, device=self.device)
        off = 0
        while off < n:
            w = min(self.build_batch, n - off, max(1, self.size + off))
            self._insert_wave(jv[off:off + w], slots[off:off + w], levels[off:off + w])
            off += w
        self._alive[slots] = True
        self.size += n
        return slots

    def _insert_wave(self, vecs, slots, levels):
        efc = self.cfg.ef_construction
        # a bulk graph's waves descend as its search does; a wave-built
        # graph's call is the reference's, greedy descent and all
        descent = {"descent_ef": self._descent_ef} if self._descent_ef > 1 else {}
        self.state = build_wave_impl(self.state, vecs, slots, levels, cfg=self.cfg, efc=efc,
                                     iters=efc + efc // 2, **descent)

    def _bulk_add(self, vecs, slots, levels):
        cfg = self.cfg
        st = self.state
        dev = self.device
        sl = torch.as_tensor(slots.astype(np.int64), device=dev)
        jv = torch.as_tensor(vecs, device=dev)
        st.vectors[sl] = jv
        st.norms[sl] = prep_norms(jv)
        st.levels[sl] = torch.as_tensor(levels, device=dev)
        del jv
        top = int(levels.max())
        for lvl in range(top + 1):
            sub = np.flatnonzero(levels >= lvl)
            rows = _bulk_layer_adj(st.vectors, st.norms, slots[sub].astype(np.int64), vecs[sub],
                                   cfg.m0 if lvl == 0 else cfg.m, cfg.metric,
                                   r_mult=2 if lvl == 0 else 8, alpha=1.2)
            adj = st.adj0 if lvl == 0 else st.adj_hi[lvl - 1]
            _scatter_rows(adj, sl[torch.as_tensor(sub, device=dev)], rows)
        best = int(slots[int(np.argmax(levels))])
        # navigability refinement of the upper layers (not L0: its beam
        # recovers on its own, and the refinement's cost grows with n)
        for lvl in range(1, top + 1):
            sub = slots[np.flatnonzero(levels >= lvl)]
            if len(sub) < 4:
                continue
            _refine_layer_adj(st.adj_hi[lvl - 1], st.vectors, st.norms, sub.astype(np.int64),
                              cfg.m, cfg.metric, best)
        self.state = st._replace(entry=best, max_level=top)

    # -- query ------------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        with span("turdb.stage_in"):
            if isinstance(queries, torch.Tensor):
                q = queries.to(self.device, torch.float32)
            else:
                q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                                    device=self.device)
        return normalize_rows(q) if self.cfg.metric is Metric.COSINE else q

    def _out(self, d, i, out):
        if out == "torch":
            return d, i
        with span("turdb.stage_out"):
            return d.cpu().numpy(), i.cpu().numpy()

    def _mask(self, allowed):
        """The [cap] visibility mask (alive, and `allowed` where given), or
        None when every row is visible."""
        if allowed is None and self._alive[: self.size].all():
            return None
        m = np.zeros(self.capacity, bool)
        m[: self.size] = self._alive[: self.size]
        if allowed is not None:
            m[: len(allowed)] &= np.asarray(allowed, bool)
        return torch.as_tensor(m, device=self.device)

    def _empty(self, b, k, out):
        d = torch.full((b, k), INF, device=self.device)
        i = torch.full((b, k), NIL, dtype=torch.int32, device=self.device)
        return self._out(d, i, out)

    def search(self, queries, k: int, ef: int | None = None, allowed=None, out: str = "np"):
        """Batched k-NN over the graph. `allowed`: bool[size] visibility
        mask; hidden and deleted nodes are traversed but never returned.
        Returns (dists [B, k], slots [B, k]), -1 padded; `out="torch"`
        keeps them on the device."""
        with span("turdb.hnsw.search"):
            q = self._queries(queries)
            if self.size == 0:
                return self._empty(q.shape[0], k, out)
            ef = max(ef or max(self.cfg.ef_search, k), k)
            mask = self._mask(allowed)
            d, i = hnsw_search_impl(self.state, q, mask, cfg=self.cfg, k=k, ef=ef,
                                    iters=ef + ef // 2, filtered=mask is not None,
                                    descent_ef=self._descent_ef)
            return self._out(d, i, out)

    def delete(self, slots) -> None:
        """Tombstone delete: the node stays as a stepping stone."""
        self._alive[np.asarray(slots)] = False

    def vacuum(self, row_ids=None) -> np.ndarray:
        """Compact the graph to its alive nodes by rebuilding it over them
        through `add` (the bulk build for at least `bulk_threshold`
        survivors, else the waves). Returns int32[old_size] old slot ->
        new slot (-1: deleted). `row_ids` (per old slot) keeps the levels
        of the rebuild deterministic; default the old slot ids."""
        if isinstance(self.state.vectors, Sq8Rows):
            self.dequantize()
        old_size = self.size
        alive = np.flatnonzero(self._alive[:old_size])
        mapping = np.full(old_size, -1, np.int32)
        vecs = self.state.vectors[torch.as_tensor(alive, device=self.device)].cpu().numpy()
        rids = (np.asarray(row_ids, np.uint64)[alive] if row_ids is not None
                else alive.astype(np.uint64))
        self.capacity = _pow2(max(len(alive), 1024))
        self.state = init_state(self.cfg, self.capacity, self.device)
        self.size = 0
        self._alive = np.zeros(self.capacity, bool)
        self._descent_ef = 1
        self.serve = None
        if len(alive):
            mapping[alive] = self.add(vecs, row_ids=rids)
        return mapping

    # -- serving pack (two-stage int8 beam + exact rerank) ----------------

    def pack_serving(self, n_centroids: int | None = None, pack_m: int | None = None) -> None:
        """Build the packed-neighbour-block serving layout
        (models/hnsw_serve.py). `pack_m` packs only each node's first
        pack_m (diversity-first) level-0 neighbours."""
        from turdb_tpu_torch.models.hnsw_serve import pack_serving

        if self.size == 0:
            return
        if isinstance(self.state.vectors, Sq8Rows):
            self.dequantize()
        self.serve = pack_serving(self.state.vectors, self.state.norms, self.state.adj0,
                                  self.size, self.cfg.metric, n_centroids=n_centroids,
                                  pack_m=pack_m)

    def search_serve(self, queries, k: int, ef: int | None = None, allowed=None,
                     nprobe: int = 2, nseed: int = 32, iters: int | None = None,
                     expand: int = 4, rerank: int = 0, out: str = "np"):
        """Serving-path k-NN (packs on first use). Same visibility
        semantics as `search`; the distances returned are exact."""
        from turdb_tpu_torch.models.hnsw_serve import serve_search_impl

        with span("turdb.hnsw.search_serve"):
            if self.serve is None:
                self.pack_serving()
            q = self._queries(queries)
            if self.serve is None:   # empty index
                return self._empty(q.shape[0], k, out)
            ef = max(ef or max(self.cfg.ef_search, k), k)
            d, i = serve_search_impl(self.serve, q, self._mask(allowed), metric=self.cfg.metric,
                                     k=k, ef=ef, iters=iters or (ef + ef // 2), expand=expand,
                                     nprobe=nprobe, nseed=nseed, rerank=rerank)
            return self._out(d, i, out)

    # -- quantization of the graph's vector store --------------------------

    def quantize_sq8(self) -> None:
        """Swap the f32 rows for u8 codes with a per-row min and scale (a
        quarter of the bytes; see `Sq8Rows`). Search reads the codes
        through the same kernels; the norms stay exact f32, so only the
        q·x term carries the quantization error."""
        self._quantize(8)

    def quantize_sq16(self) -> None:
        """As `quantize_sq8` with u16 codes: half the bytes of f32."""
        self._quantize(16)

    def _quantize(self, bits: int) -> None:
        s = self.state
        if not isinstance(s.vectors, Sq8Rows):
            self.state = s._replace(vectors=sq_rows_encode(s.vectors, bits))

    def dequantize(self) -> None:
        """Expand the codes back to a dense f32 store (for writes)."""
        s = self.state
        if isinstance(s.vectors, Sq8Rows):
            self.state = s._replace(vectors=s.vectors.dense())

    # -- memory -----------------------------------------------------------

    def _ensure(self, need: int):
        # +1 headroom, as the reference keeps (its top slot is a scratch row)
        if need + 1 <= self.capacity:
            return
        new_cap = _pow2(need + 1)
        pad = new_cap - self.capacity
        s = self.state
        dev = self.device

        def grow(a, fill):
            return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=dev)])

        self.state = s._replace(vectors=grow(s.vectors, 0.0), norms=grow(s.norms, INF),
                                adj0=grow(s.adj0, NIL),
                                adj_hi=tuple(grow(a, NIL) for a in s.adj_hi),
                                levels=grow(s.levels, -1))
        self._alive = np.concatenate([self._alive, np.zeros(pad, bool)])
        self.capacity = new_cap


def _pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p
