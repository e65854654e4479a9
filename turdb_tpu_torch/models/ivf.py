"""IVF vector index on PyTorch (port of turdb_tpu/models/ivf.py): the
f32 row store, the SQ8 int8 probe with an exact rerank over an f32 or
SQ16 row store, the probe-only int8 store, and dense block packing.

Layout (block == cell, unless dense; then the [C, L] arrays below are
[NB, L] physical blocks and `cell_block` [C] int32 maps each cell to the
block that holds its rows):
    centroids   [C, d] f32
    cnorms      [C]    f32 (+inf for pad cells of an imported state)
    members     [C, L] int32 slot ids, -1 padded
    pvecs       [C, L, d] f32 rows; or the SQ16 compact store, int16
                holding the reference's uint16 bits; or a (1, 1, 1)
                placeholder in the probe-only store
    pnorms      [C, L] f32 exact ‖x‖² (+inf padding)
    alive       [C, L] bool (tombstones)
    codes       [C, L, d] int8 centred SQ8 codes (sq8), else (1, 1, 1)
    mins        [C, L] f32 m′ = min + 128·scale (sq8), else (1, 1)
    scales      [C, L] f32 (sq8), else (1, 1)

Search: the `qn + cnorms − 2·q·Cᵀ` distances and the top-nprobe cells in
one K12 launch (`kernels.cell_select`; dense: one fp32 matmul and K2, with
K10 in the same launch mapping the cells to the first `nblocks` distinct
blocks) -> the probe scores those blocks' rows: K1
over f32 rows, K4 over int8 codes. Without rerank the probe returns the k
nearest (deduplicating boundary replicas); with it, the probe returns the
r best lanes and K5 reranks them exactly from the row store.
Build: Lloyd's k-means whose assignment is K3 and whose update is a
sorted segment sum, starved-centroid rebalance, the 2-means split cascade,
balanced packing with spill, boundary replicas, then an `index_put_` pack
(with the SQ8 / SQ16 encodings of `ops/quantize.py`); `dense_pack`
bin-packs whole cells into ~full blocks after the replicas land.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from turdb_tpu_torch.kernels import (
    EPI_L2,
    MODE_CAND,
    cell_select,
    cell_select_fused,
    ivf_probe_f32,
    ivf_probe_sq8,
    ivf_rerank,
    kmeans_assign,
    topk_rows,
)
from turdb_tpu_torch.ops.distance import Metric, chain_norms, normalize_rows, prep_norms
from turdb_tpu_torch.ops.quantize import quantize_queries, sq8_store, sq16_decode, sq16_encode
from turdb_tpu_torch.ops.topk import topk_smallest_wide
from turdb_tpu_torch.utils.timing import count, span, tracing

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class IvfConfig:
    dim: int
    n_clusters: int
    cluster_cap: int
    metric: Metric = Metric.L2
    nprobe: int = 8
    sq8: bool = False
    rerank: int = 0           # exact-rerank candidate count (0 = off)
    replicated: bool = False  # boundary replicas present -> dedup at top-k
    dense: bool = False       # cells bin-packed into physical blocks (cell_block)
    copies: int = 2           # max physical copies per slot (1 + replica_rank)


class IvfState(NamedTuple):
    """Packed device state (block == cell); see the module docstring."""

    centroids: torch.Tensor   # [C, d]
    cnorms: torch.Tensor      # [C]
    members: torch.Tensor     # [C, L] int32
    pvecs: torch.Tensor       # [C, L, d] f32 | int16 (SQ16 bits) | (1, 1, 1)
    pnorms: torch.Tensor      # [C, L]
    alive: torch.Tensor       # [C, L] bool
    codes: torch.Tensor       # [C, L, d] int8 | (1, 1, 1)
    mins: torch.Tensor        # [C, L] m′ | (1, 1)
    scales: torch.Tensor      # [C, L] | (1, 1)
    cell_block: torch.Tensor | None = None   # [C] int32 (dense only)
    lanes: torch.Tensor | None = None        # [C] int64 live lanes a cell (`probe_lanes`)


def probe_lanes(lanes: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The live lanes of the cells (blocks) `src` names, replicas included,
    summed on the device: a 0-d int64 tensor (no synchronize)."""
    return lanes.index_select(0, src.reshape(-1)).sum()


def cell_lanes(alive: torch.Tensor) -> torch.Tensor:
    """[C] int64 live lanes a cell, the traced probe's counter. The
    counter's gather and sum run once here, over C cells (a gather of 16
    or fewer takes another kernel): CUDA loads a kernel's module at its
    first launch, which would otherwise fall in the first traced search."""
    lanes = alive.sum(1)
    probe_lanes(lanes, torch.zeros(len(lanes), dtype=torch.int32, device=alive.device))
    return lanes


def sq8_placeholders(device):
    """The small codes / mins / scales of a state without the int8 store:
    nothing reads them (the reference's placeholders)."""
    return (torch.zeros((1, 1, 1), dtype=torch.int8, device=device),
            torch.zeros((1, 1), device=device), torch.zeros((1, 1), device=device))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _masked_cn(cents: torch.Tensor, c_real: int) -> torch.Tensor:
    """Centroid norms with cells past `c_real` at +inf (never assigned)."""
    cn = chain_norms(cents)
    if cents.shape[0] > c_real:
        cn[c_real:] = INF
    return cn


def _kmeans(x: torch.Tensor, centroids: torch.Tensor, iters: int,
            xb: torch.Tensor | None = None) -> torch.Tensor:
    """Lloyd's iterations: K3 assigns every row; the update sorts the rows
    by centroid and sums each run with `segment_reduce`, in a fixed order,
    so a build is the same on every run (float atomics, as `index_add_`
    uses on CUDA, sum in another order each time). An empty centroid keeps
    its place. The norms are `chain_norms`, the reference's own order. The
    rows are rounded to bf16 once for every round (`xb`, if the caller has
    them already)."""
    xn = chain_norms(x)
    xb = x.to(torch.bfloat16) if xb is None else xb
    cents = centroids.clone()
    c = cents.shape[0]
    for _ in range(iters):
        a = kmeans_assign(xb, cents, xn, chain_norms(cents))[0][:, 0].long()
        counts = torch.bincount(a, minlength=c)
        sums = torch.segment_reduce(x[torch.argsort(a, stable=True)], "sum",
                                    lengths=counts, axis=0, unsafe=True)
        new = sums / torch.clamp_min(counts, 1)[:, None]
        cents = torch.where((counts > 0)[:, None], new, cents)
    return cents


def _assign_all(x: torch.Tensor, centroids: torch.Tensor,
                cn: torch.Tensor | None = None, xb: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-centroid id of every row ([n] int32). `cn` overrides the
    centroid norms: +inf entries exclude (full) clusters. `xb`: the rows
    already rounded to bf16."""
    if cn is None:
        cn = chain_norms(centroids)
    return kmeans_assign(x if xb is None else xb, centroids, chain_norms(x), cn)[0][:, 0]


def _assign_topk_all(x: torch.Tensor, centroids: torch.Tensor,
                     cn: torch.Tensor | None = None, *, k: int = 2,
                     xb: torch.Tensor | None = None):
    """Top-k nearest centroids of every row: ([n, k] int32 ids, [n, k] d²)."""
    if cn is None:
        cn = chain_norms(centroids)
    return kmeans_assign(x if xb is None else xb, centroids, chain_norms(x), cn, k)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def count_select(q, centroids, p: int, dense: bool = False) -> None:
    """The cell selection's counters, under the profiler:
    `turdb.ivf.select.queries`, and `turdb.ivf.select.fused`, the queries
    whose cells K12 selects (none on the dense path, whose K10 runs inside
    K2's launch)."""
    if tracing():
        b = q.shape[0]
        count("turdb.ivf.select.queries", b)
        fused = not dense and cell_select_fused(q.device, b, centroids.shape[0], q.shape[1], p)
        count("turdb.ivf.select.fused", b if fused else 0)


def ivf_search_impl(state: IvfState, queries: torch.Tensor, allowed, *,
                    cfg: IvfConfig, k: int, nprobe: int, nblocks: int | None = None):
    """Top-nprobe cells (K12: the centroid product and the selection in one
    launch) -> under `cfg.dense`, after a centroid matmul and K2, the
    physical blocks of those cells, cut to the first `nblocks` distinct
    ones (K10, inside the same K2 launch) -> fused probe (K1 over f32 rows, K4 over int8 codes) ->
    optional exact rerank (K5). `allowed` is a bool visibility mask over
    the store's [blocks, L] lanes, or None. A slot may sit in several
    probed lanes (boundary replicas, blocks shared by cells): those
    indexes drop later copies. The sq8 probe and the rerank are L2
    whatever `cfg.metric` is, as in the reference. Returns ([B, k] dists
    ascending, [B, k] int32 slot ids, -1 where +inf)."""
    with span("turdb.ivf.select"):
        q = queries.float().contiguous()
        qn = prep_norms(q)
        # cell scoring is L2 for every metric and, like the reference, unclamped
        count_select(q, state.centroids, nprobe, cfg.dense)
        if cfg.dense:
            *_, src = topk_rows(q @ state.centroids.T, nprobe, rown=qn, coln=state.cnorms,
                                epilogue=EPI_L2, cell_block=state.cell_block,
                                u=nblocks or nprobe)
        else:
            _, src = cell_select(q, qn, state.centroids, state.cnorms, nprobe)
    dedup = cfg.replicated or cfg.dense
    lanes = src.shape[1] * cfg.cluster_cap
    if cfg.rerank:
        # the probe's r best lanes by (distance, lane), before any dedup
        r = min(cfg.rerank, lanes)
        sel = dict(k=r, m=r, replicated=dedup, mode=MODE_CAND)
    else:
        m = min(max(2, cfg.copies) * k, lanes) if dedup else k
        sel = dict(k=k, m=m, replicated=dedup)
    with span("turdb.ivf.probe"):
        if tracing() and state.lanes is not None:
            count("turdb.ivf.probe.queries", src.shape[0])
            count("turdb.ivf.probe.lanes", probe_lanes(state.lanes, src))
        if cfg.sq8:
            qc, qs, qsum = quantize_queries(q)
            out = ivf_probe_sq8(qc, qs, qsum, qn, src, state.codes, state.mins, state.scales,
                                state.pnorms, state.members, state.alive, allowed, **sel)
        else:
            out = ivf_probe_f32(q, qn, src, state.pvecs, state.pnorms, state.members,
                                state.alive, allowed, metric=cfg.metric.value, **sel)
    if not cfg.rerank:
        return out
    cd, ci, cpos = out
    with span("turdb.ivf.rerank"):
        return ivf_rerank(q, qn, cd, ci, cpos, state.pvecs, state.pnorms, state.mins,
                          state.scales, k=k, replicated=dedup)


# ---------------------------------------------------------------------------
# host-side handle
# ---------------------------------------------------------------------------

class IvfIndex:
    """Host orchestration: k-means training, balanced packing, incremental
    appends, tombstones. Slot ids are dense insertion indices.

    The store follows the reference's flags: `sq8` adds the int8 probe
    codes; `keep_f32=False` (with sq8) keeps an SQ16 row copy instead of
    the f32 rows; `rerank` is the exact-rerank candidate count (None: 64
    under sq8, else 0). sq8 with `keep_f32=False` and `rerank=0` is the
    probe-only store: int8 codes and no row copy at all, which takes no
    appends. `dense_pack` bin-packs whole cells into ~full physical blocks
    at train(); `nblocks` caps the distinct blocks a query gathers out of
    its top-nprobe cells (None: one block per probed cell). Runs on the
    card unless `device` says otherwise."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        n_clusters: int | None = None,
        cluster_cap: int | None = None,
        nprobe: int = 8,
        sq8: bool = False,
        rerank: int | None = None,
        replicate: bool = True,
        replica_rank: int = 1,
        keep_f32: bool = True,
        dense_pack: bool = False,
        nblocks: int | None = None,
        fast_build: bool = False,
        *,
        device="cuda",
    ):
        self.dim = dim
        self.metric = metric
        self.device = torch.device(device)
        self._n_clusters = n_clusters
        self._cluster_cap = cluster_cap
        self.nprobe = nprobe
        self.sq8 = sq8
        self.keep_f32 = keep_f32 or not sq8
        self.rerank = (64 if sq8 else 0) if rerank is None else rerank
        self.replicate = replicate
        self.replica_rank = max(1, replica_rank)
        self.dense_pack = dense_pack
        self.nblocks = nblocks
        # the candidate-generator profile (the reference's fast_build): 4
        # Lloyd rounds on at most 262,144 sampled rows, 2 rebalance rounds,
        # and no split cascade (overflow spills to the runner-up cell)
        self.fast_build = fast_build
        self.cfg: IvfConfig | None = None
        self.state: IvfState | None = None
        self.size = 0
        self._vectors_host: list[np.ndarray] = []   # staged until train
        self._alive_host = np.zeros(0, bool)
        # slot -> (cluster, lane); _slot_extras holds one pair per replica rank
        self._slot_cluster = np.zeros(0, np.int32)
        self._slot_lane = np.zeros(0, np.int32)
        self._slot_extras: list[tuple[np.ndarray, np.ndarray]] = []
        self._occupancy: np.ndarray | None = None
        self._cell_block_host: np.ndarray | None = None

    @property
    def probe_only(self) -> bool:
        """sq8 with neither an f32 copy nor a rerank: no row store."""
        return self.sq8 and not self.keep_f32 and not self.rerank

    def __len__(self):
        return self.size

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- build -------------------------------------------------------------

    def add(self, vecs, row_ids=None) -> np.ndarray:
        """Append rows; returns their slot ids (insertion indices). `row_ids`
        is accepted for the engine interface and not stored."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        if self.metric is Metric.COSINE:
            vecs = normalize_rows(torch.from_numpy(vecs)).numpy()
        n = vecs.shape[0]
        slots = np.arange(self.size, self.size + n)
        self._alive_host = np.concatenate([self._alive_host, np.ones(n, bool)])
        if self.state is None:
            self._vectors_host.append(vecs)
            self.size += n
            if self.size >= 4 * max(64, int(np.sqrt(self.size))):
                self.train()
        else:
            self._append(vecs, slots)
            self.size += n
        return slots

    def train(self, iters: int | None = None, _pre=None):
        """K-means + packed layout build over all staged vectors.

        `_pre` (the mesh build, parallel/sharded_ivf.py): a (centroids,
        assignment, rows on the device or None) triple from the mesh's
        k-means of this shard; the rest of the build (rebalance, split,
        packing, replicas) then runs here from it."""
        x = (np.concatenate(self._vectors_host) if self._vectors_host
             else np.zeros((0, self.dim), np.float32))
        n = x.shape[0]
        if n == 0:
            return
        c, cap = self._geometry(n)
        rng = np.random.default_rng(0)
        seed_idx = rng.choice(n, size=c, replace=False)
        n_train = min(n, max(c * 64, 100_000), 4_194_304)
        if iters is None:
            iters = 4 if self.fast_build else 8
        if self.fast_build:
            n_train = min(n_train, 262_144)
        tr_idx = (rng.choice(n, size=n_train, replace=False) if n_train < n
                  else np.arange(n))
        if _pre is None:
            xd = self._dev(x)
        else:
            cents, assign, xd = _pre
            cents = self._dev(cents)
            assign = np.asarray(assign)[:n]
            xd = self._dev(x) if xd is None else xd[:n]
        # the rows rounded to bf16 once for every k-means round below
        xdb = xd.to(torch.bfloat16)
        xt, xtb = ((xd, xdb) if n_train == n else
                   (xd[self._dev(tr_idx)], xdb[self._dev(tr_idx)]))
        if _pre is None:
            cents = _kmeans(xt, xd[self._dev(seed_idx)], iters, xb=xtb)
            assign = _assign_all(xd, cents, _masked_cn(cents, c), xb=xdb).cpu().numpy()
        # balance repair: re-seed starved centroids as perturbed copies of
        # oversized donors, then a couple more Lloyd's iterations
        for rnd in range(2 if self.fast_build else 6):
            counts = np.bincount(assign, minlength=c)
            over = np.flatnonzero(counts > cap)
            if len(over) == 0:
                break
            order = np.argsort(counts)
            starved = order[counts[order] < max(1, cap // 4)]
            starved = starved[starved < c]
            if len(starved) == 0:
                break
            cents_np = cents.cpu().numpy().copy()
            want = np.maximum(counts[over] // cap, 1)
            donors = np.repeat(over, want)[: len(starved)]
            rloc = np.random.default_rng(7 + rnd)
            sigma = 1e-3 * (np.abs(cents_np[donors]).mean() + 1.0)
            cents_np[starved[: len(donors)]] = cents_np[donors] + sigma * (
                rloc.standard_normal((len(donors), self.dim)).astype(np.float32)
            )
            cents = _kmeans(xt, self._dev(cents_np), 2, xb=xtb)
            assign = _assign_all(xd, cents, _masked_cn(cents, c), xb=xdb).cpu().numpy()
        # split oversized clusters (local 2-means) instead of spilling rows
        # to far clusters, which centroid probing would never reach; the
        # fast build skips the cascade and spills below
        if self.fast_build:
            cents_np = cents.cpu().numpy()[:c]
        else:
            cents_np, assign = _split_oversized(cents.cpu().numpy()[:c], assign, xd, cap)
        c = cents_np.shape[0]
        # balanced packing: stable-sort by cluster, lane = rank within the
        # run; lanes past the cap spill to the nearest cluster with room
        members = np.full((c, cap), -1, np.int64)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        first = np.zeros(n, bool)
        first[0] = True
        first[1:] = sa[1:] != sa[:-1]
        run_start = np.flatnonzero(first)
        start_of = np.zeros(c, np.int64)
        start_of[sa[run_start]] = run_start
        lane = np.arange(n) - start_of[sa]
        ok = lane < cap
        members[sa[ok], lane[ok]] = order[ok]
        occupancy = np.minimum(np.bincount(assign, minlength=c), cap)
        spill = order[~ok]
        if len(spill):
            self._place_spill(spill, xd, cents_np, members, occupancy, cap)
        self._occupancy = occupancy
        # slot -> (cluster, lane), primaries first, before replicas land
        self._slot_cluster = np.full(n, -1, np.int32)
        self._slot_lane = np.full(n, -1, np.int32)
        self._slot_extras = [
            (np.full(n, -1, np.int32), np.full(n, -1, np.int32))
            for _ in range(self.replica_rank)
        ]
        mc, ml = np.nonzero(members >= 0)
        mslots = members[mc, ml]
        self._slot_cluster[mslots] = mc
        self._slot_lane[mslots] = ml
        replicated = False
        if self.replicate and n > c:
            replicated = self._place_replicas(x, xd, cents_np, members,
                                              occupancy, cap)
        cell_block = None
        if self.dense_pack:
            members, cell_block = self._dense_remap(cents_np, members, occupancy, cap)
        self.cfg = IvfConfig(
            dim=self.dim, n_clusters=c, cluster_cap=cap, metric=self.metric,
            nprobe=self.nprobe, sq8=self.sq8, rerank=self.rerank,
            replicated=replicated or self.dense_pack, dense=self.dense_pack,
            copies=(self.replica_rank + 1) if replicated else 2,
        )
        self.state = self._pack(xd, cents_np, members, cap, cell_block)
        self._vectors_host = []

    def _geometry(self, n: int) -> tuple[int, int]:
        """(cells, lane cap) before the split cascade, by the reference's
        rule: n//128 cells for the f32 store at >= 500k rows and dim <= 256
        (bigger contiguous blocks), else n//64 (the sq8 store moves 4x
        fewer bytes a probe and keeps the denser layout); cap is the power
        of two at least 2n/c."""
        big_blocks = n >= 500_000 and not self.sq8 and self.dim <= 256
        c = self._n_clusters or max(8, n // (128 if big_blocks else 64))
        c = min(c, max(8, n // 4))
        return c, self._cluster_cap or _pow2_at_least(max(int(2.0 * n / c), 16), floor=8)

    def _dense_remap(self, cents_np, members, occupancy, cap):
        """Bin-pack whole cells into dense physical blocks (`cfg.dense`, the
        reference's `_dense_remap`). Cells stay the probe's selection unit,
        blocks become its gather unit at ~full occupancy. Cells are grouped
        by one nearest-centre assignment over the centroids (K3; the group
        centres drawn with `default_rng(11)`), then packed first-fit in
        order of (group, occupancy descending), so a block holds a
        neighbourhood and nearby cells share blocks. Remaps the slot
        bookkeeping and the occupancy to block coordinates. Returns
        (members [NB, L], cell_block [C] int32)."""
        c = len(occupancy)
        occ = np.asarray(occupancy, np.int64)
        ng = _pow2_at_least(max(1, int(occ.sum()) // (8 * cap)), floor=1)
        if ng > 1 and c > ng:
            pick = np.random.default_rng(11).choice(c, size=ng, replace=False)
            ga = _assign_all(self._dev(np.asarray(cents_np, np.float32)),
                             self._dev(np.asarray(cents_np[pick], np.float32))).cpu().numpy()
        else:
            ga = np.zeros(c, np.int64)
        blk = np.zeros(c, np.int32)
        off = np.zeros(c, np.int64)
        cur, fill, fills = 0, 0, [0]
        for cell in np.lexsort((-occ, ga)):   # group ascending, occupancy descending
            o = int(occ[cell])
            if fill + o > cap:
                cur, fill = cur + 1, 0
                fills.append(0)
            blk[cell], off[cell] = cur, fill
            fill += o
            fills[cur] = fill
        bm = np.full((cur + 1, cap), -1, np.int64)
        mc0, ml0 = np.nonzero(members >= 0)   # a cell's lanes are contiguous
        bm[blk[mc0], off[mc0] + ml0] = members[mc0, ml0]
        for sc, sl in ((self._slot_cluster, self._slot_lane), *self._slot_extras):
            mk = sc >= 0
            sl[mk] = (off[sc[mk]] + sl[mk]).astype(np.int32)
            sc[mk] = blk[sc[mk]]
        self._occupancy = np.asarray(fills, np.int64)
        self._cell_block_host = blk
        return bm, blk

    def _pack(self, xd, cents_np, members, cap, cell_block=None) -> IvfState:
        """Scatter rows (primaries and replicas) into the packed store,
        encoded as the flags ask (`_pack_body` of the reference); `members`
        is [blocks, L], `cell_block` the dense map or None."""
        c = members.shape[0]
        mc, ml = np.nonzero(members >= 0)
        mslots = members[mc, ml]
        dev = self.device
        if self.probe_only:
            pvecs = torch.zeros((1, 1, 1), dtype=torch.int16, device=dev)
        else:
            pvecs = torch.zeros((c, cap, self.dim),
                                dtype=torch.float32 if self.keep_f32 else torch.int16,
                                device=dev)
        if self.sq8:
            codes = torch.zeros((c, cap, self.dim), dtype=torch.int8, device=dev)
            mins = torch.zeros((c, cap), device=dev)
            scales = torch.zeros((c, cap), device=dev)
        else:
            codes, mins, scales = sq8_placeholders(dev)
        pnorms = torch.full((c, cap), INF, device=dev)
        ch = 1 << 20   # bounds the gathered-rows temporary
        for s in range(0, len(mslots), ch):
            rows = xd[self._dev(mslots[s:s + ch])]
            where = (self._dev(mc[s:s + ch]), self._dev(ml[s:s + ch]))
            self._write_rows(where, rows, pvecs, pnorms, codes, mins, scales)
        alive = np.zeros((c, cap), bool)
        alive[mc, ml] = self._alive_host[mslots]
        alive = self._dev(alive)
        cents = self._dev(np.ascontiguousarray(cents_np, np.float32))
        return IvfState(
            centroids=cents,
            cnorms=prep_norms(cents),
            members=self._dev(members.astype(np.int32)),
            pvecs=pvecs,
            pnorms=pnorms,
            alive=alive,
            codes=codes,
            mins=mins,
            scales=scales,
            cell_block=None if cell_block is None else self._dev(cell_block),
            lanes=cell_lanes(alive),
        )

    def _write_rows(self, where, rows, pvecs, pnorms, codes, mins, scales):
        """Write rows [n, d] f32 into the lanes `where` of every store the
        flags keep (in place)."""
        pnorms.index_put_(where, prep_norms(rows))
        if self.sq8:
            c8, m_prime, s8, m8 = sq8_store(rows)
            codes.index_put_(where, c8)
            mins.index_put_(where, m_prime)
            scales.index_put_(where, s8)
        if self.probe_only:
            return
        if self.keep_f32:
            pvecs.index_put_(where, rows)
        else:
            pvecs.index_put_(where, sq16_encode(rows, m8, s8))

    def _place_spill(self, spill, xd, cents_np, members, occupancy, cap):
        """Capacity-respecting spill placement in waves: each wave sends
        every remaining row to its nearest cluster with free lanes (full
        clusters masked by +inf norms) and accepts as many as fit."""
        remaining = spill
        c = len(occupancy)
        cents_dev = self._dev(cents_np)
        base_cn = (cents_np.astype(np.float32) ** 2).sum(1)
        for _round in range(64):
            if len(remaining) == 0:
                return
            free = cap - occupancy
            if free.sum() < len(remaining):
                raise RuntimeError("IVF packing overflow; raise cluster_cap")
            cn = np.where(free > 0, base_cn, np.inf).astype(np.float32)
            pick = _assign_all(xd[self._dev(remaining)], cents_dev,
                               self._dev(cn)).cpu().numpy()
            o = np.argsort(pick, kind="stable")
            sp, pk = remaining[o], pick[o]
            firsts = np.zeros(len(o), bool)
            firsts[0] = True
            firsts[1:] = pk[1:] != pk[:-1]
            starts = np.flatnonzero(firsts)
            start_of = np.zeros(c, np.int64)
            start_of[pk[starts]] = starts
            rank = np.arange(len(o)) - start_of[pk]
            accept = rank < free[pk]
            lanes = occupancy[pk[accept]] + rank[accept]
            members[pk[accept], lanes] = sp[accept]
            np.add.at(occupancy, pk[accept], 1)
            remaining = sp[~accept]
        raise RuntimeError("IVF spill placement did not converge")

    def _place_replicas(self, x, xd, cents_np, members, occupancy, cap) -> bool:
        """Copy boundary rows into free padding lanes of their runner-up
        cells (every probe reads all `cap` lanes, so the copies cost no
        probe bandwidth). Duplicates drop at top-k (cfg.replicated). One
        acceptance wave per replica rank, nearest non-home cell first."""
        n = x.shape[0]
        c = len(occupancy)
        ranks = self.replica_rank
        # keep cap//8 lanes per cluster free for incremental appends
        free = np.maximum(cap - occupancy - max(1, cap // 8), 0)
        if free.sum() == 0:
            return False
        cents_j = self._dev(cents_np)
        kk = min(ranks + 1, c)
        a12, d12 = _assign_topk_all(xd, cents_j, _masked_cn(cents_j, c), k=kk)
        a12 = a12.cpu().numpy().astype(np.int64)
        d12 = d12.cpu().numpy()
        placed = self._slot_cluster[:n].astype(np.int64)
        # exact d² to the home centroid: rows living away from their argmin
        # cell rank first through the d_tgt / d_home priority
        d_home = np.empty(n, np.float32)
        for s in range(0, n, 1 << 17):
            e = min(n, s + (1 << 17))
            diff = x[s:e] - cents_np[placed[s:e]]
            d_home[s:e] = np.einsum("ij,ij->i", diff, diff)
        d_home = np.maximum(d_home, 1e-12)
        is_home = a12 == placed[:, None]
        key = np.where(is_home, np.inf, d12)
        order_cols = np.argsort(key, axis=1, kind="stable")
        placed_any = False
        for r in range(min(ranks, kk - 1)):
            col = order_cols[:, r]
            rows = np.arange(n)
            tgt = a12[rows, col]
            d_tgt = d12[rows, col]
            ok = np.isfinite(key[rows, col])
            prio = np.where(ok, d_tgt / d_home, np.inf)
            order = np.argsort(prio, kind="stable")
            order = order[ok[order]]
            pk = tgt[order]
            o2 = np.argsort(pk, kind="stable")
            sp, pk = order[o2], pk[o2]
            if len(sp) == 0:
                break
            firsts = np.zeros(len(sp), bool)
            firsts[0] = True
            firsts[1:] = pk[1:] != pk[:-1]
            starts = np.flatnonzero(firsts)
            start_of = np.zeros(c, np.int64)
            start_of[pk[starts]] = starts
            rank = np.arange(len(sp)) - start_of[pk]
            accept = rank < free[pk]
            if not accept.any():
                continue
            lanes = occupancy[pk[accept]] + rank[accept]
            rslots = sp[accept]
            members[pk[accept], lanes] = rslots
            add = np.bincount(pk[accept], minlength=c)
            occupancy += add
            free -= add
            sc, sl = self._slot_extras[r]
            sc[rslots] = pk[accept]
            sl[rslots] = lanes
            placed_any = True
        return placed_any

    # nearest cells an appended row tries before the full host sort
    _APPEND_TRIES = 64

    def _append(self, vecs: np.ndarray, slots: np.ndarray):
        """Incremental append: each row lands in the nearest cell with a
        free lane (dense: in any free lane of that cell's block, which is
        gathered whole); if every cell is full the index retrains."""
        st = self.state
        if self.probe_only:
            raise RuntimeError(
                "probe-only IVF index (sq8, rerank=0, no row store) does "
                "not support incremental appends; rebuild with train()")
        cap = self.cfg.cluster_cap
        jv = self._dev(vecs)
        d2c = (prep_norms(jv)[:, None] + st.cnorms[None, :]) - 2.0 * (jv @ st.centroids.T)
        tries = min(self._APPEND_TRIES, d2c.shape[1])
        near = topk_smallest_wide(d2c, tries)[1].cpu().numpy()
        cb = self._cell_block_host if self.cfg.dense else None
        cs, lanes = [], []
        for j in range(len(vecs)):
            cand = near[j] if cb is None else cb[near[j]]
            free = self._occupancy[cand] < cap
            if not free.any():
                cand = np.argsort(d2c[j].cpu().numpy(), kind="stable")
                if cb is not None:
                    cand = cb[cand]
                free = self._occupancy[cand] < cap
            if not free.any():
                # all clusters full: retrain with everything. Nothing of
                # this batch has been written yet; train() rebuilds occupancy
                self._retrain_with(vecs, slots)
                return
            a = int(cand[np.argmax(free)])
            cs.append(a)
            lanes.append(int(self._occupancy[a]))
            self._occupancy[a] += 1
        cs = np.asarray(cs)
        lanes = np.asarray(lanes)
        where = (self._dev(cs), self._dev(lanes))
        st.members.index_put_(where, self._dev(slots.astype(np.int32)))
        st.alive.index_put_(where, torch.ones(len(cs), dtype=torch.bool, device=self.device))
        torch.sum(st.alive, 1, out=st.lanes)
        self._write_rows(where, jv, st.pvecs, st.pnorms, st.codes, st.mins, st.scales)
        need = int(slots.max()) + 1
        if need > len(self._slot_cluster):
            pad = np.full(need - len(self._slot_cluster), -1, np.int32)
            self._slot_cluster = np.concatenate([self._slot_cluster, pad])
            self._slot_lane = np.concatenate([self._slot_lane, pad])
            self._slot_extras = [
                (np.concatenate([sc, pad]), np.concatenate([sl, pad]))
                for sc, sl in self._slot_extras
            ]
        self._slot_cluster[slots] = cs
        self._slot_lane[slots] = lanes

    def _retrain_with(self, extra_vecs, extra_slots):
        """Collect every stored vector plus the extras and retrain."""
        st = self.state
        if st.pvecs.dtype == torch.int16:
            flat = sq16_decode(st.pvecs, st.mins, st.scales)
        else:
            flat = st.pvecs
        flat = flat.reshape(-1, self.dim).cpu().numpy()
        mem = self.state.members.reshape(-1).cpu().numpy()
        extra_slots = np.atleast_1d(np.asarray(extra_slots, np.int64))
        hi = int(extra_slots.max()) + 1 if len(extra_slots) else 0
        xs = np.zeros((max(self.size, hi), self.dim), np.float32)
        ok = mem >= 0
        xs[mem[ok]] = flat[ok]          # replica copies rewrite the same data
        xs[extra_slots] = extra_vecs
        self._vectors_host = [xs]
        self.state = None
        self.train()

    # -- query -------------------------------------------------------------

    def allowed_mask(self, allowed) -> torch.Tensor:
        """bool[size] slot visibility -> [blocks, L] lane mask (every copy;
        blocks are the cells unless dense)."""
        allowed = np.asarray(allowed, bool)
        am = np.zeros(tuple(self.state.members.shape), bool)
        m = min(len(allowed), len(self._slot_cluster))
        for sc, sl in ((self._slot_cluster, self._slot_lane), *self._slot_extras):
            sel = np.flatnonzero(allowed[:m] & (sc[:m] >= 0))
            am[sc[sel], sl[sel]] = True
        return self._dev(am)

    def search(self, queries, k: int, nprobe: int | None = None, allowed=None,
               out: str = "np"):
        """allowed: bool[size] slot-visibility mask. Returns (dists, slots);
        a slot is -1 where its distance is +inf.

        `queries` may be a tensor on the index's device (the serving path:
        no host staging); `out="torch"` keeps the results there."""
        with span("turdb.ivf.search"):
            with span("turdb.stage_in"):
                if isinstance(queries, torch.Tensor):
                    q = queries.to(self.device, torch.float32)
                else:
                    q = self._dev(np.atleast_2d(np.asarray(queries, np.float32)))
            if self.state is None:
                self.train()
            if self.state is None or self.size == 0:
                d = torch.full((q.shape[0], k), INF, device=self.device)
                i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=self.device)
            else:
                if self.metric is Metric.COSINE:
                    q = normalize_rows(q)
                p = min(nprobe or self.nprobe, self.cfg.n_clusters)
                amask = None if allowed is None else self.allowed_mask(allowed)
                # the plain probe bounds its gather by the min(p, nblocks) blocks
                # it reads, as the reference's batch cap does (p_eff)
                d, i = ivf_search_impl(self.state, q, amask, cfg=self.cfg, k=k, nprobe=p,
                                       nblocks=self.nblocks if self.cfg.dense else None)
            if out == "torch":
                return d, i
            with span("turdb.stage_out"):
                return d.cpu().numpy(), i.cpu().numpy()

    def delete(self, slots):
        slots = np.atleast_1d(np.asarray(slots)).astype(np.int64)
        in_range = slots[slots < len(self._alive_host)]
        self._alive_host[in_range] = False
        if self.state is None:
            return
        m = in_range[in_range < len(self._slot_cluster)]
        m = m[self._slot_cluster[m] >= 0]
        if len(m) == 0:
            return
        alive = self.state.alive
        alive[self._dev(self._slot_cluster[m]), self._dev(self._slot_lane[m])] = False
        for sc, sl in self._slot_extras:
            r = m[sc[m] >= 0]
            if len(r):
                alive[self._dev(sc[r]), self._dev(sl[r])] = False
        torch.sum(alive, 1, out=self.state.lanes)


def _two_means_batched(pts: torch.Tensor, valid: torch.Tensor, iters: int = 6):
    """2-means over many clusters at once: pts [O, L, d] (lane-padded),
    valid [O, L]. Seeds = lane 0 and the member farthest from it. Returns
    (labels [O, L] int32 in {0, 1}, c2 [O, 2, d])."""
    pn = torch.where(valid, torch.sum(pts * pts, dim=-1), INF)       # [O, L]
    a = pts[:, 0]                                                     # [O, d]
    d0 = pn - 2.0 * torch.einsum("old,od->ol", pts, a)
    far = torch.argmax(torch.where(valid, d0, -INF), dim=1)
    b = pts[torch.arange(pts.shape[0], device=pts.device), far]
    c2 = torch.stack([a, b], dim=1)                                   # [O, 2, d]
    w = valid.float()

    def dist(c2):
        cn = torch.sum(c2 * c2, dim=-1)                               # [O, 2]
        return pn[:, :, None] + cn[:, None, :] - 2.0 * torch.einsum(
            "old,ogd->olg", pts, c2)

    for _ in range(iters):
        lab = torch.argmin(dist(c2), dim=-1)
        w1 = w * lab.float()
        w0 = w - w1
        s0 = torch.einsum("ol,old->od", w0, pts)
        s1 = torch.einsum("ol,old->od", w1, pts)
        n0 = torch.clamp_min(w0.sum(1), 1.0)[:, None]
        n1 = torch.clamp_min(w1.sum(1), 1.0)[:, None]
        c2 = torch.stack([s0 / n0, s1 / n1], dim=1)
    return torch.argmin(dist(c2), dim=-1).to(torch.int32), c2


_SPLIT_OCHUNK = 512  # oversized clusters per batched 2-means


def _split_oversized(cents: np.ndarray, assign: np.ndarray, xd: torch.Tensor,
                     cap: int, max_rounds: int = 12):
    """Split clusters whose population exceeds the lane cap in two by
    local 2-means until everything fits (or rounds run out; leftovers
    spill in packing). Every oversized cluster of a round runs in one
    batched 2-means over rows gathered from `xd` (the rows on the device)."""
    cents = np.array(cents, np.float32)
    assign = np.array(assign)
    for _ in range(max_rounds):
        counts = np.bincount(assign, minlength=len(cents))
        over = np.flatnonzero(counts > cap)
        if len(over) == 0:
            break
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        starts = np.searchsorted(sa, over, side="left")
        lmax = _pow2_at_least(int(counts[over].max()), floor=32)
        new_cents = []
        n_new = 0
        lane = np.arange(lmax)
        for s in range(0, len(over), _SPLIT_OCHUNK):
            oc, ost = over[s:s + _SPLIT_OCHUNK], starts[s:s + _SPLIT_OCHUNK]
            o = len(oc)
            valid = lane[None, :] < counts[oc][:, None]
            # row ids order[start + lane]; the clip keeps gathers in bounds
            # (invalid lanes carry weight 0)
            idx = order[np.clip(ost[:, None] + lane[None, :], 0, len(order) - 1)]
            pts = xd[torch.as_tensor(idx, device=xd.device)]
            lab, c2 = _two_means_batched(pts, torch.as_tensor(valid, device=xd.device))
            lab = lab.cpu().numpy()
            c2 = c2.cpu().numpy()
            cents[oc] = c2[:, 0]
            move = valid & (lab == 1)
            # side-1 rows of each cluster move to one new cluster; an
            # unsplittable cluster (side 1 empty) gets no new centroid
            nz = move.any(axis=1)
            new_ids = np.full(o, -1, np.int64)
            new_ids[nz] = len(cents) + n_new + np.arange(int(nz.sum()))
            assign[idx[move]] = np.repeat(new_ids, move.sum(axis=1))
            new_cents.append(c2[nz, 1])
            n_new += int(nz.sum())
        if new_cents:
            cents = np.concatenate([cents] + new_cents)
    return cents, assign


def _pow2_at_least(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
