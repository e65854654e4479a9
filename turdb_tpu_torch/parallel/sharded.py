"""Mesh-sharded HNSW: one logical index over the shards of a mesh (port of
turdb_tpu/parallel/sharded.py).

Each db-axis shard (host x db on a multi-host mesh) holds an independent
HNSW graph over its part of the rows, kept as a per-shard `HnswIndex` on
the shard's device: a list of states, one per mesh position, where the
reference stacks them into [S, ...] arrays laid out over the mesh. One
process drives every shard in turn, as the reference's single controller
does. A query batch runs the local search on every shard; each shard's
[B, k] slot ids become global ids `shard · id_stride + slot`, and the
shards' lists merge on the first device by one K2 `topk_rows` over the
gathered [B, S·k] (`_two_level_merge`; on a multi-host mesh once within
each host and once across hosts).
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.kernels import topk_rows
from turdb_tpu_torch.models.hnsw import HNSW_BUILD_BATCH, HnswIndex, hnsw_search_impl
from turdb_tpu_torch.ops.distance import Metric, normalize_rows
from turdb_tpu_torch.parallel.mesh import MESH_AXIS_DATA, MESH_AXIS_DB, MESH_AXIS_HOST, Mesh

INF = float("inf")
# rows per shard from which an empty index loads by the bulk build
BULK_PER_SHARD = 8192


def id_stride(n_shards: int) -> int:
    """The largest power of two with n_shards · stride <= 2**31: the
    reference packs global ids in int32, which then never alias, and a
    shard may grow to `stride` rows without re-basing its ids."""
    stride = 1 << 30
    while stride * n_shards > (1 << 31):
        stride >>= 1
    return stride


def pack_gids(d: torch.Tensor, i: torch.Tensor, shard: int, stride: int) -> torch.Tensor:
    """A shard's [B, k] slot ids -> int64 global ids (-1 where +inf)."""
    gi = shard * stride + i.long()
    return torch.where((i >= 0) & ~torch.isinf(d), gi, -1)


def _merge(ds, gis, k: int, device):
    d = torch.cat([x.to(device) for x in ds], dim=1).contiguous()
    gi = torch.cat([g.to(device) for g in gis], dim=1)
    md, pos = topk_rows(d, k)
    return md, torch.gather(gi, 1, pos.long())


def _two_level_merge(ds, gis, k: int, n_host: int, device):
    """The cross-shard top-k: the shards' [B, k] distances / global ids, in
    shard order (host-major), go to `device`; one K2 launch per host
    selects the k best of that host's [B, n_db · k], then, on a multi-host
    mesh, one more over the hosts' [B, n_host · k]. Ties go to the lower
    shard. Returns ([B, k] distances ascending, [B, k] int64 global ids)."""
    per = len(ds) // n_host
    hosts = [_merge(ds[h * per:(h + 1) * per], gis[h * per:(h + 1) * per], k, device)
             for h in range(n_host)]
    if n_host == 1:
        return hosts[0]
    return _merge([d for d, _ in hosts], [g for _, g in hosts], k, device)


def pad_batch(q: np.ndarray, n_data: int) -> np.ndarray:
    """Pad a query batch with zero rows to a multiple of the data axis."""
    b0 = q.shape[0]
    bpad = -(-b0 // n_data) * n_data
    if bpad == b0:
        return q
    return np.concatenate([q, np.zeros((bpad - b0, q.shape[1]), np.float32)])


def mesh_geometry(mesh: Mesh) -> tuple[int, int, int]:
    """(n_host, n_data, n_db) of a mesh."""
    shape = mesh.shape
    return shape.get(MESH_AXIS_HOST, 1), shape.get(MESH_AXIS_DATA, 1), shape[MESH_AXIS_DB]


class ShardedHnswIndex:
    """One logical HNSW index sharded over the mesh's `db` axis (host x db).

    Global ids are (shard, slot) pairs packed as shard · id_stride + slot
    (int64), with a fixed power-of-two stride: ids handed out stay valid
    when a shard's capacity grows. Every shard keeps the same capacity.
    """

    def __init__(self, dim: int, mesh: Mesh, metric: Metric = Metric.L2, m: int = 16,
                 ef_construction: int = 100, ef_search: int = 64,
                 capacity_per_shard: int = 4096, build_batch: int = HNSW_BUILD_BATCH):
        self.mesh = mesh
        self.n_host, self.n_data, self.n_db = mesh_geometry(mesh)
        self.n_shards = self.n_host * self.n_db
        self.devices = mesh.shard_devices()
        self.id_stride = id_stride(self.n_shards)
        self.shards = [
            HnswIndex(dim=dim, metric=metric, m=m, ef_construction=ef_construction,
                      ef_search=ef_search, capacity=capacity_per_shard, build_batch=build_batch,
                      device=dev)
            for dev in self.devices
        ]
        self.cfg = self.shards[0].cfg
        self.capacity = self.shards[0].capacity
        self._serve = None      # per-shard serving packs (derived state)
        self._descent_ef = 1    # bulk-built shards raise this (see add)

    def __len__(self):
        return int(self.sizes.sum())

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray([s.size for s in self.shards], np.int64)

    # -- id packing -------------------------------------------------------

    def pack_ids(self, shard, slot):
        return np.asarray(shard).astype(np.int64) * self.id_stride + slot

    def unpack_ids(self, gids):
        gids = np.asarray(gids)
        return gids // self.id_stride, gids % self.id_stride

    # -- build ------------------------------------------------------------

    def add(self, vecs, row_ids=None) -> np.ndarray:
        """Insert rows, filling the smallest shards first; returns their
        packed global ids. An empty index given at least n_shards · 8192
        rows loads each shard by the bulk build (round-robin rows); every
        other add runs each shard's insert waves. Levels follow the global
        row ids (default: insertion order)."""
        self._serve = None     # graph mutation invalidates the packs
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = vecs.shape[0]
        if row_ids is None:
            base = len(self)
            row_ids = np.arange(base, base + n, dtype=np.uint64)
        row_ids = np.asarray(row_ids, np.uint64)
        if len(self) == 0 and n >= self.n_shards * BULK_PER_SHARD:
            return self._bulk_add_mesh(vecs, row_ids)
        sizes = self.sizes
        order = np.argsort(sizes, kind="stable")
        target = -(-(int(sizes.sum()) + n) // self.n_shards)
        shard_of = np.empty(n, np.int32)
        cursor = 0
        for s in order:
            take = min(max(0, int(target - sizes[s])), n - cursor)
            shard_of[cursor:cursor + take] = s
            cursor += take
            if cursor == n:
                break
        shard_of[cursor:] = order[0]
        gids = np.empty(n, np.int64)
        for s, shard in enumerate(self.shards):
            idxs = np.flatnonzero(shard_of == s)
            if len(idxs) == 0:
                continue
            shard.bulk_threshold = n + 1          # this path inserts by waves
            slots = shard.add(vecs[idxs], row_ids=row_ids[idxs])
            gids[idxs] = self.pack_ids(np.full(len(idxs), s), slots)
        self._sync_capacity()
        return gids

    def _bulk_add_mesh(self, vecs: np.ndarray, row_ids: np.ndarray) -> np.ndarray:
        """Initial load: each shard's graph comes from the bulk build over
        every S-th row, on its own device, one shard after another (one
        process drives the mesh; the reference's threads overlap shards on
        separate devices)."""
        n, S = len(vecs), self.n_shards
        per = [np.arange(s, n, S) for s in range(S)]
        self._ensure(max(len(p) for p in per))
        if self.cfg.metric is Metric.COSINE:
            # the reference normalises here and its shard's add once more
            vecs = normalize_rows(torch.from_numpy(vecs)).numpy()
        gids = np.empty(n, np.int64)
        for s, shard in enumerate(self.shards):
            shard.bulk_threshold = 1024
            slots = shard.add(vecs[per[s]], row_ids=row_ids[per[s]])
            gids[per[s]] = self.pack_ids(np.full(len(slots), s), slots)
        self._sync_capacity()
        self._descent_ef = 32   # bulk graphs need the wide descent beam
        return gids

    # -- query ------------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        q = torch.from_numpy(pad_batch(q, self.n_data))
        return normalize_rows(q) if self.cfg.metric is Metric.COSINE else q

    def _masks(self, allowed):
        """Per-shard [cap] visibility masks (alive, and `allowed` [S, cap]
        where given), or None when every row is visible: then no shard
        filters, else every shard does, as in the reference."""
        if allowed is None and self._all_alive():
            return None
        m = np.stack([s._alive for s in self.shards])
        if allowed is not None:
            m &= np.asarray(allowed, bool)
        return [torch.as_tensor(m[s], device=dev) for s, dev in enumerate(self.devices)]

    def _empty(self, b, k):
        return np.full((b, k), INF, np.float32), np.full((b, k), -1, np.int64)

    def _merged(self, parts, k, b0):
        ds = [d for d, _ in parts]
        gis = [pack_gids(d, i, s, self.id_stride) for s, (d, i) in enumerate(parts)]
        d, gi = _two_level_merge(ds, gis, k, self.n_host, self.devices[0])
        return d.cpu().numpy()[:b0], gi.cpu().numpy()[:b0]

    def search(self, queries, k: int, ef: int | None = None, allowed=None):
        """Batched k-NN over all shards. `allowed`: bool [n_shards,
        capacity] visibility. Returns (dists [B, k], packed gids [B, k]
        int64, -1 padded)."""
        b0 = np.atleast_2d(np.asarray(queries)).shape[0]
        if len(self) == 0:
            return self._empty(b0, k)
        q = self._queries(queries)
        ef = max(ef or max(self.cfg.ef_search, k), k)
        masks = self._masks(allowed)
        parts = [
            hnsw_search_impl(shard.state, q.to(dev), None if masks is None else masks[s],
                             cfg=self.cfg, k=k, ef=ef, iters=ef + ef // 2,
                             filtered=masks is not None, descent_ef=self._descent_ef)
            for s, (shard, dev) in enumerate(zip(self.shards, self.devices))
        ]
        return self._merged(parts, k, b0)

    # -- serving pack -----------------------------------------------------

    def pack_serving(self, n_centroids: int | None = None) -> None:
        """Per-shard serving packs, each on its shard's device. The cell
        count c and lane cap are pinned from the LARGEST shard, so every
        pack has one geometry although sizes differ by one."""
        from turdb_tpu_torch.models.hnsw_serve import _pow2_at_least, pack_serving

        if len(self) == 0:
            self._serve = None
            return
        size_hint = int(self.sizes.max())
        c = n_centroids or max(64, min(8192, size_hint // 256))
        c = _pow2_at_least(min(c, max(1, size_hint)), floor=64)
        lcap = _pow2_at_least(max(int(2 * size_hint / max(c, 1)), 8), floor=8)
        self._serve = [
            pack_serving(s.state.vectors, s.state.norms, s.state.adj0, s.size, self.cfg.metric,
                         n_centroids=c, lane_cap=lcap)
            for s in self.shards
        ]

    def search_serve(self, queries, k: int, ef: int | None = None, allowed=None,
                     iters: int | None = None, nprobe: int = 2, nseed: int = 32,
                     expand: int = 4):
        """Serving-path mesh k-NN: each shard's packed-block beam and the
        same merge as `search`. Packs on first use; the distances are exact
        (the rerank stage)."""
        from turdb_tpu_torch.models.hnsw_serve import serve_search_impl

        b0 = np.atleast_2d(np.asarray(queries)).shape[0]
        if len(self) == 0:
            return self._empty(b0, k)
        if self._serve is None:
            self.pack_serving()
        q = self._queries(queries)
        ef = max(ef or max(self.cfg.ef_search, k), k)
        iters = iters or (ef + ef // 2)
        masks = self._masks(allowed)
        parts = [
            serve_search_impl(sv, q.to(dev), None if masks is None else masks[s],
                              metric=self.cfg.metric, k=k, ef=ef, iters=iters, expand=expand,
                              nprobe=nprobe, nseed=nseed)
            for s, (sv, dev) in enumerate(zip(self._serve, self.devices))
        ]
        return self._merged(parts, k, b0)

    def delete(self, gids) -> None:
        """Tombstones: the nodes stay as stepping stones."""
        sh, sl = self.unpack_ids(np.atleast_1d(np.asarray(gids, np.int64)))
        for s in np.unique(sh):
            self.shards[int(s)].delete(sl[sh == s])

    def _all_alive(self) -> bool:
        return all(s._alive[: s.size].all() for s in self.shards)

    # -- memory -----------------------------------------------------------

    def _ensure(self, need: int):
        """Grow every shard to the capacity `need` rows call for."""
        for s in self.shards:
            s._ensure(need)
        self._sync_capacity()

    def _sync_capacity(self):
        """Every shard at the largest shard's capacity, which the fixed
        stride bounds."""
        cap = max(s.capacity for s in self.shards)
        if cap > self.id_stride:
            raise ValueError(f"per-shard capacity {cap} exceeds id_stride={self.id_stride}; "
                             "packed gids would alias")
        for s in self.shards:
            s._ensure(cap - 1)
        self.capacity = cap
