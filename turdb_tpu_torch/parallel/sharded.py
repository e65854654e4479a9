"""Mesh-sharded HNSW: one logical index over the shards of a mesh (port of
turdb_tpu/parallel/sharded.py).

Each db-axis shard (host x db on a multi-host mesh) holds an independent
HNSW graph over its part of the rows, kept as a per-shard `HnswIndex` on
the shard's device of the first data row: a list of states, one per mesh
position, where the reference stacks them into [S, ...] arrays laid out
over the mesh. Every other row of the data axis serves from its own copy
of each shard's state (`RowCopies`), as the reference replicates the
store over `data`. One process drives every shard in turn, as the
reference's single controller does. A query batch is padded to a
multiple of the data axis and split into one slice per row; each row
runs the local search of its slice on every shard, each shard's [B, k]
slot ids become global ids `shard · id_stride + slot`, and the shards'
lists merge on the row's first device by one K2 `topk_rows` over the
gathered [B, S·k] (`_two_level_merge`; on a multi-host mesh once within
each host and once across hosts). The rows' answers are concatenated in
order.
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.kernels import topk_rows
from turdb_tpu_torch.models.hnsw import HNSW_BUILD_BATCH, HnswIndex, hnsw_search_impl
from turdb_tpu_torch.ops.distance import Metric, normalize_rows
from turdb_tpu_torch.ops.quantize import Sq8Rows
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


def _same_memory(a: torch.device, b: torch.device) -> bool:
    """Whether a state on device `a` serves device `b` as it is."""
    return a == b


def _to_device(obj, dev):
    """A copy of a search state (NamedTuples and tuples of tensors, an
    `Sq8Rows` store, plain ints) with every tensor copied to `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev, copy=True)
    if isinstance(obj, Sq8Rows):
        return Sq8Rows(*(_to_device(t, dev) for t in (obj.codes, obj.mins, obj.scales)))
    if isinstance(obj, tuple):
        items = [_to_device(v, dev) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


class RowCopies:
    """Each data row's copy of every shard's search state. Row 0 holds the
    shards' own states, where every write lands; row r > 0 serves from
    copies on its devices, made at first use and again after the shard
    changed (a version counter per shard, bumped by every write) or its
    state was replaced. Where row r's device is row 0's, the copy is row
    0's state itself, not a second allocation."""

    def __init__(self, rows: list[list[torch.device]]):
        self.rows = rows
        self.version = [0] * len(rows[0])
        self._copies: dict = {}

    def changed(self, shards=None) -> None:
        """A write touched these shards (default: all): their copies are
        stale."""
        for s in range(len(self.version)) if shards is None else shards:
            self.version[int(s)] += 1

    def get(self, r: int, s: int, kind: str, state):
        """Row r's copy of shard s's `state` (`kind` names which one)."""
        dev = self.rows[r][s]
        if r == 0 or _same_memory(self.rows[0][s], dev):
            return state
        hit = self._copies.get((r, s, kind))
        if hit is None or hit[0] != self.version[s] or hit[1] is not state:
            hit = self._copies[(r, s, kind)] = (self.version[s], state, _to_device(state, dev))
        return hit[2]


def search_by_rows(copies: RowCopies, q: torch.Tensor, kind: str, states, search, k: int,
                   n_host: int, stride: int):
    """The data axis at work: the padded batch `q` (a multiple of the rows)
    is cut into one equal slice per row of `copies`; row r runs
    `search(state, q_r, s, device)` of its slice on its copy of each
    shard's state, packs the shards' slot ids into global ids and merges
    them on its first device (`_two_level_merge`). Returns numpy ([B, k]
    distances, [B, k] int64 global ids), the rows' answers in order."""
    bs = q.shape[0] // len(copies.rows)
    ds, gis = [], []
    for r, devs in enumerate(copies.rows):
        qr = q[r * bs:(r + 1) * bs]
        parts = [search(copies.get(r, s, kind, st), qr.to(dev), s, dev)
                 for s, (st, dev) in enumerate(zip(states, devs))]
        d, gi = _two_level_merge([d for d, _ in parts],
                                 [pack_gids(d, i, s, stride) for s, (d, i) in enumerate(parts)],
                                 k, n_host, devs[0])
        ds.append(d.cpu().numpy())
        gis.append(gi.cpu().numpy())
    return np.concatenate(ds), np.concatenate(gis)


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
        self.copies = RowCopies(mesh.data_rows())
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
        self.copies.changed()
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
        """[S, cap] visibility (alive, and `allowed` where given), or None
        when every row is visible: then no shard filters, else every shard
        does, as in the reference."""
        if allowed is None and self._all_alive():
            return None
        m = np.stack([s._alive for s in self.shards])
        if allowed is not None:
            m &= np.asarray(allowed, bool)
        return m

    def _empty(self, b, k):
        return np.full((b, k), INF, np.float32), np.full((b, k), -1, np.int64)

    def search(self, queries, k: int, ef: int | None = None, allowed=None):
        """Batched k-NN over all shards. `allowed`: bool [n_shards,
        capacity] visibility. Returns (dists [B, k], packed gids [B, k]
        int64, -1 padded)."""
        b0 = np.atleast_2d(np.asarray(queries)).shape[0]
        if len(self) == 0:
            return self._empty(b0, k)
        ef = max(ef or max(self.cfg.ef_search, k), k)
        masks = self._masks(allowed)

        def run(state, q, s, dev):
            mask = None if masks is None else torch.as_tensor(masks[s], device=dev)
            return hnsw_search_impl(state, q, mask, cfg=self.cfg, k=k, ef=ef,
                                    iters=ef + ef // 2, filtered=masks is not None,
                                    descent_ef=self._descent_ef)

        d, gi = search_by_rows(self.copies, self._queries(queries), "state",
                               [s.state for s in self.shards], run, k, self.n_host,
                               self.id_stride)
        return d[:b0], gi[:b0]

    # -- serving pack -----------------------------------------------------

    def pack_serving(self, n_centroids: int | None = None) -> None:
        """Per-shard serving packs, each on its shard's device. The cell
        count c and lane cap are pinned from the LARGEST shard, so every
        pack has one geometry although sizes differ by one."""
        from turdb_tpu_torch.models.hnsw_serve import _pow2_at_least, pack_serving

        self.copies.changed()
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
        ef = max(ef or max(self.cfg.ef_search, k), k)
        iters = iters or (ef + ef // 2)
        masks = self._masks(allowed)

        def run(pack, q, s, dev):
            mask = None if masks is None else torch.as_tensor(masks[s], device=dev)
            return serve_search_impl(pack, q, mask, metric=self.cfg.metric, k=k, ef=ef,
                                     iters=iters, expand=expand, nprobe=nprobe, nseed=nseed)

        d, gi = search_by_rows(self.copies, self._queries(queries), "serve", self._serve, run,
                               k, self.n_host, self.id_stride)
        return d[:b0], gi[:b0]

    def delete(self, gids) -> None:
        """Tombstones: the nodes stay as stepping stones."""
        sh, sl = self.unpack_ids(np.atleast_1d(np.asarray(gids, np.int64)))
        self.copies.changed(np.unique(sh))
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
