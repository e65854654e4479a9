"""Mesh-sharded IVF: one logical clustered index over the shards of a mesh
(port of turdb_tpu/parallel/sharded_ivf.py).

Each db-axis shard owns an independent `IvfIndex` over its part of the
rows, on its device of the first data row; every other data row serves
from its own copy (parallel/sharded.py `RowCopies`). One process drives
them in turn. A query batch is split over the data rows; each row probes
every shard with its slice (K2 / K1 or K4 / K5 as the store asks), and
the shards' [B, k] lists merge as in parallel/sharded.py: global ids
`shard · id_stride + slot`, one K2 over the gathered [B, S·k].
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.models.ivf import (
    IvfConfig,
    IvfIndex,
    _assign_all,
    _kmeans,
    _masked_cn,
    ivf_search_impl,
)
from turdb_tpu_torch.ops.distance import Metric, normalize_rows
from turdb_tpu_torch.parallel.mesh import Mesh
from turdb_tpu_torch.parallel.sharded import (
    RowCopies,
    id_stride,
    mesh_geometry,
    pad_batch,
    search_by_rows,
)

# the reference's pad centroid: far from any row, finite (no inf·0 in the
# products), never assigned
_PAD_CENT = 1e15


class ShardedIvfIndex:
    """Build: per-shard `IvfIndex`es fed by balanced routing (the smallest
    shards fill first), trained shard by shard or, when every shard is
    still untrained, by the mesh path (`_train_mesh`). Search: each
    shard's probe, then the merge. Global ids pack as shard · id_stride +
    slot (int64)."""

    def __init__(self, dim: int, mesh: Mesh, metric: Metric = Metric.L2, nprobe: int = 8,
                 sq8: bool = False, rerank: int | None = None, n_clusters: int | None = None,
                 cluster_cap: int | None = None, keep_f32: bool = True):
        self.mesh = mesh
        self.n_host, self.n_data, self.n_db = mesh_geometry(mesh)
        self.n_shards = self.n_host * self.n_db
        self.devices = mesh.shard_devices()
        self.copies = RowCopies(mesh.data_rows())
        self.dim = dim
        self.metric = metric
        self.nprobe = nprobe
        # keep_f32=False: per-shard compact stores (int8 probe + SQ16 rerank)
        self.shards = [
            IvfIndex(dim=dim, metric=metric, nprobe=nprobe, sq8=sq8, rerank=rerank,
                     n_clusters=n_clusters, cluster_cap=cluster_cap, keep_f32=keep_f32,
                     device=dev)
            for dev in self.devices
        ]
        self.id_stride = id_stride(self.n_shards)
        self._cfg: IvfConfig | None = None   # the shared search config (shard 0's)

    def __len__(self):
        return sum(s.size for s in self.shards)

    def add(self, vecs) -> np.ndarray:
        """Balanced routing (smallest shards fill first); returns packed
        global ids."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = len(vecs)
        self.copies.changed()
        sizes = np.asarray([s.size for s in self.shards])
        order = np.argsort(sizes, kind="stable")
        gids = np.empty(n, np.int64)
        for rank, idxs in zip(order, np.array_split(np.arange(n), self.n_shards)):
            if len(idxs) == 0:
                continue
            shard = self.shards[int(rank)]
            slots = shard.add(vecs[idxs])
            if shard.size > self.id_stride:
                raise ValueError(f"shard {int(rank)} exceeds id_stride={self.id_stride}; "
                                 "packed gids would alias")
            gids[idxs] = int(rank) * self.id_stride + np.asarray(slots)
        self._cfg = None
        return gids

    def train(self):
        """Train every untrained shard (all of them at once through the mesh
        path when none is trained), then bring every shard to the largest
        geometry, so that one search config serves them all."""
        self.copies.changed()
        if all(s.state is None for s in self.shards) and self.n_shards > 1:
            self._train_mesh()
        for s in self.shards:
            if s.state is None:
                s.train()
        self._equalize()

    def _equalize(self):
        """Retrain shards whose (cells, lane cap) differ to the largest."""
        caps = {(s.cfg.n_clusters, s.cfg.cluster_cap) for s in self.shards}
        if len(caps) > 1:
            cmax = max(s.cfg.n_clusters for s in self.shards)
            lmax = max(s.cfg.cluster_cap for s in self.shards)
            for s in self.shards:
                if (s.cfg.n_clusters, s.cfg.cluster_cap) != (cmax, lmax):
                    s._n_clusters = cmax
                    s._cluster_cap = lmax
                    s._retrain_with(np.zeros((0, self.dim), np.float32), np.zeros(0, np.int64))
        self._cfg = self.shards[0].cfg

    def _train_mesh(self):
        """The mesh build: one shared cell count from the largest shard,
        seeds for every shard drawn from one `default_rng(0)` in shard
        order, then each shard's k-means (K3) and assignment on its own
        device and the rest of its build (`IvfIndex.train(_pre=...)`), one
        shard after another."""
        xs = [np.concatenate(s._vectors_host) if s._vectors_host
              else np.zeros((0, self.dim), np.float32) for s in self.shards]
        n_max = max(len(x) for x in xs)
        if n_max == 0:
            return
        c = max(8, min(n_max // 64, max(8, n_max // 4)))
        c = next((s._n_clusters for s in self.shards if s._n_clusters), c)
        rng = np.random.default_rng(0)
        inits = []
        for x in xs:
            kk = min(c, max(len(x), 1))
            sel = rng.choice(max(len(x), 1), size=kk, replace=len(x) < kk)
            init = np.full((c, self.dim), _PAD_CENT, np.float32)
            init[:kk] = x[sel] if len(x) else 0.0
            inits.append(init)
        for s, x, init, dev in zip(self.shards, xs, inits, self.devices):
            if len(x) == 0:
                continue
            xd = torch.as_tensor(x, device=dev)
            xdb = xd.to(torch.bfloat16)
            cents = _kmeans(xd, torch.as_tensor(init, device=dev), 8, xb=xdb)
            assign = _assign_all(xd, cents, _masked_cn(cents, c), xb=xdb).cpu().numpy()
            s._n_clusters = c
            s.train(_pre=(cents, assign, xd))

    def search(self, queries, k: int, nprobe: int | None = None):
        """Returns (dists [B, k], packed gids [B, k] int64, -1 padded)."""
        if self._cfg is None:
            self.train()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        b0 = q.shape[0]
        q = torch.from_numpy(pad_batch(q, self.n_data))
        if self.metric is Metric.COSINE:
            q = normalize_rows(q)
        p = min(nprobe or self.nprobe, self._cfg.n_clusters)

        def run(state, qr, s, dev):
            return ivf_search_impl(state, qr, None, cfg=self._cfg, k=k, nprobe=p)

        d, gi = search_by_rows(self.copies, q, "state", [s.state for s in self.shards], run, k,
                               self.n_host, self.id_stride)
        return d[:b0], gi[:b0]

    def unpack(self, gids):
        gids = np.asarray(gids)
        return gids // self.id_stride, gids % self.id_stride
