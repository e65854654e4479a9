"""The port's counterparts of the repository's `__graft_entry__.py`: a
one-step forward check and a mesh dry run, on the card by default.

`entry()` returns (fn, example_args): one batched HNSW k-NN search
(`hnsw_search_impl`) on a graph synthesized from `default_rng(0)` in the
reference's draw order (512 of 1,024 slots linked, 128-d, 64 queries, k 10,
ef 32, iters 48), so the same seed gives the same graph and queries in both
packages. `dryrun_multichip(n_devices)` builds the reference's mesh (data x
db where n is even and above 2) over `n_devices` copies of one device, runs
a sharded HNSW build wave and search, a sharded IVF build and search held
to recall@10 >= 0.8 against an exact oracle, and, for n >= 4, the same on a
(host 2, db n/2) mesh with the two-level merge. Nothing here falls back to
the CPU: without a card the default device raises.
"""

from __future__ import annotations

import numpy as np
import torch

RECALL_FLOOR = 0.8


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def entry(device="cuda"):
    """(fn, (state, queries)) of one HNSW search step: fn(state, q) returns
    ([64, 10] distances, [64, 10] int32 slots)."""
    from turdb_tpu_torch.models.hnsw import HnswConfig, HnswState, hnsw_search_impl
    from turdb_tpu_torch.ops.distance import prep_norms

    device = torch.device(device)
    rng = np.random.default_rng(0)
    n, cap, d = 512, 1024, 128
    cfg = HnswConfig(dim=d)
    vecs = torch.as_tensor(rng.standard_normal((cap, d)).astype(np.float32), device=device)

    def rand_adj(deg, hi):
        a = rng.integers(0, hi, (cap, deg)).astype(np.int32)
        a[hi:] = -1
        return torch.as_tensor(a, device=device)

    state = HnswState(
        vectors=vecs,
        norms=prep_norms(vecs),
        adj0=rand_adj(cfg.m0, n),
        adj_hi=tuple(rand_adj(cfg.m, max(n // 16 ** (i + 1), 2))
                     for i in range(cfg.max_levels - 1)),
        levels=torch.zeros((cap,), dtype=torch.int32, device=device),
        entry=0,
        max_level=cfg.max_levels - 1,
    )
    queries = torch.as_tensor(rng.standard_normal((64, d)).astype(np.float32), device=device)

    def fn(state, q):
        return hnsw_search_impl(state, q, None, cfg=cfg, k=10, ef=32, iters=48, filtered=False)

    return fn, (state, queries)


def _recall(got, want):
    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / len(w)
                          for g, w in zip(got, want)]))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The mesh-parallel index step on `n_devices` copies of `device`, with
    the reference's shapes and checks; returns what it measured (the
    sharded IVF's recall@10 under "ivf_recall")."""
    from turdb_tpu_torch.parallel import ShardedHnswIndex, ShardedIvfIndex, make_mesh
    from turdb_tpu_torch.parallel.mesh import make_multihost_mesh

    devs = [torch.device(device)] * n_devices
    if n_devices % 2 == 0 and n_devices > 2:
        mesh = make_mesh(n_db=n_devices // 2, n_data=2, devices=devs)
    else:
        mesh = make_mesh(n_db=n_devices, n_data=1, devices=devs)

    rng = np.random.default_rng(0)
    idx = ShardedHnswIndex(dim=64, mesh=mesh, ef_construction=16, ef_search=16,
                           capacity_per_shard=1024, build_batch=32)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    idx.add(x)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    d, gids = idx.search(q, k=4, ef=16)
    _check(d.shape == (8, 4) and gids.shape == (8, 4), f"HNSW search shapes {d.shape}")
    _check((gids[:, 0] >= 0).all(), "an HNSW query found nothing")

    # the clustered engine over the same mesh, held to a recall floor
    # against an exact oracle
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 4.0
    xa = (centers[rng.integers(0, 16, 1024)]
          + rng.standard_normal((1024, 64)).astype(np.float32))
    qa = (centers[rng.integers(0, 16, 32)]
          + rng.standard_normal((32, 64)).astype(np.float32))
    ivf = ShardedIvfIndex(dim=64, mesh=mesh, nprobe=8, n_clusters=16, cluster_cap=256)
    gids = ivf.add(xa)
    ivf.train()
    d2, g2 = ivf.search(qa, k=10)
    _check(d2.shape == (32, 10) and (g2[:, 0] >= 0).all(), "the sharded IVF search")
    d_all = ((qa[:, None, :] - xa[None, :, :]) ** 2).sum(-1)
    truth_g = gids[np.argsort(d_all, axis=1)[:, :10]]
    rec = _recall(g2, truth_g)
    _check(rec >= RECALL_FLOOR, f"sharded IVF recall {rec:.3f} below {RECALL_FLOOR}")
    out = {"mesh": mesh.shape, "ivf_recall": rec}

    # (host 2) x (db n/2) with the two-level merge
    if n_devices >= 4 and n_devices % 2 == 0:
        mmesh = make_multihost_mesh(n_host=2, n_db=n_devices // 2, devices=devs)
        hidx = ShardedHnswIndex(dim=64, mesh=mmesh, ef_construction=16, ef_search=16,
                                capacity_per_shard=1024, build_batch=32)
        hidx.add(x)
        d3, g3 = hidx.search(q, k=4, ef=16)
        _check(d3.shape == (8, 4) and (g3[:, 0] >= 0).all(), "the multi-host HNSW search")
        mivf = ShardedIvfIndex(dim=64, mesh=mmesh, nprobe=4, n_clusters=8, cluster_cap=32)
        mivf.add(rng.standard_normal((128, 64)).astype(np.float32))
        mivf.train()
        d4, g4 = mivf.search(q, k=4)
        _check(d4.shape == (8, 4) and (g4[:, 0] >= 0).all(), "the multi-host IVF search")
        out["multihost_mesh"] = mmesh.shape
    return out
