"""Standalone vector-index usage on the PyTorch / CUDA port: exact, IVF,
HNSW, and a 4-shard mesh.

Runs on the card by default; the mesh's eight devices are copies of it
(4 shards x 2-way query parallel on one card). `--device cpu` runs the
same on the CPU, and `--n` sets the number of rows.

Usage:  python examples/torch_vector_serving.py [--device cpu] [--n 20000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from turdb_tpu_torch.models import FlatIndex, HnswIndex
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.parallel import ShardedIvfIndex, make_mesh


def recall(ids, truth):
    return np.mean([
        len(set(p[p >= 0]) & set(t)) / len(t) for p, t in zip(ids, truth)
    ])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    n, dim = args.n, 64
    centers = rng.standard_normal((256, dim)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 256, n)]
         + rng.standard_normal((n, dim)).astype(np.float32))
    q = (centers[rng.integers(0, 256, 100)]
         + rng.standard_normal((100, dim)).astype(np.float32))

    flat = FlatIndex(dim=dim, capacity=n, device=dev)     # exact oracle
    flat.add(x)
    _, truth = flat.search(q, k=10)

    ivf = IvfIndex(dim=dim, device=dev)                   # the throughput engine
    ivf.add(x)
    ivf.train()
    _, ids = ivf.search(q, k=10, nprobe=8)
    out = {"ivf": recall(ids, truth)}
    print(f"IVF   recall@10 = {out['ivf']:.4f}")

    hnsw = HnswIndex(dim=dim, capacity=n, device=dev)     # the reference algorithm
    hnsw.add(x)
    _, ids = hnsw.search(q, k=10, ef=64)
    out["hnsw"] = recall(ids, truth)
    print(f"HNSW  recall@10 = {out['hnsw']:.4f}")

    mesh = make_mesh(n_db=4, n_data=2, devices=[dev] * 8)  # a 4-shard store
    sivf = ShardedIvfIndex(dim=dim, mesh=mesh, nprobe=8)
    gids = sivf.add(x)
    sivf.train()
    _, sg = sivf.search(q, k=10)
    truth_g = gids[truth]
    out["mesh"] = float(np.mean([
        len(set(sg[i].tolist()) & set(truth_g[i].tolist())) / 10
        for i in range(len(q))
    ]))
    print(f"mesh  recall@10 = {out['mesh']:.4f}  (4 shards x 2-way query parallel)")
    return out


if __name__ == "__main__":
    main()
