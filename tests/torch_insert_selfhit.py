"""Inserts into a bulk-built graph, in both packages on the CPU: how many of
the inserted rows their own query finds.

The insert waves descend the upper levels greedily (`_wave_level_core`),
also into a bulk-built graph, whose own search takes a descent beam
because a greedy walk sticks there. On make_pool data the share of
inserted rows found falls as the blobs grow; this script shows that the
reference does the same as the port on the same data.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_insert_selfhit.py --n 40000 --blobs 40
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_insert_selfhit.py \
        --n 120000 --inserts 8192 --blobs 120

(a few minutes and about ten on a CPU; pytest does not collect it). Builds both indexes with the bench's parameters (ef_construction 100,
build_batch 512), bulk-loads the first n - inserts rows of
`make_pool(default_rng(seed), n, dim, blobs)`, adds the rest in one `add`
(waves of 512), and prints one JSON line: per package the share of
inserted rows that are the first answer to their own row at ef 64, the
same for the first 512 bulk rows, and the seconds; then the share of
inserted rows on which the two packages' first answers agree.
"""

import argparse
import json
import time

import numpy as np
import torch

from turdb_tpu.models import hnsw as jh
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.utils.datasets import make_pool


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=40000)
    ap.add_argument("--inserts", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--blobs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    x = make_pool(np.random.default_rng(a.seed), a.n, a.dim, n_clusters=a.blobs)
    nb = a.n - a.inserts
    cap = 1 << max(10, (a.n - 1).bit_length())
    out = {"n": a.n, "inserts": a.inserts, "dim": a.dim, "blobs": a.blobs, "seed": a.seed}
    first = {}
    for name, idx in (
            ("reference", jh.HnswIndex(dim=a.dim, ef_construction=100, build_batch=512,
                                       capacity=cap)),
            ("port", th.HnswIndex(dim=a.dim, ef_construction=100, build_batch=512, capacity=cap,
                                  device="cpu"))):
        t0 = time.perf_counter()
        idx.add(x[:nb])
        t1 = time.perf_counter()
        idx.add(x[nb:])
        t2 = time.perf_counter()
        ids = np.asarray(idx.search(x[nb:], k=1, ef=64)[1])[:, 0]
        old = np.asarray(idx.search(x[:512], k=1, ef=64)[1])[:, 0]
        first[name] = ids
        out[name] = {"inserted_self_hit": float((ids == np.arange(nb, a.n)).mean()),
                     "bulk_self_hit": float((old == np.arange(512)).mean()),
                     "bulk_s": t1 - t0, "insert_s": t2 - t1}
    out["first_answers_equal"] = float((first["reference"] == first["port"]).mean())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
