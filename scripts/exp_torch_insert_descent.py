"""Where a wave of HNSW inserts lands in a bulk-built graph: the descent.

A bulk-built graph's level 0 is one island per blob, so its search
descends the upper levels by a narrow beam (`HnswIndex._descent_ef`, 32)
and not greedily. Its insert waves (turdb_tpu_torch/models/hnsw.py
`build_wave_impl`) take the same descent. This experiment builds the
bench's hnsw index over the first N - N_INSERT rows of make_pool (the bulk
build, as chip_smoke.py does), then inserts the last N_INSERT rows twice
into copies of that graph, through the index's own path: once with the
waves' descent at 1 (the greedy walk, K9: the reference's, which a
wave-built graph keeps), and once at the graph's descent_ef. Both copies
are searched as the bulk graph is. For the inserted rows it reports the
share found first by their own query at ef 64 and 256 (also for the first
N_SINGLE, which go in as one `add`, the wave an SQL statement's flush
makes of its INSERTs), the share of their level-0 edges among their 32
exact nearest neighbours (1024 of them), their level-0 in-degree, and the
seconds of the adds.

Run on a CUDA card (about a minute on an H100):

    python3 scripts/exp_torch_insert_descent.py

It prints one JSON object and writes it to
chiprun_out/exp_torch_insert_descent.json.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from turdb_tpu_torch.models import hnsw as th  # noqa: E402
from turdb_tpu_torch.utils.datasets import make_pool  # noqa: E402

N, N_QUERIES, DIM, N_INSERT, N_SINGLE = 1_000_000, 16_384, 128, 65_536, 256


def clone(idx):
    c = copy.copy(idx)
    st = idx.state
    c.state = st._replace(vectors=st.vectors.clone(), norms=st.norms.clone(),
                          adj0=st.adj0.clone(), adj_hi=tuple(a.clone() for a in st.adj_hi),
                          levels=st.levels.clone())
    c._alive = idx._alive.copy()
    return c


def self_hit(idx, rows, slots, ef, chunk=16_384):
    hits = 0
    for s in range(0, len(rows), chunk):
        _, ids = idx.search(rows[s:s + chunk], 1, ef=ef)
        hits += int((ids[:, 0] == slots[s:s + chunk]).sum())
    return hits / len(rows)


def measure(idx, new, slots):
    dev = idx.device
    out = {f"self_hit_ef{ef}": self_hit(idx, new, slots, ef) for ef in (64, 256)}
    out["self_hit_ef64_first_add"] = self_hit(idx, new[:N_SINGLE], slots[:N_SINGLE], 64)
    a0 = idx.state.adj0[:idx.size]
    indeg = torch.zeros(idx.size, dtype=torch.int64, device=dev)
    e = a0[a0 >= 0].long()
    indeg.index_add_(0, e, torch.ones_like(e))
    n0 = int(slots[0])
    out["indeg0_mean_inserted"] = float(indeg[n0:].float().mean())
    out["indeg0_mean_old"] = float(indeg[:n0].float().mean())
    out["indeg0_zero_share_inserted"] = float((indeg[n0:] == 0).float().mean())
    sub = torch.as_tensor(new[:1024], device=dev)
    st = idx.state
    d = (sub * sub).sum(1)[:, None] + st.norms[:idx.size][None, :] - 2 * sub @ st.vectors[
        :idx.size].T
    own = torch.as_tensor(slots[:1024], device=dev).long()
    d[torch.arange(1024, device=dev), own] = float("inf")
    nn = torch.topk(d, 32, largest=False).indices
    fwd = a0[own].long()
    out["edges_in_32nn"] = float((fwd[:, :, None] == nn[:, None, :]).any(-1).float().mean())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_torch_insert_descent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    x = make_pool(np.random.default_rng(0), N + N_QUERIES, DIM)[:N]
    n0 = N - N_INSERT
    base = th.HnswIndex(dim=DIM, ef_construction=100, build_batch=512, capacity=N, device=dev)
    t = time.perf_counter()
    base.add(x[:n0])
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    report = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown",
              "bulk_rows": n0, "bulk_s": bulk_s}
    new, slots = x[n0:], np.arange(n0, N)
    for name, descent_ef in (("greedy_descent", 1), ("beam_descent", base._descent_ef)):
        idx = clone(base)
        idx._descent_ef = descent_ef     # the waves' descent
        t = time.perf_counter()
        idx.add(new[:N_SINGLE])
        idx.add(new[N_SINGLE:])
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t
        idx._descent_ef = base._descent_ef   # searched as the bulk graph is
        report[name] = {"descent_ef": descent_ef, "add_s": add_s, **measure(idx, new, slots)}
        del idx
        torch.cuda.empty_cache()
    line = json.dumps(report)
    print(line)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "exp_torch_insert_descent.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
