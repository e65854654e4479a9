"""The HNSW bulk build with its reverse-edge lists from the host C pass
(native/hnsw_host.cpp `reverse_topk`, as the reference builds them) and
from the numpy branch.

Builds the bench's hnsw index, `HnswIndex.add` of the 1M x 128 make_pool
rows on an empty index (the bulk route), four times in the order C, numpy,
numpy, C: the build's seconds (host clock around work that ends in a
synchronize), the seconds spent in `_bulk_reverse_lists` (host), and a
check that the two routes give the same graph (every adjacency row and
the entry point). Exits 1 if they differ.

Run on a CUDA card (about three minutes on an H100):

    python3 scripts/exp_torch_bulk_reverse.py

It prints one JSON object, the card's name and power limit first, and
writes the object to chiprun_out/exp_torch_bulk_reverse.json.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from turdb_tpu_torch.models import hnsw as th  # noqa: E402
from turdb_tpu_torch.native import build as native  # noqa: E402
from turdb_tpu_torch.utils.datasets import make_pool  # noqa: E402

N, DIM = 1_000_000, 128


def build(x, route):
    """One bulk build: (seconds, seconds in the reverse lists, graph)."""
    spent = [0.0]
    inner = th._bulk_reverse_lists
    real = native.reverse_topk

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    th._bulk_reverse_lists = timed
    if route == "numpy":
        native.reverse_topk = lambda *a: None
    try:
        idx = th.HnswIndex(dim=DIM, capacity=N, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx.add(x)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        th._bulk_reverse_lists = inner
        native.reverse_topk = real
    graph = [a[:N].cpu().numpy() for a in (idx.state.adj0, *idx.state.adj_hi)]
    return secs, spent[0], (graph, idx.state.entry)


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_torch_bulk_reverse: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    if not native.crc64_available_native():
        print("exp_torch_bulk_reverse: g++ did not build the native library", file=sys.stderr)
        return 2
    x = make_pool(np.random.default_rng(0), N, DIM)
    out = {"card": card, "n": N, "dim": DIM, "runs": []}
    graphs = {}
    for route in ("c", "numpy", "numpy", "c"):
        secs, rev, (graph, entry) = build(x, route)
        out["runs"].append({"route": route, "build_s": secs, "reverse_lists_s": rev})
        print(json.dumps(out["runs"][-1]), flush=True)
        ref = graphs.setdefault(route, (graph, entry))
        if ref[1] != entry or not all(np.array_equal(a, b) for a, b in zip(ref[0], graph)):
            out["same_graph"] = False
        torch.cuda.empty_cache()
    (gc, ec), (gn, en) = graphs["c"], graphs["numpy"]
    out["same_graph"] = out.get("same_graph", True) and ec == en and all(
        np.array_equal(a, b) for a, b in zip(gc, gn))
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/exp_torch_bulk_reverse.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if out["same_graph"] else 1


if __name__ == "__main__":
    sys.exit(main())
