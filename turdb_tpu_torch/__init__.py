"""turdb_tpu_torch — turdb_tpu on PyTorch and CUDA.

A second package beside `turdb_tpu` (the JAX reference, which it never
imports). It mirrors the reference layout:

    database/         Database, connect: the SQL engine's entry points
                      (`USING IVF` / `USING HNSW` on the indexes below)
    cli/              the REPL: python -m turdb_tpu_torch.cli <dir>
    sql/, records/, types/, mvcc/, memory/, storage/, native/, config.py
                      the host layers, copies of the reference's
                      (storage/hnsw_io.py reads and writes its .hnsw files)

    ops/distance.py   Metric, norms, pairwise / gathered distances
    ops/topk.py       exact k-smallest selection, dedup, membership
    ops/quantize.py   SQ8 / SQ16 row encodings, int8 query quantization,
                      sq8_search over a u8 store
    models/flat.py    FlatIndex: exact chunked k-NN (the recall oracle)
    models/ivf.py     IvfIndex: k-means build + fused cell probe over the
                      f32 store, the SQ8 probe with exact rerank (f32 or
                      SQ16 rows), the probe-only int8 store, dense blocks
    models/hnsw.py    HnswIndex: bulk build, insert waves, graph search
    models/hnsw_serve.py  the HNSW serving pack and its search
    parallel/         the mesh: ShardedIvfIndex, ShardedHnswIndex
    kernels/          hand-written CUDA C++ kernels for sm_90a + wrappers
    convert.py        reference state (as numpy) -> port state
    graft_entry.py    entry() / dryrun_multichip(n): the counterparts of
                      the repository's __graft_entry__.py
    utils/            datasets (make_pool, emb_pool, loaders), timing
                      (phase counters, CUDA events, profile_trace)

Every index, and every Database, runs on the card unless its `device`
says otherwise. On a CPU tensor each kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the hand-written kernel or raises.
"""

__version__ = "0.1.0"

import torch

# The reference forces full fp32 on every distance product
# (turdb_tpu/ops/distance.py PRECISE); TF32 keeps ~3 decimal digits and
# would reorder near neighbours, so both TF32 switches stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from turdb_tpu_torch.ops.distance import Metric  # noqa: E402

__all__ = ["Metric", "Database", "connect", "RecoveryInfo",
           "CheckpointInfo", "__version__"]


def __getattr__(name):
    # Lazy: the SQL/database stack is large; keep `import turdb_tpu_torch`
    # cheap for index-only users (ops/, models/).
    if name in ("Database", "connect", "RecoveryInfo", "CheckpointInfo"):
        from turdb_tpu_torch.database import api

        return getattr(api, name)
    raise AttributeError(f"module 'turdb_tpu_torch' has no attribute {name!r}")
