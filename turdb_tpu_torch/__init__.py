"""turdb_tpu_torch — the IVF vector engine of turdb_tpu on PyTorch and CUDA.

A second package beside `turdb_tpu` (the JAX reference, which it never
imports). It mirrors the reference layout:

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

Every index runs on the card unless its `device` says otherwise. On a CPU
tensor each kernel wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.
"""

import torch

# The reference forces full fp32 on every distance product
# (turdb_tpu/ops/distance.py PRECISE); TF32 keeps ~3 decimal digits and
# would reorder near neighbours, so both TF32 switches stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from turdb_tpu_torch.ops.distance import Metric  # noqa: E402

__all__ = ["Metric"]
