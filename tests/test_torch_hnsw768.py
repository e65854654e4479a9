"""The HNSW bulk build at 768 dims (BERT-base / mpnet width) in the port
against the reference, on the CPU: `emb_pool` rows (unit norm, cosine),
level 0 past the host route (`_BULK_BRUTE`, lowered in both packages to
reach it at test size, as tests/test_torch_hnsw.py does), which on the
card runs K7's wide form (64 candidates of 768 floats: 196,608 bytes of
rows, past the fast form's 160 KB). The port's graph reaches as many
nodes from its entry over its levels as the reference's (within 0.005)
and recalls@10 at ef 64 within 0.02 of it."""

import numpy as np
import torch

from test_torch_hnsw import _levels, _reachable
from turdb_tpu.models import hnsw as jh
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.utils.datasets import emb_pool, recall_of

torch.set_num_threads(1)

N, DIM = 2500, 768


def test_bulk_build_at_768_dims(monkeypatch):
    for mod in (jh, th):
        monkeypatch.setattr(mod, "_BULK_BRUTE", 1024)
    base, queries = emb_pool(np.random.default_rng(0), N, n_queries=32, dim=DIM)
    truth = np.argsort(-(queries @ base.T), axis=1)[:, :10]
    ref = jh.HnswIndex(dim=DIM, capacity=N, metric=JaxMetric.COSINE, bulk_threshold=2048)
    port = th.HnswIndex(dim=DIM, capacity=N, metric=Metric.COSINE, bulk_threshold=2048,
                        device="cpu")
    ref.add(base)
    port.add(base)
    out = []
    for idx in (port, ref):
        _, ids = idx.search(queries, k=10, ef=64)
        out.append((_reachable(_levels(idx.state), int(idx.state.entry), N),
                    recall_of(np.asarray(ids), truth)))
    (reach, rec), (w_reach, w_rec) = out
    assert reach >= w_reach - 0.005 and reach >= 0.97, (reach, w_reach)
    assert rec >= w_rec - 0.02, (rec, w_rec)
