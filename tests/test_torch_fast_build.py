"""`IvfIndex(fast_build=True)` on the CPU against the reference's: the
candidate-generator profile (4 Lloyd rounds on at most 262,144 sampled
rows, 2 rebalance rounds, no split cascade: overflow spills to the
runner-up cell). The reference's own test (tests/test_ivf_dense.py
test_fast_build_profile) holds recall@10 >= 0.90 at nprobe 8 on 20,000
rows of 60 blobs; the port is held to the same, and its cells to the
reference's: the same cells (no split changes their count), the same
primary cell for at least 98 % of the rows and per-cell row counts that
differ by those moves at most (k-means in another sum order moves a few
boundary rows: 0.48 % here)."""

import numpy as np
import pytest
import torch

from turdb_tpu.models.ivf import IvfIndex as JaxIvf
from turdb_tpu_torch.models.ivf import IvfIndex

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((60, 32)).astype(np.float32) * 5
    x = (cents[rng.integers(0, 60, 20000)]
         + rng.standard_normal((20000, 32))).astype(np.float32)
    q = (cents[rng.integers(0, 60, 200)]
         + rng.standard_normal((200, 32))).astype(np.float32)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return x, q, np.argsort(d, axis=1)[:, :10]


def _recall(ids, truth):
    return np.mean([len(set(p[p >= 0]) & set(t)) / 10 for p, t in zip(ids, truth)])


def _built(cls, x, **kw):
    idx = cls(dim=32, fast_build=True, **kw)
    idx.add(x)
    if idx.state is None:
        idx.train()
    return idx


def test_fast_build_against_the_reference(data):
    x, q, truth = data
    ref = _built(JaxIvf, x)
    port = _built(IvfIndex, x, device="cpu")
    _, ids = port.search(q, 10, nprobe=8)
    _, rids = ref.search(q, 10, nprobe=8)
    rec, ref_rec = _recall(ids, truth), _recall(np.asarray(rids), truth)
    assert rec >= 0.90 and ref_rec >= 0.90, (rec, ref_rec)
    # the cells' primary rows (the reference pads its cell count to a shape
    # bucket and lays replicas there too: compare the primaries)
    cells = port.cfg.n_clusters
    counts = np.bincount(port._slot_cluster, minlength=cells)
    ref_counts = np.bincount(ref._slot_cluster, minlength=cells)
    assert len(ref_counts) == cells and port.cfg.cluster_cap == ref.cfg.cluster_cap
    assert np.abs(counts - ref_counts).sum() <= 2 * 0.02 * len(x)
    assert np.mean(port._slot_cluster == ref._slot_cluster) >= 0.98
