"""The HNSW serving pack of the port against the JAX reference.

- `pack_serving` from the same graph gives the reference's `nbr_codes` and
  `nbr_meta` bit for bit (both are elementwise functions of the graph and
  the rows; `torch.round` and `jnp.round` both round half to even), with
  and without `pack_m`;
- `serve_search_impl` on a pack imported from the reference (with an
  `allowed` mask, `rerank < ef`, COSINE and IP, and their combinations,
  several (ef, iters))
  equals the reference's search within `assert_knn_match`: the seeding
  (K2 + K4's plain version with the metric's epilogue) and the int8 beam
  (K6's plain version) are exact integer dots under the same rounding, the
  rerank's fp32 dots are summed in another order;
- the port's own pack (its k-means differs from the reference's in low
  bits) serves at the reference's recall within 0.02;
- deletes, `allowed` and repacking.
The reference's graph and pack are built once per module at 9000 x 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_hnsw, export_hnsw_serve

from turdb_tpu.models import hnsw as jh
from turdb_tpu.models import hnsw_serve as jhs
from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch.convert import hnsw_index_from_numpy, hnsw_serve_state_from_numpy
from turdb_tpu_torch.models import hnsw_serve as ths
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.utils.datasets import recall_of

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, DIM, NQ = 9000, 32, 64


def _clustered(rng, n, d=DIM, c=64):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4.0
    a = rng.integers(0, c, size=n)
    r = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    return (centers[a] + r * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """The reference's bulk graph and serving pack, and the port's index
    holding the same graph."""
    rng = np.random.default_rng(6)
    x = _clustered(rng, N + NQ)
    base, queries = x[:N], x[N:]
    ref = jh.HnswIndex(dim=DIM, capacity=N, bulk_threshold=4096)
    ref.add(base)
    ref.pack_serving()
    flat = JaxFlat(dim=DIM, capacity=N)
    flat.add(base)
    _, truth = flat.search(queries, k=10)
    arrays, conf = export_hnsw(ref.state, ref.cfg, ref.size)
    port = hnsw_index_from_numpy(arrays, conf, ref.size, descent_ef=ref._descent_ef,
                                 device="cpu")
    return ref, port, base, queries, np.asarray(truth)


@pytest.mark.parametrize("pack_m", (None, 16))
def test_pack_blocks_bit_equal(built, pack_m):
    ref, port, *_ = built
    st = ref.state
    want = jhs.pack_serving(st.vectors, st.norms, st.adj0, ref.size, ref.cfg.metric,
                            pack_m=pack_m)
    got = ths.pack_serving(port.state.vectors, port.state.norms, port.state.adj0, port.size,
                           port.cfg.metric, pack_m=pack_m)
    # rows past the graph's size are never read (the reference's chunk
    # padding writes one of them)
    n = ref.size
    np.testing.assert_array_equal(got.nbr_codes.numpy()[:n], np.asarray(want.nbr_codes)[:n])
    np.testing.assert_array_equal(got.nbr_meta.numpy()[:n], np.asarray(want.nbr_meta)[:n])
    assert got.nbr_codes.shape == tuple(want.nbr_codes.shape)
    # the coarse quantizer: the same geometry, cells near the reference's
    assert got.centroids.shape == tuple(want.centroids.shape)
    assert got.cell_members.shape == tuple(want.cell_meta.shape[:2])
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=0.05)


def _imported(ref):
    return hnsw_serve_state_from_numpy(export_hnsw_serve(ref.serve), device="cpu")


CASES = {
    # name: (metric, serve_search_impl options)
    "l2": (Metric.L2, dict(ef=64, iters=96)),
    "l2_ef32_iters24": (Metric.L2, dict(ef=32, iters=24)),
    "l2_rerank_lt_ef": (Metric.L2, dict(ef=96, iters=96, rerank=40)),
    "l2_allowed": (Metric.L2, dict(ef=64, iters=96)),
    "cosine": (Metric.COSINE, dict(ef=48, iters=48, nprobe=3)),
    "ip": (Metric.IP, dict(ef=48, iters=48)),
    # the rerank's other paths together: a width below ef, `allowed`
    "l2_rerank_lt_ef_allowed": (Metric.L2, dict(ef=64, iters=64, rerank=24)),
    "cosine_rerank_lt_ef_allowed": (Metric.COSINE, dict(ef=64, iters=64, rerank=24)),
    "ip_allowed": (Metric.IP, dict(ef=48, iters=48)),
}


@pytest.mark.parametrize("case", CASES)
def test_serve_search_matches_reference(built, case):
    ref, _, _, queries, _ = built
    metric, kw = CASES[case]
    q = queries
    if metric is Metric.COSINE:
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    allowed = None
    if case.endswith("allowed"):
        allowed = np.zeros(ref.capacity, bool)
        allowed[:N] = np.random.default_rng(50).random(N) < 0.5
    want = jhs.serve_search_impl(ref.serve, jnp.asarray(q),
                                 None if allowed is None else jnp.asarray(allowed),
                                 metric=JaxMetric(metric.value), k=10, **kw)
    got = ths.serve_search_impl(_imported(ref), torch.from_numpy(q),
                                None if allowed is None else torch.from_numpy(allowed),
                                metric=metric, k=10, **kw)
    assert_knn_match(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy())
    if allowed is not None:
        ids = got[1].numpy()
        assert allowed[ids[ids >= 0]].all()


def test_port_pack_serves_at_reference_recall(built):
    """The port packs its graph itself (its own k-means) and serves at the
    reference's recall; pack_m=16 halves the blocks and keeps the gate."""
    ref, port, _, queries, truth = built
    port.pack_serving()
    for ef, iters in ((32, 24), (64, 48)):
        _, i_ref = ref.search_serve(queries, k=10, ef=ef, iters=iters)
        _, i_got = port.search_serve(queries, k=10, ef=ef, iters=iters)
        assert recall_of(i_got, truth) >= recall_of(i_ref, truth) - 0.02, ef
    full = port.serve.nbr_codes.shape[1]
    port.pack_serving(pack_m=full // 2)
    assert port.serve.nbr_codes.shape[1] == full // 2
    _, ids = port.search_serve(queries, k=10, ef=64)
    assert recall_of(ids, truth) >= 0.9
    port.serve = None


def test_serve_tombstones_and_allowed(built):
    ref, _, _, queries, truth = built
    arrays, conf = export_hnsw(ref.state, ref.cfg, ref.size)
    port = hnsw_index_from_numpy(arrays, conf, ref.size, descent_ef=32, device="cpu")
    port.serve = _imported(ref)
    victims = np.unique(truth[:, 0])
    port.delete(victims)
    _, ids = port.search_serve(queries, k=10, ef=64)
    assert not np.isin(ids, victims).any()
    allowed = np.zeros(N, bool)
    allowed[::2] = True
    _, ids = port.search_serve(queries, k=10, ef=96, allowed=allowed)
    got = ids[ids >= 0]
    assert len(got) and (got % 2 == 0).all() and not np.isin(got, victims).any()
    # exact distances: the first hit's distance is the true one
    d, ids = port.search_serve(queries[:8], k=1, ef=64)
    want = np.sum((queries[:8] - ref.state.vectors[ids[:, 0]]) ** 2, axis=1)
    np.testing.assert_allclose(d[:, 0], want, rtol=1e-4, atol=1e-3)
