"""The slice end to end: the port and the JAX reference each build an
IvfIndex on the same clustered pool (20k x 32, the bench's make_pool) and
must answer alike — recall@10 at nprobe 8 within 0.02, real cell counts
within 10%, and the same behaviour under append, delete and `allowed`."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turdb_tpu.models import ivf as jivf
from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.models.ivf import IvfIndex as JaxIvf
from turdb_tpu.ops.distance import prep_norms as jax_prep_norms
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.ops.distance import chain_norms
from turdb_tpu_torch.utils.datasets import make_pool, recall_of as recall

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, NQ, DIM, K = 20_000, 256, 32, 10


@pytest.fixture(scope="module")
def pair():
    pool = make_pool(np.random.default_rng(0), N + NQ + 500, DIM, n_clusters=64)
    x, q, extra = pool[:N], pool[N:N + NQ], pool[N + NQ:]
    flat = FlatIndex(dim=DIM, capacity=N, device="cpu")
    flat.add(x)
    _, truth = flat.search(q, k=K)
    ref = JaxIvf(dim=DIM)
    ref.add(x)
    port = IvfIndex(dim=DIM, device="cpu")
    port.add(x)
    return ref, port, x, q, extra, truth


def test_make_pool_matches_the_bench():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    a = make_pool(np.random.default_rng(0), 3000, 16)
    b = bench.make_pool(np.random.default_rng(0), 3000, 16)
    np.testing.assert_array_equal(a, b)


def test_oracle_matches_reference_oracle(pair):
    _, _, x, q, _, truth = pair
    ref = JaxFlat(dim=DIM, capacity=N)
    ref.add(x)
    _, want = ref.search(q, k=K)
    assert np.mean(want == truth) >= 0.999


def test_build_geometry_and_recall(pair):
    ref, port, _, q, _, truth = pair
    ref_cells = int(np.isfinite(np.asarray(ref.state.cnorms)).sum())
    port_cells = port.cfg.n_clusters
    assert abs(port_cells - ref_cells) <= 0.1 * ref_cells, (port_cells, ref_cells)
    assert port.cfg.cluster_cap == ref.cfg.cluster_cap
    assert port.cfg.replicated == ref.cfg.replicated
    # the first k-means seeds are the reference's: same numpy rng stream
    _, ri = ref.search(q, k=K, nprobe=8)
    _, pi = port.search(q, k=K, nprobe=8)
    r_ref, r_port = recall(ri, truth), recall(pi, truth)
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
    assert r_port >= 0.95


def test_maintenance_behaves_like_reference(pair):
    ref, port, x, q, extra, truth = pair
    rng = np.random.default_rng(26)
    for idx in (ref, port):
        slots = idx.add(extra)
        _, own = idx.search(extra, k=K, nprobe=8)
        assert np.mean((own == slots[:, None]).any(1)) >= 0.99
    np.testing.assert_array_equal(ref.size, port.size)
    dead = np.unique(np.concatenate([truth[:, 0], rng.choice(N, 300, replace=False)]))
    allowed = rng.random(port.size) < 0.5
    got = {}
    for name, idx in (("ref", ref), ("port", port)):
        idx.delete(dead)
        _, ids = idx.search(q, k=K, nprobe=8)
        assert not np.isin(ids, dead).any()
        _, ids_a = idx.search(q, k=K, nprobe=8, allowed=allowed)
        hits = ids_a[ids_a >= 0]
        assert allowed[hits].all() and not np.isin(hits, dead).any()
        got[name] = (ids, ids_a)
    # after deletes, both still find the surviving true neighbours alike
    live_truth = [t[~np.isin(t, dead)] for t in truth]
    def live_recall(ids):
        return np.mean([len(set(i) & set(t)) / max(len(t), 1)
                        for i, t in zip(ids, live_truth)])
    assert abs(live_recall(got["port"][0]) - live_recall(got["ref"][0])) <= 0.02
    assert abs((got["port"][1] >= 0).mean() - (got["ref"][1] >= 0).mean()) <= 0.02


def test_kmeans_norms_are_the_references(pair):
    """Where the two builds first parted: the k-means norms. The
    reference's jitted row norms (XLA:CPU) are a fused multiply-add chain
    over the columns in order; a vector-blocked sum (torch.sum) differs in
    the last bits on most rows, and `‖x‖² + ‖c‖² − 2·x·c` flips its argmin
    at near-ties (first in the fourth Lloyd round on this pool, then in every
    rebalance round, whose perturbed centroid copies are near-ties by
    construction). The port's k-means takes `chain_norms`: bit-equal on the
    pool's rows and on the centroids of a Lloyd round, and the assignment
    that follows agrees with the reference's on the same centroids."""
    ref, port, x, _, _, _ = pair
    np.testing.assert_array_equal(chain_norms(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_prep_norms(jnp.asarray(x))))
    seeds = np.random.default_rng(0).choice(N, 312, replace=False)
    xp = jnp.asarray(jivf._pad_rows(x, jivf._KM_CHUNK))
    cents = np.asarray(jivf._kmeans(xp, xp[jnp.asarray(seeds)], iters=2))
    np.testing.assert_array_equal(chain_norms(torch.from_numpy(cents)).numpy(),
                                  np.asarray(jax_prep_norms(jnp.asarray(cents))))
    want = np.asarray(jivf._assign_all(xp, jnp.asarray(cents)))[:N]
    got = tivf._assign_all(torch.from_numpy(x), torch.from_numpy(cents)).numpy()
    assert np.mean(got == want) >= 0.999
