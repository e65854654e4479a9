"""Port FlatIndex / flat_search vs the JAX reference on the same rows:
ids equal except at ties within tolerance, distances within rtol 1e-4,
for L2, COSINE and IP, with deletes and a valid_mask."""

import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_flat

from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch.convert import flat_from_numpy
from turdb_tpu_torch.models.flat import FlatIndex, flat_search
from turdb_tpu_torch.ops.distance import Metric, prep_norms

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _rows(seed, n=2500, b=32, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, 16, b)] + rng.standard_normal((b, d))).astype(np.float32)
    return x, q, rng


@pytest.mark.parametrize("name", ["L2", "COSINE", "IP"])
def test_flat_index_parity_with_delete_and_mask(name):
    x, q, rng = _rows(11)
    ref = JaxFlat(dim=16, metric=JaxMetric[name], capacity=1024)
    port = FlatIndex(dim=16, metric=Metric[name], capacity=1024, device="cpu")
    # two adds: the second grows the capacity past its first size
    for part in (x[:900], x[900:]):
        np.testing.assert_array_equal(port.add(part), ref.add(part))
    assert port.capacity == ref.capacity and len(port) == len(ref)
    dead = rng.choice(len(x), 300, replace=False)
    ref.delete(dead)
    port.delete(dead)
    assert_knn_match(*ref.search(q, k=10), *port.search(q, k=10))
    mask = rng.random(2000) < 0.6
    dm, im = port.search(q, k=10, valid_mask=mask)
    assert_knn_match(*ref.search(q, k=10, valid_mask=mask), dm, im)
    got = im[im >= 0]
    assert mask[got].all() and not np.isin(got, dead).any()
    np.testing.assert_allclose(port.get([3, 7]), ref.get([3, 7]), rtol=1e-6)


def test_flat_search_on_exported_reference_store():
    """The reference's store, exported to numpy and loaded with
    convert.flat_from_numpy, answers like the reference itself; a chunk
    smaller than the store exercises the running merge."""
    x, q, rng = _rows(12, n=3000)
    ref = JaxFlat(dim=16)
    ref.add(x)
    ref.delete(rng.choice(3000, 100, replace=False))
    vecs, valid, metric = export_flat(ref)
    port = flat_from_numpy(vecs, valid, metric, "cpu")
    assert_knn_match(*ref.search(q, k=50), *port.search(q, k=50))
    d, i = flat_search(torch.from_numpy(q), torch.from_numpy(vecs),
                       prep_norms(torch.from_numpy(vecs)), torch.from_numpy(valid),
                       k=10, chunk=700)
    assert_knn_match(*ref.search(q, k=10), d.numpy(), i.numpy())


def test_flat_search_empty_and_short_store():
    """Fewer valid rows than k: the tail is +inf with id -1, as in the
    reference."""
    x, q, _ = _rows(13, n=5)
    ref = JaxFlat(dim=16)
    port = FlatIndex(dim=16, device="cpu")
    ref.add(x)
    port.add(x)
    rd, ri = ref.search(q, k=8)
    pd, pi = port.search(q, k=8)
    assert_knn_match(rd, ri, pd, pi)
    assert (pi[:, 5:] == -1).all() and np.isinf(pd[:, 5:]).all()


@pytest.mark.parametrize("entry", ["flat_index", "topk_rows"])
def test_k_past_the_selection_width(entry):
    """k = 3000 over 5,000 rows (past K2's SEL_MAX = 2048, where the card
    takes K2's wide form): the shape [2, 3000] and the reference's
    `flat_search` ids and distances, from `FlatIndex.search` and from
    `topk_rows` with the L2 epilogue on the dot matrix."""
    from turdb_tpu_torch.kernels import EPI_L2, SEL_MAX, topk_rows

    x, q, _ = _rows(14, n=5000, b=2)
    k = 3000
    assert k > SEL_MAX
    ref = JaxFlat(dim=16)
    ref.add(x)
    want = ref.search(q, k=k)
    if entry == "flat_index":
        port = FlatIndex(dim=16, device="cpu")
        port.add(x)
        d, i = port.search(q, k=k)
    else:
        qt, xt = torch.from_numpy(q), torch.from_numpy(x)
        d, i = topk_rows(qt @ xt.T, k, rown=prep_norms(qt), coln=prep_norms(xt),
                         epilogue=EPI_L2, clamp=True)
        d, i = d.numpy(), i.numpy()
    assert d.shape == (2, k) and i.shape == (2, k)
    assert_knn_match(*want, d, i)
