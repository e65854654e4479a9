"""`sq8_search` in the port (ops/quantize.py; K11 `sq8_scan` on the card)
against the JAX reference's (turdb_tpu/ops/quantize.py): the cases of
tests/test_quantize.py:29-70, and the same answers on the same codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match

from turdb_tpu.ops import quantize as jq
from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)


def _store(x):
    codes, mins, scales = jq.sq8_encode(jnp.asarray(x))
    return np.array(codes), np.array(mins), np.array(scales)


def _port(q, codes, mins, scales, valid, k):
    d, i = tq.sq8_search(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(mins),
                         torch.from_numpy(scales), torch.from_numpy(valid), k)
    return d.numpy(), i.numpy()


def test_search_matches_exact():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    _, ids = _port(q, *_store(x), np.ones(400, bool), 5)
    exact_ids = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :5]
    assert (ids[:, 0] == exact_ids[:, 0]).mean() >= 0.9
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, exact_ids)]) >= 0.9


def test_search_respects_valid_mask():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((100, 16)).astype(np.float32)
    valid = np.zeros(100, bool)
    valid[40:60] = True
    _, ids = _port(x[:4], *_store(x), valid, 3)
    assert ((ids >= 40) & (ids < 60)).all()


@pytest.mark.parametrize("n,d,k,frac", [(400, 32, 5, 1.0), (3000, 64, 10, 0.7),
                                        (257, 16, 32, 0.05), (5000, 128, 1, 1.0)])
def test_same_codes_same_answers(n, d, k, frac):
    """On the reference's own codes: ids equal except at ties, distances
    within 1e-4 relative / 1e-3 absolute (the f32 product sums in another
    order). Rows past the valid ones are +inf in both (the port's id -1)."""
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32) * 2
    q = rng.standard_normal((24, d)).astype(np.float32) * 2
    codes, mins, scales = _store(x)
    valid = rng.random(n) < frac
    d_ref, i_ref = jq.sq8_search(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(mins),
                                 jnp.asarray(scales), jnp.asarray(valid), k=k)
    d, i = _port(q, codes, mins, scales, valid, k)
    assert_knn_match(d_ref, i_ref, d, i)
    assert (i[np.isinf(d)] == -1).all()


def test_plain_chunks_change_nothing(monkeypatch):
    """The plain version scans the store in row chunks (bounded memory at
    1M rows); any chunking gives the one global answer, ties to the lower
    row, even with many equal rows."""
    rng = np.random.default_rng(9)
    x = np.repeat(rng.standard_normal((50, 8)).astype(np.float32), 6, axis=0)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (*_store(x), np.ones(300, bool))]
    qt = torch.from_numpy(q)
    qn, qsum = torch.sum(qt * qt, -1), torch.sum(qt, -1)
    whole = kernels.sq8_scan_plain(qt, qn, qsum, *args, 12)
    monkeypatch.setattr(kernels, "_SQ8_PLAIN_ELEMS", 5 * 13)   # chunks of 13 rows
    parts = kernels.sq8_scan_plain(qt, qn, qsum, *args, 12)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    d, i = (t.numpy() for t in whole)
    tie = d[:, 1:] == d[:, :-1]
    assert tie.any() and (i[:, 1:][tie] > i[:, :-1][tie]).all()


def test_k_past_the_old_kernel_limit():
    """k = 100 (past the old K11 limit of 32; the card's list mode takes it,
    k past SQ8_LIST_MAX the distance mode) answers as the reference's."""
    rng = np.random.default_rng(100)
    x = rng.standard_normal((3000, 24)).astype(np.float32) * 2
    q = rng.standard_normal((8, 24)).astype(np.float32) * 2
    codes, mins, scales = _store(x)
    valid = rng.random(3000) < 0.9
    d_ref, i_ref = jq.sq8_search(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(mins),
                                 jnp.asarray(scales), jnp.asarray(valid), k=100)
    d, i = _port(q, codes, mins, scales, valid, 100)
    assert d.shape == (8, 100)
    assert_knn_match(d_ref, i_ref, d, i)
