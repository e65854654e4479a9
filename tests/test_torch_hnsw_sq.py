"""The HNSW graph's SQ8 / SQ16 vector store of the port against the JAX
reference, on the reference's bulk-built 9000 x 32 graph (exact route).

- `quantize_sq8` / `quantize_sq16`: codes, mins and scales bit-equal;
  `dequantize` bit-equal to the reference's `dense()` (two roundings), and
  the gather `rows[ids]` bit-equal to the reference's compiled gather (one
  fused multiply-add);
- `hnsw_search_impl` over the SQ store (K8-SQ's and K9's plain versions),
  descent_ef 1 and 32, filtered or not, within `assert_knn_match` (fp32
  dots summed in another order);
- `add` after quantize: the store is f32 again, bit-equal to the
  reference's, and the wave's graph rows equal the reference's on >= 99 %;
- the parity harness carries a quantized state across, and
  `pack_serving` dequantizes first.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_hnsw

from turdb_tpu.models import hnsw as jh
from turdb_tpu_torch.convert import hnsw_index_from_numpy
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.ops.quantize import Sq8Rows

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, DIM, NQ = 9000, 32, 64
BITS = (8, 16)


def _clustered(rng, n, d=DIM, c=64):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4.0
    a = rng.integers(0, c, size=n)
    r = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    return (centers[a] + r * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)      # tests/test_torch_hnsw.py's data
    x = _clustered(rng, N + NQ + 100)
    return x[:N], x[N:N + NQ], x[N + NQ:]


@pytest.fixture(scope="module")
def ref(data):
    idx = jh.HnswIndex(dim=DIM, capacity=N, bulk_threshold=4096)
    idx.add(data[0])
    return idx


def _clone(idx):
    c = copy.copy(idx)
    c.state = jax.tree_util.tree_map(jnp.array, idx.state)
    c._alive = idx._alive.copy()
    return c


def _port_of(ref_idx):
    arrays, conf = export_hnsw(ref_idx.state, ref_idx.cfg, ref_idx.size)
    return hnsw_index_from_numpy(arrays, conf, ref_idx.size, alive=ref_idx._alive,
                                 descent_ef=ref_idx._descent_ef, device="cpu")


def _codes(rows):
    c = rows.codes.numpy() if isinstance(rows.codes, torch.Tensor) else np.asarray(rows.codes)
    return c.astype(np.int64) & 0xFFFF


@pytest.fixture(scope="module", params=BITS, ids=lambda b: f"sq{b}")
def quantized(ref, request):
    """(bits, the reference quantized, the port quantized from the same
    imported f32 state)."""
    r, port = _clone(ref), _port_of(ref)
    for idx in (r, port):
        idx.quantize_sq8() if request.param == 8 else idx.quantize_sq16()
    return request.param, r, port


def test_quantize_and_dequantize_bit_equal(quantized):
    bits, r, port = quantized
    rr, pr = r.state.vectors, port.state.vectors
    assert isinstance(pr, Sq8Rows) and pr.bits == bits
    assert pr.codes.dtype == (torch.uint8 if bits == 8 else torch.int16)
    np.testing.assert_array_equal(_codes(pr), _codes(rr))
    np.testing.assert_array_equal(pr.mins.numpy(), np.asarray(rr.mins))
    np.testing.assert_array_equal(pr.scales.numpy(), np.asarray(rr.scales))
    # the eager dequantize rounds the product and the sum apart ...
    np.testing.assert_array_equal(pr.dense().numpy(), np.asarray(rr.dense()))
    # ... the compiled gather (inside the search) fuses them
    ids = np.random.default_rng(60).integers(0, N, (NQ, 40))
    want = np.asarray(jax.jit(lambda rows, i: rows[i])(rr, jnp.asarray(ids)))
    np.testing.assert_array_equal(pr[torch.from_numpy(ids)].numpy(), want)
    # quantizing again is a no-op, dequantize gives back the f32 store
    again = _clone(r)
    again.dequantize()
    p2 = copy.copy(port)
    p2.quantize_sq8()
    assert p2.state.vectors is pr
    p2.dequantize()
    np.testing.assert_array_equal(p2.state.vectors.numpy(), np.asarray(again.state.vectors))


@pytest.mark.parametrize("descent_ef", (1, 32))
@pytest.mark.parametrize("filtered", (False, True))
def test_search_over_sq_store_matches_reference(quantized, data, descent_ef, filtered):
    _, r, port = quantized
    queries = data[1]
    allowed = None
    if filtered:
        allowed = np.zeros(port.capacity, bool)
        allowed[:N] = np.random.default_rng(61).random(N) < 0.6
    want = jh.hnsw_search_impl(r.state, jnp.asarray(queries),
                               None if allowed is None else jnp.asarray(allowed), cfg=r.cfg,
                               k=10, ef=64, iters=96, filtered=filtered, descent_ef=descent_ef)
    got = th.hnsw_search_impl(port.state, torch.from_numpy(queries),
                              None if allowed is None else torch.from_numpy(allowed),
                              cfg=port.cfg, k=10, ef=64, iters=96, filtered=filtered,
                              descent_ef=descent_ef)
    assert_knn_match(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy())
    if filtered:
        ids = got[1].numpy()
        assert allowed[ids[ids >= 0]].all()


def test_add_after_quantize(quantized, data):
    """A wave into the bulk graph's SQ store: both packages dequantize and
    insert; the store is f32 again and the rows are the reference's. With
    the reference's greedy descent (descent_ef 1, as a file that records
    no descent reads) the port builds the reference's graph; with the bulk
    graph's own beam descent, which its `add` takes, the new rows find
    themselves at least as often as in the reference."""
    _, r, port = quantized
    r = _clone(r)
    new = data[2]
    want = r.add(new)
    _, ids_r = r.search(new, k=1, ef=64)
    hit_r = (np.asarray(ids_r)[:, 0] == want).mean()
    for descent_ef in (1, port._descent_ef):
        p = copy.copy(port)
        p.state = p.state._replace(adj0=p.state.adj0.clone(),
                                   adj_hi=tuple(a.clone() for a in p.state.adj_hi),
                                   norms=p.state.norms.clone(), levels=p.state.levels.clone())
        p._alive = port._alive.copy()
        p._descent_ef = descent_ef
        got = p.add(new)
        p._descent_ef = port._descent_ef
        np.testing.assert_array_equal(got, want)
        assert isinstance(p.state.vectors, torch.Tensor)
        np.testing.assert_array_equal(p.state.vectors.numpy(), np.asarray(r.state.vectors))
        assert (p.state.entry, p.state.max_level) == (int(r.state.entry),
                                                      int(r.state.max_level))
        if descent_ef == 1:
            for a, b in zip((p.state.adj0, *p.state.adj_hi), (r.state.adj0, *r.state.adj_hi)):
                assert (a.numpy() == np.asarray(b)).all(1).mean() >= 0.99
        # found by their own rows as often as in the reference (on these
        # blobs the reference's re-selection leaves ~9 % of a wave into a
        # full bulk graph without an edge pointing at it)
        _, ids = p.search(new, k=1, ef=64)
        hit = (ids[:, 0] == got).mean()
        assert hit >= hit_r - 0.02 and hit >= 0.85, (descent_ef, hit, hit_r)


def test_parity_harness_carries_the_sq_store(quantized, data):
    bits, r, _ = quantized
    port = _port_of(r)
    rows = port.state.vectors
    assert isinstance(rows, Sq8Rows) and rows.bits == bits
    np.testing.assert_array_equal(_codes(rows), _codes(r.state.vectors))
    d, i = port.search(data[1], k=10, ef=64)
    dw, iw = r.search(data[1], k=10, ef=64)
    assert_knn_match(np.asarray(dw), np.asarray(iw), d, i)
    port.pack_serving()
    assert isinstance(port.state.vectors, torch.Tensor)
    np.testing.assert_array_equal(port.state.vectors.numpy(), np.asarray(r.state.vectors.dense()))
