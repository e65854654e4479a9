"""Dense block packing in the port (IvfIndex(dense_pack=True, nblocks=...)),
against the JAX reference: the cases of tests/test_ivf_dense.py on the
port's own builds, the search on the reference's exported dense state,
`dense_blocks_plain` against `_first_unique(cell_block[top])`, and the
block packing (`_dense_remap`) on the same cells."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_ivf

from turdb_tpu.models import ivf as jivf
from turdb_tpu_torch import kernels
from turdb_tpu_torch.convert import ivf_state_from_numpy
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.utils.datasets import make_pool

# the test workers share the machine's cores: one intra-op thread each
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
    truth = np.argsort(d, axis=1)[:, :10]
    return x, q, truth


def _recall(ids, truth):
    return np.mean([len(set(p[p >= 0]) & set(t)) / 10 for p, t in zip(ids, truth)])


def _built(x, **kw):
    idx = tivf.IvfIndex(dim=32, device="cpu", **kw)
    idx.add(x)
    if idx.state is None:
        idx.train()
    return idx


def test_dense_recall_parity_and_dedup(data):
    x, q, truth = data
    _, ib = _built(x).search(q, 10, nprobe=8)
    dn = _built(x, dense_pack=True, replicate=False)
    assert dn.cfg.dense and dn.state.cell_block is not None
    # without replicas pre-filling lanes, packing must compact the store
    assert dn.state.members.shape[0] < dn.cfg.n_clusters
    _, idn = dn.search(q, 10, nprobe=8)
    assert _recall(idn, truth) >= _recall(ib, truth) - 0.02
    for row in idn:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)


def test_dense_nblocks_compaction(data):
    x, q, truth = data
    dn = _built(x, dense_pack=True, replicate=False, nblocks=4)
    _, ids = dn.search(q, 10, nprobe=12)
    # 4 unique blocks out of 12 probed cells: locality packing keeps
    # most of the 12-cell recall
    assert _recall(ids, truth) >= 0.90


def test_dense_append_delete_allowed(data):
    x, q, truth = data
    rng = np.random.default_rng(1)
    dn = _built(x, dense_pack=True)
    extra = x[:500] + 0.01 * rng.standard_normal((500, 32)).astype(np.float32)
    slots = dn.add(extra)
    _, ie = dn.search(extra[:50], 1, nprobe=8)
    assert np.mean(ie[:, 0] == slots[:50]) >= 0.9
    dn.delete(slots[:100])
    allowed = np.ones(dn.size, bool)
    allowed[slots[100:200]] = False
    _, ia = dn.search(extra[100:150], 5, nprobe=8, allowed=allowed)
    assert not np.isin(ia, slots[:200]).any()


@pytest.fixture(scope="module")
def ref_dense():
    """A reference dense index with boundary replicas on the bench's
    make_pool (40k x 32, 128 blobs: ~1.9 cells a block), its queries, and
    its state in the port."""
    pool = make_pool(np.random.default_rng(0), 40_200, 32, n_clusters=128)
    ref = jivf.IvfIndex(dim=32, dense_pack=True)
    ref.add(pool[:40_000])
    if ref.state is None:
        ref.train()
    arrays, conf = export_ivf(ref.state, ref.cfg)
    return ref, pool[40_000:], ivf_state_from_numpy(arrays, conf, device="cpu")


@pytest.mark.parametrize("nprobe,nblocks,masked", [(8, None, False), (12, 4, False),
                                                   (12, 6, True), (5, 16, False),
                                                   (16, 8, False)])
def test_search_on_the_reference_state(ref_dense, nprobe, nblocks, masked):
    """Same state, same answers: ids equal except at ties, distances
    within 1e-4 relative / 1e-3 absolute (fp32 summation order), and the
    same short answers: where a query's top-nprobe cells hold fewer than
    nblocks distinct blocks, `_first_unique` repeats some, their rows fill
    the pre-dedup window (copies · k) twice over, and both packages return
    fewer than k rows (+inf, the port's id -1) for a few queries."""
    ref, q, (state, cfg) = ref_dense
    assert cfg.dense and state.cell_block.shape[0] == ref.state.centroids.shape[0]
    allowed = None
    if masked:
        allowed = np.random.default_rng(5).random(tuple(state.members.shape)) < 0.6
    d_ref, i_ref = jivf.ivf_search_impl(
        ref.state, jnp.asarray(q), None if allowed is None else jnp.asarray(allowed),
        cfg=ref.cfg, k=10, nprobe=nprobe, nblocks=nblocks)
    d, i = tivf.ivf_search_impl(
        state, torch.from_numpy(q), None if allowed is None else torch.from_numpy(allowed),
        cfg=cfg, k=10, nprobe=nprobe, nblocks=nblocks)
    assert_knn_match(d_ref, i_ref, d.numpy(), i.numpy())
    if (nprobe, nblocks) == (16, 8):
        assert torch.isinf(d).any()


def test_sq8_rerank_dense_on_the_reference_state(data):
    x, q, _ = data
    ref = jivf.IvfIndex(dim=32, dense_pack=True, sq8=True, rerank=32)
    ref.add(x[:6000])
    if ref.state is None:
        ref.train()
    state, cfg = ivf_state_from_numpy(*export_ivf(ref.state, ref.cfg), device="cpu")
    d_ref, i_ref = jivf.ivf_search_impl(ref.state, jnp.asarray(q), None, cfg=ref.cfg, k=10,
                                        nprobe=8, nblocks=4)
    d, i = tivf.ivf_search_impl(state, torch.from_numpy(q), None, cfg=cfg, k=10, nprobe=8,
                                nblocks=4)
    assert_knn_match(d_ref, i_ref, d.numpy(), i.numpy())


@pytest.mark.parametrize("p,u,nblk", [(12, 4, 3), (16, 8, 5), (32, 5, 40), (9, 9, 2),
                                      (7, 3, 1)])
def test_dense_blocks_plain_is_first_unique(p, u, nblk):
    """`dense_blocks_plain` equals the reference's `_first_unique` of
    `cell_block[top]` bit for bit, on rows with many repeated blocks (and
    rows with fewer than u distinct ones)."""
    rng = np.random.default_rng(p * 100 + u)
    cell_block = rng.integers(0, nblk, 50).astype(np.int32)
    top = np.stack([rng.choice(50, p, replace=False) for _ in range(64)]).astype(np.int32)
    blk = jnp.asarray(cell_block)[jnp.asarray(top)]
    want = np.asarray(jivf._first_unique(blk, u) if u < p else blk)
    got = kernels.dense_blocks_plain(torch.from_numpy(cell_block), torch.from_numpy(top), u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_remap_matches_the_reference():
    """The block packing on the same cells: block of every cell, remapped
    members, slot bookkeeping and block fill equal the reference's."""
    rng = np.random.default_rng(3)
    c, cap, dim = 200, 64, 16
    cents = rng.standard_normal((c, dim)).astype(np.float32) * 3
    occ = rng.integers(1, cap // 2, c).astype(np.int64)
    members = np.full((c, cap), -1, np.int64)
    slot_c, slot_l, s = [], [], 0
    for cell in range(c):
        members[cell, :occ[cell]] = np.arange(s, s + occ[cell])
        slot_c += [cell] * int(occ[cell])
        slot_l += list(range(int(occ[cell])))
        s += int(occ[cell])
    out = {}
    for name, idx in (("ref", jivf.IvfIndex(dim=dim, dense_pack=True)),
                      ("port", tivf.IvfIndex(dim=dim, dense_pack=True, device="cpu"))):
        idx._slot_cluster = np.asarray(slot_c, np.int32)
        idx._slot_lane = np.asarray(slot_l, np.int32)
        idx._slot_extras = [(np.full(s, -1, np.int32), np.full(s, -1, np.int32))]
        res = idx._dense_remap(cents, members.copy(), occ.copy(), cap)
        out[name] = (res[0], res[-1], idx._slot_cluster, idx._slot_lane, idx._occupancy)
    (bm_r, cb_r, sc_r, sl_r, fill_r), (bm_p, cb_p, sc_p, sl_p, fill_p) = out["ref"], out["port"]
    nb = bm_p.shape[0]
    assert nb < c and (bm_r[nb:] == -1).all()      # the reference pads blocks to a bucket
    np.testing.assert_array_equal(cb_p, cb_r)
    np.testing.assert_array_equal(bm_p, bm_r[:nb])
    np.testing.assert_array_equal(sc_p, sc_r)
    np.testing.assert_array_equal(sl_p, sl_r)
    np.testing.assert_array_equal(fill_p, fill_r[:nb])
