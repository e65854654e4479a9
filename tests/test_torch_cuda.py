"""The port's CUDA kernels against their plain versions on the card, and
the slice on CUDA against the slice on the CPU. Marked `cuda`: these skip
where no GPU is present. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.utils.datasets import make_pool, recall_of

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_topk_rows_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 5000, device=cuda, generator=g)
    x[:, 100:200] = x[:, :100]            # exact ties
    rown = torch.rand(64, device=cuda, generator=g)
    coln = torch.rand(5000, device=cuda, generator=g)
    valid = torch.rand(5000, device=cuda, generator=g) < 0.7
    for epi in (kernels.EPI_NONE, kernels.EPI_L2, kernels.EPI_COS, kernels.EPI_IP):
        kw = dict(rown=rown, coln=coln, colvalid=valid, epilogue=epi, clamp=True)
        before = kernels.launches["topk_rows"]
        vk, pk = kernels.topk_rows(x, 37, **kw)
        assert kernels.launches["topk_rows"] == before + 1
        vp, pp = kernels.topk_rows_plain(x, 37, **kw)
        torch.testing.assert_close(vk, vp, rtol=0, atol=0)
        assert torch.equal(pk, pp)


def test_ivf_probe_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    c, lcap, d = 300, 64, 32
    pvecs = torch.randn(c, lcap, d, device=cuda, generator=g)
    members = torch.randint(-1, 2000, (c, lcap), device=cuda, generator=g, dtype=torch.int32)
    pnorms = (pvecs * pvecs).sum(-1)
    alive = torch.rand(c, lcap, device=cuda, generator=g) < 0.95
    allowed = torch.rand(c, lcap, device=cuda, generator=g) < 0.6
    q = torch.randn(50, d, device=cuda, generator=g)
    qn = (q * q).sum(1)
    cells = torch.rand(50, c, device=cuda, generator=g).topk(6).indices.to(torch.int32)
    for metric in (0, 1, 2):
        for replicated, allow in ((True, None), (False, None), (True, allowed)):
            m = 20 if replicated else 10
            args = (q, qn, cells, pvecs, pnorms, members, alive, allow)
            kw = dict(metric=metric, k=10, m=m, replicated=replicated)
            dk, ik = kernels.ivf_probe_f32(*args, **kw)
            dp, ip = kernels.ivf_probe_f32_plain(*args, **kw)
            torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)
            assert (ik == ip).float().mean() >= 0.99


def test_kmeans_assign_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3000, 48, device=cuda, generator=g) * 3
    cents = torch.randn(333, 48, device=cuda, generator=g) * 3
    cn = (cents * cents).sum(1)
    cn[::5] = float("inf")
    xn = (x * x).sum(1)
    for r in (1, 2, 3, 4):
        ik, dk = kernels.kmeans_assign(x, cents, xn, cn, r)
        ip, dp = kernels.kmeans_assign_plain(x, cents, xn, cn, r)
        assert (ik == ip).all(1).float().mean() >= 0.995
        assert not (ik % 5 == 0).any()
        torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-2)


def test_slice_on_cuda_matches_cpu(cuda):
    pool = make_pool(np.random.default_rng(0), 20_256, 32, n_clusters=64)
    x, q = pool[:20_000], pool[20_000:]
    flat = FlatIndex(dim=32, capacity=20_000, device=cuda)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    rec = {}
    for dev in ("cpu", cuda):
        idx = IvfIndex(dim=32, device=dev)
        idx.add(x)
        _, ids = idx.search(q, k=10, nprobe=8)
        rec[str(dev)] = recall_of(ids, truth)
    assert abs(rec["cpu"] - rec["cuda"]) <= 0.02 and rec["cuda"] >= 0.95, rec


def test_kernel_limits_raise_and_leave_no_error_behind(cuda):
    """A selection wider than SEL_MAX raises ValueError before any launch;
    a shape past the card's shared memory comes back from the C entry
    point as an error and raises; the next launch is not charged with it."""
    x = torch.randn(4, 5000, device=cuda)
    with pytest.raises(ValueError):
        kernels.topk_rows(x, kernels.SEL_MAX + 1)
    c, lcap, d = 4, 8, 60_000                        # a 240 KB query row in shared memory
    pvecs = torch.randn(c, lcap, d, device=cuda)
    members = torch.arange(c * lcap, device=cuda, dtype=torch.int32).reshape(c, lcap)
    cells = torch.arange(c, device=cuda, dtype=torch.int32)[None, :]
    q = torch.randn(1, d, device=cuda)
    with pytest.raises(RuntimeError):
        kernels.ivf_probe_f32(q, (q * q).sum(1), cells, pvecs, (pvecs * pvecs).sum(-1),
                              members, torch.ones(c, lcap, dtype=torch.bool, device=cuda),
                              metric=0, k=10, m=10, replicated=False)
    vk, _ = kernels.topk_rows(x, 5)
    vp, _ = kernels.topk_rows_plain(x, 5)
    assert torch.equal(vk, vp)


def _store(g, c, lcap, d, n_ids, cuda):
    """A packed store with repeated ids (replica-like copies carry the same
    row), empty lanes, tombstones and an allowed mask."""
    members = torch.randint(0, n_ids, (c, lcap), device=cuda, generator=g, dtype=torch.int32)
    occ = torch.randint(lcap // 3, lcap + 1, (c, 1), device=cuda, generator=g)
    members = torch.where(torch.arange(lcap, device=cuda)[None, :] < occ, members, -1)
    rows = torch.randn(n_ids, d, device=cuda, generator=g)
    pvecs = torch.where((members >= 0)[..., None], rows[members.clamp_min(0).long()], 0.0)
    pnorms = torch.where(members >= 0, (pvecs * pvecs).sum(-1), float("inf"))
    alive = torch.rand(c, lcap, device=cuda, generator=g) < 0.97
    allowed = torch.rand(c, lcap, device=cuda, generator=g) < 0.6
    return pvecs.contiguous(), pnorms, members.to(torch.int32), alive, allowed


def test_wide_selections_match_plain(cuda):
    """K2 at k = 300 and 2048; K1 at P*L = 32768 (chunked) and at m = 600
    with replicas, in both output modes."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(32, 20_000, device=cuda, generator=g)
    x[:, 5000:10_000] = x[:, :5000]                  # exact ties
    for k in (300, 2048):
        vk, pk = kernels.topk_rows(x, k)
        vp, pp = kernels.topk_rows_plain(x, k)
        assert torch.equal(vk, vp) and torch.equal(pk, pp)
    pvecs, pnorms, members, alive, allowed = _store(g, 600, 256, 32, 5000, cuda)
    q = torch.randn(40, 32, device=cuda, generator=g)
    qn = (q * q).sum(1)
    for p, k, m, mode in ((128, 10, 20, kernels.MODE_TOPK), (128, 40, 40, kernels.MODE_CAND),
                          (12, 300, 600, kernels.MODE_TOPK)):
        cells = torch.rand(40, 600, device=cuda, generator=g).topk(p).indices.to(torch.int32)
        for allow in (None, allowed):
            args = (q, qn, cells, pvecs, pnorms, members, alive, allow)
            kw = dict(metric=0, k=k, m=m, replicated=True, mode=mode)
            got, want = kernels.ivf_probe_f32(*args, **kw), kernels.ivf_probe_f32_plain(*args, **kw)
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
            assert (got[1] == want[1]).float().mean() >= 0.99


def _sq8_store(pvecs):
    from turdb_tpu_torch.ops.quantize import sq8_store, sq16_encode

    c, lcap, d = pvecs.shape
    c8, m_prime, s8, m8 = sq8_store(pvecs.reshape(-1, d))
    u16 = sq16_encode(pvecs.reshape(-1, d), m8, s8)
    return (c8.reshape(c, lcap, d), m_prime.reshape(c, lcap), s8.reshape(c, lcap),
            u16.reshape(c, lcap, d))


def test_ivf_probe_sq8_kernel_matches_plain(cuda):
    """K4's int32 dot is exact and its epilogue rounds as the plain
    expression does: distances and ids are equal, in one block and chunked."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(5)
    pvecs, pnorms, members, alive, allowed = _store(g, 400, 128, 64, 3000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(48, 64, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    for p in (8, 64):                                # 1024 lanes, then 8192: two chunks
        cells = torch.rand(48, 400, device=cuda, generator=g).topk(p).indices.to(torch.int32)
        for replicated, allow, mode, k, m in ((True, None, kernels.MODE_TOPK, 10, 20),
                                              (False, allowed, kernels.MODE_TOPK, 10, 10),
                                              (True, allowed, kernels.MODE_CAND, 40, 40)):
            args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allow)
            kw = dict(k=k, m=m, replicated=replicated, mode=mode)
            before = kernels.launches["ivf_probe_sq8"]
            got = kernels.ivf_probe_sq8(*args, **kw)
            assert kernels.launches["ivf_probe_sq8"] == before + 1
            want = kernels.ivf_probe_sq8_plain(*args, **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_ivf_rerank_kernel_matches_plain(cuda):
    """K5 over the f32 and the SQ16 store, r = 40 and 300, with copies of
    a row under one id among the candidates (ties the first copy wins)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    pvecs, pnorms, members, alive, _ = _store(g, 300, 64, 32, 800, cuda)
    _, mins, scales, u16 = _sq8_store(pvecs)
    q = torch.randn(30, 32, device=cuda, generator=g)
    qn = (q * q).sum(1)
    cells = torch.rand(30, 300, device=cuda, generator=g).topk(12).indices.to(torch.int32)
    for r in (40, 300):
        cd, ci, cpos = kernels.ivf_probe_f32(q, qn, cells, pvecs, pnorms, members, alive,
                                             metric=0, k=r, m=r, replicated=True,
                                             mode=kernels.MODE_CAND)
        assert bool(torch.isinf(cd).any() | (ci[:, 1:] == ci[:, :-1]).any())
        for store, meta in ((pvecs, ()), (u16, (mins, scales))):
            for replicated in (True, False):
                args = (q, qn, cd, ci, cpos, store, pnorms, *meta)
                dk, ik = kernels.ivf_rerank(*args, k=10, replicated=replicated)
                dp, ip = kernels.ivf_rerank_plain(*args, *(None, None)[len(meta):], k=10,
                                                  replicated=replicated)
                torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)
                assert (ik == ip).float().mean() >= 0.99


def test_sq8_slice_on_cuda_matches_cpu(cuda):
    pool = make_pool(np.random.default_rng(0), 20_256, 32, n_clusters=64)
    x, q = pool[:20_000], pool[20_000:]
    flat = FlatIndex(dim=32, capacity=20_000, device=cuda)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    for flags in (dict(rerank=40), dict(rerank=40, keep_f32=False)):
        rec = {}
        for dev in ("cpu", cuda):
            idx = IvfIndex(dim=32, sq8=True, device=dev, **flags)
            idx.add(x)
            _, ids = idx.search(q, k=10, nprobe=8)
            rec[str(dev)] = recall_of(ids, truth)
        assert abs(rec["cpu"] - rec["cuda"]) <= 0.02 and rec["cuda"] >= 0.95, (flags, rec)


def test_build_is_reproducible_on_cuda(cuda):
    """Two builds from the same rows and seeds give the same index, bit for
    bit: the k-means update sums in a fixed order."""
    pool = make_pool(np.random.default_rng(0), 20_000, 32, n_clusters=64)
    a, b = IvfIndex(dim=32, device=cuda), IvfIndex(dim=32, device=cuda)
    a.add(pool)
    b.add(pool)
    assert a.cfg == b.cfg
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
