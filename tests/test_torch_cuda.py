"""The port's CUDA kernels against their plain versions on the card, and
the slices (IVF, HNSW) on CUDA against the same slices on the CPU. Marked
`cuda`: these skip where no GPU is present. On a GPU machine:

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

# kernel against plain: distances within this share of their scale (fp32
# dots summed in another order), as chip_smoke.py's DOT_RTOL
DOT_RTOL = 1e-5


def _assert_near(dk, ik, dp, ip, atol, equal_ids):
    """Kernel against plain: the same +inf entries, distances within atol
    (and DOT_RTOL of their own size), ids apart only inside that band and
    equal on at least `equal_ids` of the entries."""
    assert torch.equal(torch.isinf(dk), torch.isinf(dp))
    torch.testing.assert_close(dk, dp, rtol=DOT_RTOL, atol=atol)
    close = (dk - dp).abs() <= atol + DOT_RTOL * dp.abs()
    assert bool(((ik == ip) | close | torch.isinf(dp)).all())
    share = float((ik == ip).float().mean())
    assert share >= equal_ids, share


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
    """A selection wider than SEL_MAX runs K2's wide form, one launch,
    bit-equal to the plain version; a shape past the card's shared memory
    comes back from the C entry point as an error and raises (nothing runs
    in its place); the next launch is not charged with it."""
    x = torch.randn(4, 5000, device=cuda)
    before = kernels.launches["topk_rows"]
    vw, pw = kernels.topk_rows(x, kernels.SEL_MAX + 1)
    assert kernels.launches["topk_rows"] == before + 1
    vpw, ppw = kernels.topk_rows_plain(x, kernels.SEL_MAX + 1)
    assert torch.equal(vw, vpw) and torch.equal(pw, ppw)
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
    # K5 stages its rows beside the query row: a row past shared memory
    # raises, and the next launch is not charged with it
    q = torch.randn(2, d, device=cuda)
    cand = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        kernels.ivf_rerank(q, (q * q).sum(1), torch.zeros(2, 4, device=cuda), cand, cand,
                           pvecs, (pvecs * pvecs).sum(-1), k=2, replicated=False)
    vk, _ = kernels.topk_rows(x, 5)
    assert torch.equal(vk, vp)
    # K6 at the widest rows the beams take (d 4096): its stages shrink to
    # fit (fewer code rows a warp, one rerank row a chunk)
    stage = kernels.serve_beam_stage(4, 1, 4096, 32, ef=64, iters=64, expand=4, rerank=64)
    assert stage[0] < 16 and stage[1] == 1 and stage[2] <= 232448, stage
    stage = kernels.serve_beam_stage(1024, 32, 128, 32, ef=32, iters=24, expand=4, rerank=32)
    assert stage[0] == 32 and stage[1] == 32 and stage[4] >= 8, stage


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


def _tie_row_matrix(g, b, n, cuda):
    """[b, n] with exact ties planted across K2's segment boundaries: each
    segment's first 64 columns copy the previous segment's last 64, and
    every 7th column of the first segment repeats in the last."""
    x = torch.randn(b, n, device=cuda, generator=g)
    w = -(-n // kernels.topk_segments(n))
    for s in range(w, n, w):
        x[:, s:s + 64] = x[:, s - 64:s]
    m = w // 7
    x[:, n - m:] = x[:, 0:7 * m:7]
    return x


@pytest.mark.parametrize("n", [8192, 24576, 31078, 131072])
def test_topk_rows_segments_match_plain_at_boundary_ties(cuda, n):
    """K2's long rows (segments + the last block's merge): bit-equal to
    the plain version with ties across segment boundaries, widths that are
    not a multiple of the segment, every epilogue, clamp and colvalid,
    one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = _tie_row_matrix(g, 48, n, cuda)
    rown = torch.rand(48, device=cuda, generator=g)
    coln = torch.rand(n, device=cuda, generator=g)
    valid = torch.rand(n, device=cuda, generator=g) < 0.8
    for epi in (kernels.EPI_NONE, kernels.EPI_L2, kernels.EPI_COS, kernels.EPI_IP):
        for k in (1, 5, 64, 300, 2048):
            for clamp, colvalid in ((False, None), (True, valid)):
                kw = dict(rown=rown, coln=coln, colvalid=colvalid, epilogue=epi, clamp=clamp)
                before = kernels.launches["topk_rows"]
                vk, pk = kernels.topk_rows(x, k, **kw)
                assert kernels.launches["topk_rows"] == before + 1
                vp, pp = kernels.topk_rows_plain(x, k, **kw)
                assert torch.equal(vk, vp) and torch.equal(pk, pp), (epi, k, clamp)
    # rows with fewer than k finite lanes, and rows of one value
    few = torch.zeros(n, dtype=torch.bool, device=cuda)
    few[::n // 5] = True
    flat = torch.full((4, n), 3.0, device=cuda)
    for xx, colvalid in ((x[:8].contiguous(), few), (flat, None), (flat, few)):
        vk, pk = kernels.topk_rows(xx, 64, colvalid=colvalid)
        vp, pp = kernels.topk_rows_plain(xx, 64, colvalid=colvalid)
        assert torch.equal(vk, vp) and torch.equal(pk, pp)


@pytest.mark.parametrize("n", [2, 20, 40, 33, 1230, 2048])
def test_topk_rows_short_path_matches_plain(cuda, n):
    """K2's warp path (n <= 2048): bit-equal at k = 1, a middle k and k = n,
    with exact ties (a row merged with itself), every epilogue."""
    g = torch.Generator(device=cuda).manual_seed(12)
    half = torch.randn(70, -(-n // 2), device=cuda, generator=g)
    x = torch.cat([half, half], 1)[:, :n].contiguous()
    rown = torch.rand(70, device=cuda, generator=g)
    coln = torch.rand(n, device=cuda, generator=g)
    valid = torch.rand(n, device=cuda, generator=g) < 0.7
    for epi in (kernels.EPI_NONE, kernels.EPI_L2, kernels.EPI_COS, kernels.EPI_IP):
        for k in sorted({1, max(1, n // 3), n}):
            kw = dict(rown=rown, coln=coln, colvalid=valid, epilogue=epi, clamp=True)
            vk, pk = kernels.topk_rows(x, k, **kw)
            vp, pp = kernels.topk_rows_plain(x, k, **kw)
            assert torch.equal(vk, vp) and torch.equal(pk, pp), (epi, k)


def _near_tie_agreement(x, cents, xn, cn, r, ik, dk, ip, dp, rtol=1e-5):
    """K3 against its plain version: the share of rows whose ids agree, and
    whether every disagreement is a near tie (the plain distance of the
    kernel's pick within rtol of the plain best) and every distance is
    within rtol of the distance scale."""
    fin = torch.isfinite(dp)
    assert torch.equal(fin, torch.isfinite(dk))
    xb, cb = x.bfloat16().float(), cents.bfloat16().float()
    at = (xn[:, None] + cn[ik.long()]) - 2.0 * torch.einsum("nd,nrd->nr", xb, cb[ik.long()])
    tol = rtol * (xn[:, None] + cn[ip.long()]).abs()
    near = ((at - dp).abs() <= tol) | ~fin
    close = ((dk - dp).abs() <= tol) | ~fin
    return float((ik == ip).all(1).float().mean()), bool(near.all() and close.all())


@pytest.mark.parametrize("d", [32, 40, 128, 384, 512])
def test_kmeans_assign_tensor_cores_agree_with_plain(cuda, d):
    """K3 on bf16 tensor cores at d = 32, 128, 384 (resident row tile), 40
    (zero-padded to 48) and 512 (streamed k-chunks), r = 1..4, pad
    centroids at +inf and a few rows whose every distance is +inf: ids
    agree on >= 99.5 % of rows, every disagreement is a near tie, and the
    all-+inf rows return ids 0..r-1. A bf16 x gives the same answer."""
    g = torch.Generator(device=cuda).manual_seed(13)
    centers = torch.randn(64, d, device=cuda, generator=g) * 4
    x = centers[torch.randint(0, 64, (5000,), device=cuda, generator=g)]
    x = x + torch.randn(5000, d, device=cuda, generator=g)
    cents = torch.randn(700, d, device=cuda, generator=g) * 4
    xn = (x * x).sum(1)
    xn[::997] = float("inf")
    cn = (cents * cents).sum(1)
    cn[650:] = float("inf")
    for r in (1, 2, 3, 4):
        ik, dk = kernels.kmeans_assign(x, cents, xn, cn, r)
        ip, dp = kernels.kmeans_assign_plain(x, cents, xn, cn, r)
        agree, near = _near_tie_agreement(x, cents, xn, cn, r, ik, dk, ip, dp)
        assert agree >= 0.995 and near, (d, r, agree)
        assert bool((ik[xn.isfinite()] < 650).all())
        assert torch.equal(ik[::997], torch.arange(r, device=cuda, dtype=torch.int32).expand(
            ik[::997].shape))
        ib, db = kernels.kmeans_assign(x.bfloat16(), cents, xn, cn, r)
        assert torch.equal(ib, ik) and torch.equal(db, dk)


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


@pytest.mark.parametrize("d", (32, 36, 128))
def test_ivf_rerank_kernel_matches_plain(cuda, d):
    """K5 over the f32 and the SQ16 store (16-byte staged words, and 8-byte
    ones for SQ16 rows at d = 36), r = 40 and 300 (several chunks), with
    copies of a row under one id among the candidates (ties the first copy
    wins): the distances within DOT_RTOL (and 1e-4), ids apart only inside
    that band and equal on 99 %."""
    g = torch.Generator(device=cuda).manual_seed(6)
    pvecs, pnorms, members, alive, _ = _store(g, 300, 64, d, 800, cuda)
    _, mins, scales, u16 = _sq8_store(pvecs)
    q = torch.randn(30, d, device=cuda, generator=g)
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
                before = kernels.launches["ivf_rerank"]
                dk, ik = kernels.ivf_rerank(*args, k=10, replicated=replicated)
                assert kernels.launches["ivf_rerank"] == before + 1
                dp, ip = kernels.ivf_rerank_plain(*args, *(None, None)[len(meta):], k=10,
                                                  replicated=replicated)
                _assert_near(dk, ik, dp, ip, 1e-4, 0.99)


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
        assert x is y is None or torch.equal(x, y)   # cell_block is None unless dense


def _graph(g, n, d, deg, cuda):
    """Clustered rows and a level-0 graph: each row's deg - 4 nearest plus
    4 random rows (-1 for a few), so that beams have far hops to take."""
    centers = torch.randn(32, d, device=cuda, generator=g) * 4
    x = centers[torch.randint(0, 32, (n,), device=cuda, generator=g)]
    x = (x + torch.randn(n, d, device=cuda, generator=g)).contiguous()
    norms = (x * x).sum(1)
    near = torch.topk(norms[:, None] + norms[None, :] - 2 * x @ x.T, deg - 3,
                      largest=False).indices[:, 1:]
    adj = torch.cat([near, torch.randint(0, n, (n, 4), device=cuda, generator=g)], 1)
    adj[torch.rand(n, deg, device=cuda, generator=g) < 0.02] = -1
    return x, norms, adj.to(torch.int32).contiguous()


def test_hnsw_graph_beam_kernel_matches_plain(cuda):
    """K8 in its modes (one seed, several with `active`, the filtered result
    buffer, the expanded ids) and metrics: the same buffers as the plain
    version but where fp32 dots summed in another order swap a near tie."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x, norms, adj = _graph(g, 6000, 64, 16, cuda)
    q = (x[torch.randint(0, 6000, (96,), device=cuda, generator=g)]
         + 0.5 * torch.randn(96, 64, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    allowed = torch.rand(6000, device=cuda, generator=g) < 0.5
    active = torch.arange(96, device=cuda) % 7 != 0
    # distinct seeds per query, as a beam's buffer holds them
    seeds = torch.rand(96, 6000, device=cuda, generator=g).topk(8).indices.to(torch.int32)
    # fp32 dots summed in another order: L2 distances err by ~1e-5 of the
    # norms they are taken from, whatever their own size
    atol = 1e-5 * float(qn.max() + norms.max())
    for metric in (0, 1, 2):
        sd = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, x[seeds.long()]),
                                        metric, qn[:, None], norms[seeds.long()]).contiguous()
        for kw in (dict(), dict(active=active), dict(allowed=allowed, k_res=16),
                   dict(return_expanded=True)):
            args = (adj, x, norms, q, qn, seeds[:, :1].contiguous(), sd[:, :1].contiguous())
            if "active" in kw:
                args = (*args[:5], seeds, sd)
            opts = dict(ef=48, iters=72, metric=metric, expand=4, **kw)
            before = kernels.launches["hnsw_graph_beam"]
            got = kernels.hnsw_graph_beam(*args, **opts)
            assert kernels.launches["hnsw_graph_beam"] == before + 1
            want = kernels.hnsw_graph_beam_plain(*args, **opts)
            torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
            assert (got.cand_i == want.cand_i).float().mean() >= 0.99, (metric, kw)
            if "k_res" in kw:
                torch.testing.assert_close(got.res_d, want.res_d, rtol=1e-5, atol=atol)
                assert bool(allowed[got.res_i[got.res_i >= 0].long()].all())
            if kw.get("return_expanded"):
                assert (got.exp_ids == want.exp_ids).all(1).float().mean() >= 0.95
            if "active" in kw:
                assert bool((got.cand_i[~active] == -1).all())
            assert (got.stats == want.stats).all(1).float().mean() >= 0.95


def test_hnsw_serve_beam_kernel_matches_plain(cuda):
    """K6 on a serving pack: its int8 dots are exact and its epilogue rounds
    as the plain expression, so the beams are the same; the rerank's fp32
    dots differ in the last bits."""
    from turdb_tpu_torch.models.hnsw_serve import pack_serving, serve_search_impl
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(8)
    x, norms, adj = _graph(g, 6000, 64, 32, cuda)
    pack = pack_serving(x, norms, adj, 6000, Metric.L2)
    q = (x[:128] + 0.5 * torch.randn(128, 64, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    seeds = torch.rand(128, 6000, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    allowed = torch.rand(6000, device=cuda, generator=g) < 0.6
    atol = 1e-5 * float(qn.max() + norms.max())   # as in the K8 test
    for metric in (0, 1, 2):
        seed_d = torch.arange(16, device=cuda, dtype=torch.float32).expand(128, 16).contiguous()
        for ef, iters, rerank, allow in ((32, 24, 0, None), (64, 48, 40, allowed),
                                         (96, 96, 0, None)):
            args = (pack.nbr_codes, pack.nbr_meta, x, norms, q, qn, qc, qs, qsum, seeds, seed_d,
                    allow)
            opts = dict(ef=ef, iters=iters, expand=4, rerank=rerank, k=10, metric=metric)
            dk, ik, sk = kernels.hnsw_serve_beam(*args, **opts)
            dp, ip, sp = kernels.hnsw_serve_beam_plain(*args, **opts)
            assert torch.equal(sk, sp)
            torch.testing.assert_close(dk, dp, rtol=1e-5, atol=atol)
            assert (ik == ip).float().mean() >= 0.999
    # the whole serving search on the card against the CPU
    d_c, i_c = serve_search_impl(pack, q, None, metric=Metric.L2, k=10, ef=64, iters=96)
    cpu = type(pack)(*(t.cpu() for t in pack))
    d_h, i_h = serve_search_impl(cpu, q.cpu(), None, metric=Metric.L2, k=10, ef=64, iters=96)
    torch.testing.assert_close(d_c.cpu(), d_h, rtol=1e-4, atol=1e-3)
    assert (i_c.cpu() == i_h).float().mean() >= 0.99


@pytest.mark.parametrize("d", (36, 128))
def test_hnsw_serve_beam_at_chip_smoke_widths(cuda, d):
    """K6 on a serving pack at chip_smoke's two widths (ef 32 / iters 24 and
    ef 192 / iters 160), with rerank < ef and `allowed`, every metric, at a
    row width staged by 16-byte words (128) and one by 4-byte words (36):
    its int8 dots are exact and its epilogue rounds as the plain expression,
    so expansions and scored counts are equal; the rerank's fp32 dots
    differ in the last bits (distances within DOT_RTOL of the norms'
    scale, ids apart only inside that band and equal on 99 %)."""
    from turdb_tpu_torch.models.hnsw_serve import pack_serving
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(8)
    x, norms, adj = _graph(g, 6000, d, 32, cuda)
    pack = pack_serving(x, norms, adj, 6000, Metric.L2)
    q = (x[:128] + 0.5 * torch.randn(128, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    seeds = torch.rand(128, 6000, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    allowed = torch.rand(6000, device=cuda, generator=g) < 0.6
    atol = DOT_RTOL * float(qn.max() + norms.max())   # as in the K8 test
    for metric in (0, 1, 2):
        seed_d = torch.arange(16, device=cuda, dtype=torch.float32).expand(128, 16).contiguous()
        for ef, iters, rerank, allow in ((32, 24, 0, None), (32, 24, 20, allowed),
                                         (192, 160, 0, None), (192, 160, 100, allowed)):
            args = (pack.nbr_codes, pack.nbr_meta, x, norms, q, qn, qc, qs, qsum, seeds, seed_d,
                    allow)
            opts = dict(ef=ef, iters=iters, expand=4, rerank=rerank, k=10, metric=metric)
            before = kernels.launches["hnsw_serve_beam"]
            dk, ik, sk = kernels.hnsw_serve_beam(*args, **opts)
            assert kernels.launches["hnsw_serve_beam"] == before + 1
            dp, ip, sp = kernels.hnsw_serve_beam_plain(*args, **opts)
            assert torch.equal(sk, sp), (metric, ef, rerank)
            _assert_near(dk, ik, dp, ip, atol, 0.99)
            if allow is not None:
                assert bool(allow[ik[ik >= 0].long()].all())


def test_hnsw_serve_beam_at_the_widest_rows(cuda):
    """K6 at d = 4096, the widest row the beams take: fewer staged code
    rows a warp and one rerank row a chunk, the same beams as the plain
    version (80 results: ids equal on 95 %, apart only at near ties)."""
    from turdb_tpu_torch.models.hnsw_serve import pack_serving
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(9)
    x, norms, adj = _graph(g, 1200, 4096, 32, cuda)
    pack = pack_serving(x, norms, adj, 1200, Metric.L2)
    q = (x[:8] + 0.5 * torch.randn(8, 4096, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    seeds = torch.rand(8, 1200, device=cuda, generator=g).topk(4).indices.to(torch.int32)
    seed_d = torch.zeros(8, 4, device=cuda)
    args = (pack.nbr_codes, pack.nbr_meta, x, norms, q, qn, qc, qs, qsum, seeds, seed_d, None)
    opts = dict(ef=64, iters=64, expand=4, rerank=0, k=10, metric=0)
    dk, ik, sk = kernels.hnsw_serve_beam(*args, **opts)
    dp, ip, sp = kernels.hnsw_serve_beam_plain(*args, **opts)
    assert torch.equal(sk, sp)
    _assert_near(dk, ik, dp, ip, DOT_RTOL * float(qn.max() + norms.max()), 0.95)


def test_hnsw_select_kernel_matches_plain(cuda):
    """K7 with duplicates, -1 and the target among W = 64 and 128
    candidates, every metric, alpha 1.0 and 1.2."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x, norms, adj = _graph(g, 5000, 64, 16, cuda)
    for w in (64, 128):
        targets = torch.randperm(5000, device=cuda, generator=g)[:700].to(torch.int32)
        cand = torch.randint(0, 5000, (700, w), device=cuda, generator=g, dtype=torch.int32)
        cand[:, : adj.shape[1]] = adj[targets.long()]
        cand[:, 20] = cand[:, 3]
        cand[:, 30] = -1
        cand[:, 40] = targets
        for metric in (0, 1, 2):
            xm = x / x.norm(dim=1, keepdim=True) if metric == 1 else x
            nm = (xm * xm).sum(1)
            for alpha in (1.0, 1.2):
                before = kernels.launches["hnsw_select"]
                ki, kd, kp = kernels.hnsw_select(xm, nm, targets, cand, deg=16, metric=metric,
                                                 alpha=alpha)
                assert kernels.launches["hnsw_select"] == before + 1
                pi, pd, pp = kernels.hnsw_select_plain(xm, nm, targets, cand, deg=16,
                                                       metric=metric, alpha=alpha)
                same = (ki == pi).all(1)
                assert same.float().mean() >= 0.99, (w, metric, alpha)
                torch.testing.assert_close(kd[same], pd[same], rtol=1e-5, atol=1e-4)
                assert (kp[same] == pp[same]).all()
                assert not bool((ki == targets[:, None]).any())


def test_hnsw_graph_beam_at_its_limits(cuda):
    """K8 where its hash table is largest: ef = EF_MAX, expand * deg =
    SLOTS_MAX and an expansion list of EXP_MAX ids, with and without the
    filtered result buffer, every metric; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x, norms, adj = _graph(g, 8000, 32, 32, cuda)
    q = (x[torch.randint(0, 8000, (24,), device=cuda, generator=g)]
         + 0.5 * torch.randn(24, 32, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    allowed = torch.rand(8000, device=cuda, generator=g) < 0.5
    seeds = torch.rand(24, 8000, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    atol = 1e-5 * float(qn.max() + norms.max())
    expand = kernels.SLOTS_MAX // 32
    for metric in (0, 1, 2):
        sd = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, x[seeds.long()]),
                                        metric, qn[:, None], norms[seeds.long()]).contiguous()
        for kw in (dict(return_expanded=True),
                   dict(allowed=allowed, k_res=kernels.EF_MAX)):
            opts = dict(ef=kernels.EF_MAX, iters=kernels.EXP_MAX, metric=metric, expand=expand,
                        **kw)
            before = kernels.launches["hnsw_graph_beam"]
            got = kernels.hnsw_graph_beam(adj, x, norms, q, qn, seeds, sd, **opts)
            assert kernels.launches["hnsw_graph_beam"] == before + 1
            want = kernels.hnsw_graph_beam_plain(adj, x, norms, q, qn, seeds, sd, **opts)
            torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
            assert (got.cand_i == want.cand_i).float().mean() >= 0.99, (metric, kw)
            assert (got.stats == want.stats).all(1).float().mean() >= 0.9
            if "k_res" in kw:
                torch.testing.assert_close(got.res_d, want.res_d, rtol=1e-5, atol=atol)
                assert bool(allowed[got.res_i[got.res_i >= 0].long()].all())
            else:
                assert (got.exp_ids == want.exp_ids).float().mean() >= 0.95
    with pytest.raises(ValueError):
        kernels.hnsw_graph_beam(adj, x, norms, q, qn, seeds, sd, ef=kernels.EF_MAX,
                                iters=kernels.EXP_MAX + expand, metric=0, expand=expand)


def test_hnsw_select_at_select_w_max(cuda):
    """K7 at W = SELECT_W_MAX, d = 128 (its largest shared memory), both
    modes, every metric, alpha 1.0 and 1.2: rows equal the plain version's
    on >= 99 %, and equal rows have equal n_pairs but on <= 1 % of them
    (an equal row can take another candidate at a tie and backfill it in
    the same place); one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(15)
    w = kernels.SELECT_W_MAX
    x, _, adj = _graph(g, 6000, 128, 32, cuda)
    targets = torch.randperm(6000, device=cuda, generator=g)[:500].to(torch.int32)
    cand = torch.randint(0, 6000, (500, w), device=cuda, generator=g, dtype=torch.int32)
    cand[:, :32] = adj[targets.long()]
    cand[:, 100] = cand[:, 7]
    cand[:, 200] = targets
    cand[::5, 150:] = -1
    for metric in (0, 1, 2):
        xm = (x / x.norm(dim=1, keepdim=True) if metric == 1 else x).contiguous()
        nm = (xm * xm).sum(1)
        sd = kernels._gathered_epilogue(torch.einsum("ud,uwd->uw", xm[targets.long()],
                                                     xm[cand.clamp_min(0).long()]),
                                        metric, nm[targets.long()][:, None],
                                        nm[cand.clamp_min(0).long()])
        # the presorted mode's input: the distinct candidates but the
        # target, ascending, -1 / +inf at the end (as a beam buffer holds them)
        earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=cuda), -1)
        drop = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, -1)
                | (cand == targets[:, None]) | (cand < 0))
        sd, order = torch.where(drop, float("inf"), sd).sort(dim=1, stable=True)
        cand_s = torch.where(drop, -1, cand)
        cs = torch.gather(cand_s, 1, order).contiguous()
        for alpha in (1.0, 1.2):
            for name, fn, plain, args in (
                    ("hnsw_select", kernels.hnsw_select, kernels.hnsw_select_plain,
                     (xm, nm, targets, cand)),
                    ("hnsw_select_sorted", kernels.hnsw_select_sorted,
                     kernels.hnsw_select_sorted_plain, (xm, cs, sd.contiguous()))):
                before = kernels.launches[name]
                ki, kd, kp = fn(*args, deg=32, metric=metric, alpha=alpha)
                assert kernels.launches[name] == before + 1
                pi, pd, pp = plain(*args, deg=32, metric=metric, alpha=alpha)
                same = (ki == pi).all(1)
                assert same.float().mean() >= 0.99, (name, metric, alpha)
                torch.testing.assert_close(kd[same], pd[same], rtol=1e-5, atol=1e-4)
                assert (kp[same] == pp[same]).float().mean() >= 0.99, (name, metric, alpha)


def test_ivf_probe_sq8_metric_epilogues_bit_equal(cuda):
    """K4's COSINE and IP epilogues (the serving pack's seeding) equal the
    plain version bit for bit."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(10)
    pvecs, pnorms, members, alive, allowed = _store(g, 300, 128, 64, 3000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(40, 64, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = torch.rand(40, 300, device=cuda, generator=g).topk(4).indices.to(torch.int32)
    for metric in (1, 2):
        for allow in (None, allowed):
            args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allow)
            kw = dict(k=32, m=32, replicated=False, metric=metric)
            got = kernels.ivf_probe_sq8(*args, **kw)
            want = kernels.ivf_probe_sq8_plain(*args, **kw, mode=kernels.MODE_TOPK)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("p", [256, 512])
def test_ivf_probe_sq8_cell_major_matches_plain(cuda, p):
    """K4's cell-major pass (probes wider than one chunk: the hard row's
    widths) in both modes, with and without replicas and `allowed`, a
    block listed twice in a query's row, a cell every query probes, the
    COSINE and IP epilogues and m = SEL_MAX: equal to the plain version,
    one K4 and one K2 launch a call."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(11)
    c, lcap, d, b = 1024, 128, 128, 64
    pvecs, pnorms, members, alive, allowed = _store(g, c, lcap, d, 20_000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(b, d, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = torch.rand(b, c, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    cells[::3, 1] = cells[::3, 0]                    # a block listed twice
    cells[:, -1] = 7                                 # a cell every query probes
    cells = cells.contiguous()
    assert kernels.probe_route(p, lcap, d) == "cell"
    top, cand, sel = kernels.MODE_TOPK, kernels.MODE_CAND, kernels.SEL_MAX
    for mode, k, m, replicated, allow, metric in (
            (top, 10, 20, True, None, 0), (top, 10, 10, False, allowed, 0),
            (cand, 40, 40, True, allowed, 0), (top, 32, 32, False, None, 1),
            (top, 32, 32, False, allowed, 2), (cand, sel, sel, True, None, 0),
            (top, 10, sel, True, allowed, 0)):
        args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allow)
        kw = dict(k=k, m=m, replicated=replicated, mode=mode, metric=metric)
        before = dict(kernels.launches)
        got = kernels.ivf_probe_sq8(*args, **kw)
        assert kernels.launches["ivf_probe_sq8"] == before["ivf_probe_sq8"] + 1
        assert kernels.launches["topk_rows"] == before["topk_rows"] + 1
        want = kernels.ivf_probe_sq8_plain(*args, **kw)
        for a, w in zip(got, want):
            assert torch.equal(a, w), (mode, k, m, replicated, allow is not None, metric)


def test_ivf_probe_sq8_cell_major_slices_of_queries(cuda, monkeypatch):
    """K4's cell-major pass runs the batch in slices of queries whose
    distances fit CELL_DIST_BYTES: three slices (24, 24, 16 queries) give
    the plain version's outputs, one K4 and one K2 launch a slice."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(14)
    c, lcap, d, b, p = 512, 128, 128, 64, 64
    pvecs, pnorms, members, alive, allowed = _store(g, c, lcap, d, 10_000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(b, d, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = torch.rand(b, c, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    assert kernels.probe_route(p, lcap, d) == "cell"
    monkeypatch.setattr(kernels, "CELL_DIST_BYTES", 24 * p * lcap * 4)
    for mode, k, m, replicated, allow in ((kernels.MODE_TOPK, 10, 20, True, allowed),
                                          (kernels.MODE_CAND, 40, 40, True, None)):
        args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allow)
        kw = dict(k=k, m=m, replicated=replicated, mode=mode)
        before = dict(kernels.launches)
        got = kernels.ivf_probe_sq8(*args, **kw)
        assert kernels.launches["ivf_probe_sq8"] == before["ivf_probe_sq8"] + 3
        assert kernels.launches["topk_rows"] == before["topk_rows"] + 3
        want = kernels.ivf_probe_sq8_plain(*args, **kw)
        for a, w in zip(got, want):
            assert torch.equal(a, w), mode


def test_ivf_probe_sq8_cell_fits_is_the_library_rule(cuda):
    """The kernel library owns the rule for one cell-major block (16-byte
    words, the block's shared memory on this card); a probe wider than one
    chunk whose cell does not fit runs query-major, equal to plain."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    assert kernels._cell_fits(128, 128, cuda) and kernels._cell_fits(2304, 16, cuda)
    assert not kernels._cell_fits(128, 100, cuda) and not kernels._cell_fits(4096, 128, cuda)
    g = torch.Generator(device=cuda).manual_seed(15)
    c, lcap, d, b, p = 12, 2048, 128, 16, 4
    assert not kernels._cell_fits(lcap, d, cuda)
    assert kernels.probe_route(p, lcap, d, cuda) == "query"
    pvecs, pnorms, members, alive, allowed = _store(g, c, lcap, d, 20_000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(b, d, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = torch.rand(b, c, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allowed)
    before = dict(kernels.launches)
    got = kernels.ivf_probe_sq8(*args, k=10, m=20, replicated=True)
    assert kernels.launches["ivf_probe_sq8"] == before["ivf_probe_sq8"] + 1
    assert kernels.launches["topk_rows"] == before["topk_rows"]
    want = kernels.ivf_probe_sq8_plain(*args, k=10, m=20, replicated=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("d, p, route", [(100, 8, "query"), (100, 64, "query"),
                                          (48, 96, "cell")])
def test_ivf_probe_sq8_row_layouts_match_plain(cuda, d, p, route):
    """K4 on rows that are not 16-byte words (d = 100: a warp a row, one
    block or chunked with the merge) and on rows of 16-byte words padded to
    the mma's k (d = 48, cell-major): equal to the plain version."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(13)
    pvecs, pnorms, members, alive, allowed = _store(g, 300, 128, d, 3000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    q = torch.randn(40, d, device=cuda, generator=g)
    qc, qs, qsum = quantize_queries(q)
    qn = (q * q).sum(1)
    cells = torch.rand(40, 300, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    assert kernels.probe_route(p, 128, d) == route
    for mode, k, m, replicated, allow in ((kernels.MODE_TOPK, 10, 20, True, None),
                                          (kernels.MODE_TOPK, 10, 10, False, allowed),
                                          (kernels.MODE_CAND, 40, 40, True, allowed)):
        args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allow)
        kw = dict(k=k, m=m, replicated=replicated, mode=mode)
        got = kernels.ivf_probe_sq8(*args, **kw)
        want = kernels.ivf_probe_sq8_plain(*args, **kw)
        for a, w in zip(got, want):
            assert torch.equal(a, w), (d, p, mode)


@pytest.mark.parametrize("d", [128, 384])
def test_ivf_probe_f32_rows_in_flight_match_plain(cuda, d):
    """K1 with several rows in flight a warp at d = 128 and 384 (one and
    three float4 a lane a row), in one block and chunked, both modes,
    within the probe's tolerance of the plain version; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(12)
    c, lcap, b = 400, 256, 48
    pvecs, pnorms, members, alive, allowed = _store(g, c, lcap, d, 6000, cuda)
    q = torch.randn(b, d, device=cuda, generator=g)
    qn = (q * q).sum(1)
    for p in (5, 32):                                # 1280 lanes; 8192: two chunks
        cells = torch.rand(b, c, device=cuda, generator=g).topk(p).indices.to(torch.int32)
        for metric, mode, k, m, allow in ((0, kernels.MODE_TOPK, 10, 20, None),
                                          (1, kernels.MODE_TOPK, 10, 20, allowed),
                                          (2, kernels.MODE_TOPK, 10, 20, None),
                                          (0, kernels.MODE_CAND, 40, 40, allowed)):
            args = (q, qn, cells, pvecs, pnorms, members, alive, allow)
            kw = dict(metric=metric, k=k, m=m, replicated=True, mode=mode)
            before = kernels.launches["ivf_probe_f32"]
            got = kernels.ivf_probe_f32(*args, **kw)
            assert kernels.launches["ivf_probe_f32"] == before + 1
            want = kernels.ivf_probe_f32_plain(*args, **kw)
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
            assert (got[1] == want[1]).float().mean() >= 0.99


def test_hnsw_limits_raise(cuda):
    x = torch.randn(2048, 32, device=cuda)
    n = (x * x).sum(1)
    adj = torch.zeros(2048, 16, dtype=torch.int32, device=cuda)
    seed = torch.zeros(4, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.hnsw_graph_beam(adj, x, n, x[:4], n[:4], seed, n[:4, None], ef=kernels.EF_MAX + 1,
                                iters=8, metric=0)
    with pytest.raises(ValueError):
        kernels.hnsw_select(x, n, seed[:, 0], torch.zeros(4, kernels.SELECT_W_MAX + 1,
                                                          dtype=torch.int32, device=cuda),
                            deg=16, metric=0, alpha=1.0)


def test_hnsw_slice_on_cuda_matches_cpu(cuda):
    """The bulk build, the graph search and the serving search on the card
    reach the CPU run's recall (the exact route, and the self-probe route
    with _BULK_EXACT lowered)."""
    from turdb_tpu_torch.models import hnsw as th

    pool = make_pool(np.random.default_rng(0), 20_256, 32, n_clusters=64)
    x, q = pool[:20_000], pool[20_000:]
    flat = FlatIndex(dim=32, capacity=20_000, device=cuda)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    saved = th._BULK_EXACT
    try:
        for exact in (saved, 8192):
            th._BULK_EXACT = exact
            rec = {}
            for dev in ("cpu", cuda):
                idx = th.HnswIndex(dim=32, capacity=20_000, device=dev)
                idx.add(x)
                _, ids = idx.search(q, k=10, ef=64)
                _, ids_s = idx.search_serve(q, k=10, ef=64)
                rec[str(dev)] = (recall_of(ids, truth), recall_of(ids_s, truth))
            for a, b in zip(rec["cpu"], rec["cuda"]):
                assert abs(a - b) <= 0.02 and b >= 0.95, (exact, rec)
    finally:
        th._BULK_EXACT = saved


def _sq_stores(x):
    from turdb_tpu_torch.ops.quantize import sq_rows_encode

    return (("f32", x), ("sq8", sq_rows_encode(x, 8)), ("sq16", sq_rows_encode(x, 16)))


def test_hnsw_greedy_kernel_matches_plain(cuda):
    """K9 over the f32 rows and the SQ8 / SQ16 store, every metric, from
    random nodes and from -1 (row 0's list against +inf), one level a
    launch and three levels in one launch: the same ends as the plain
    version (chain) but where fp32 dots summed in another order swap a near
    tie."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x, norms, adj = _graph(g, 6000, 64, 16, cuda)
    q = (x[torch.randint(0, 6000, (512,), device=cuda, generator=g)]
         + 0.5 * torch.randn(512, 64, device=cuda, generator=g)).contiguous()
    cur = torch.randint(-1, 6000, (512,), device=cuda, generator=g, dtype=torch.int32)
    for metric in (0, 1, 2):
        xm = x / x.norm(dim=1, keepdim=True) if metric == 1 else x
        qm = q / q.norm(dim=1, keepdim=True) if metric == 1 else q
        nm, qn = (xm * xm).sum(1), (qm * qm).sum(1)
        atol = 1e-5 * float(qn.max() + nm.max())   # as in the K8 test
        for name, store in _sq_stores(xm.contiguous()):
            rows = store[cur.clamp_min(0).long()]
            cur_d = kernels._gathered_epilogue(torch.einsum("bd,bd->b", qm, rows), metric, qn,
                                               nm[cur.clamp_min(0).long()])
            cur_d = torch.where(cur >= 0, cur_d, float("inf")).contiguous()
            args = (adj, store, nm, qm.contiguous(), qn, cur, cur_d)
            before = kernels.launches["hnsw_greedy"]
            ki, kd, ks = kernels.hnsw_greedy(*args, metric=metric)
            assert kernels.launches["hnsw_greedy"] == before + 1
            pi, pd, ps = kernels.hnsw_greedy_plain(*args, metric=metric)
            torch.testing.assert_close(kd, pd, rtol=1e-5, atol=atol)
            assert (ki == pi).float().mean() >= 0.99, (metric, name)
            assert (ks == ps).all(1).float().mean() >= 0.95, (metric, name)
    # three levels in one launch, each query down to its own lowest level
    # (some walk none), at d = 64 and 128 and at d = 36, whose SQ rows are
    # no whole 16-byte words (staged by 4-byte copies)
    for d in (64, 128, 36):
        x, norms, adj0 = _graph(g, 6000, d, 16, cuda)
        adjs = [adj0[torch.randperm(6000, device=cuda, generator=g)].contiguous()
                for _ in range(2)] + [adj0]
        q = (x[torch.randint(0, 6000, (700,), device=cuda, generator=g)]
             + 0.5 * torch.randn(700, d, device=cuda, generator=g)).contiguous()
        qn = (q * q).sum(1)
        cur = torch.randint(-1, 6000, (700,), device=cuda, generator=g, dtype=torch.int32)
        lowest = torch.randint(0, 5, (700,), device=cuda, generator=g, dtype=torch.int32)
        atol = 1e-5 * float(qn.max() + norms.max())
        for name, store in _sq_stores(x):
            cur_d = kernels._gathered_epilogue(
                torch.einsum("bd,bd->b", q, store[cur.clamp_min(0).long()]), 0, qn,
                norms[cur.clamp_min(0).long()])
            cur_d = torch.where(cur >= 0, cur_d, float("inf")).contiguous()
            args = (adjs, store, norms, q, qn, cur, cur_d)
            before = kernels.launches["hnsw_greedy"]
            ki, kd, ks = kernels.hnsw_greedy(*args, metric=0, lowest=lowest)
            assert kernels.launches["hnsw_greedy"] == before + 1
            pi, pd, ps = kernels.hnsw_greedy_plain(*args, metric=0, lowest=lowest)
            torch.testing.assert_close(kd, pd, rtol=1e-5, atol=atol)
            assert (ki == pi).float().mean() >= 0.99, (d, name)
            assert (ks == ps).all(1).float().mean() >= 0.95, (d, name)
            none = lowest >= 3
            assert torch.equal(ki[none], cur[none]) and bool((ks[none] == 0).all())


@pytest.mark.parametrize("d", (64, 128))
def test_hnsw_graph_beam_sq_kernel_matches_plain(cuda, d):
    """K8 over u8 and u16 codes in its modes, at two row widths of the
    staged scorer: the buffers of the plain version (the same gather) but
    at near ties of the fp32 dots."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x, norms, adj = _graph(g, 6000, d, 16, cuda)
    q = (x[torch.randint(0, 6000, (96,), device=cuda, generator=g)]
         + 0.5 * torch.randn(96, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    allowed = torch.rand(6000, device=cuda, generator=g) < 0.5
    active = torch.arange(96, device=cuda) % 7 != 0
    seeds = torch.rand(96, 6000, device=cuda, generator=g).topk(8).indices.to(torch.int32)
    atol = 1e-5 * float(qn.max() + norms.max())
    for name, rows in _sq_stores(x)[1:]:
        sd = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, rows[seeds.long()]), 0,
                                        qn[:, None], norms[seeds.long()]).contiguous()
        for kw in (dict(), dict(active=active), dict(allowed=allowed, k_res=16),
                   dict(return_expanded=True)):
            args = (adj, rows, norms, q, qn, seeds[:, :1].contiguous(), sd[:, :1].contiguous())
            if "active" in kw:
                args = (*args[:5], seeds, sd)
            opts = dict(ef=64, iters=96, metric=0, expand=4, **kw)
            before = kernels.launches["hnsw_graph_beam_sq"]
            got = kernels.hnsw_graph_beam(*args, **opts)
            assert kernels.launches["hnsw_graph_beam_sq"] == before + 1
            want = kernels.hnsw_graph_beam_plain(*args, **opts)
            torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
            assert (got.cand_i == want.cand_i).float().mean() >= 0.99, (name, kw)
            if "k_res" in kw:
                assert bool(allowed[got.res_i[got.res_i >= 0].long()].all())
            assert (got.stats == want.stats).all(1).float().mean() >= 0.95


def test_hnsw_select_sorted_kernel_matches_plain(cuda):
    """K7's presorted mode over K8's ef 100 buffers (-1 / +inf tails
    included), every metric, alpha 1.0 and 1.2. The queries are not rows
    of the graph, as a wave's are not: a row's own node at distance 0
    would tie every later candidate's distance with its pair distance."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x, _, adj = _graph(g, 6000, 64, 32, cuda)
    q0 = (x[torch.randint(0, 6000, (400,), device=cuda, generator=g)]
          + 0.5 * torch.randn(400, 64, device=cuda, generator=g))
    for metric in (0, 1, 2):
        xm = (x / x.norm(dim=1, keepdim=True) if metric == 1 else x).contiguous()
        nm = (xm * xm).sum(1)
        q = (q0 / q0.norm(dim=1, keepdim=True) if metric == 1 else q0).contiguous()
        qn = (q * q).sum(1)
        seed = torch.zeros((400, 1), dtype=torch.int32, device=cuda)
        sd = kernels._gathered_epilogue(q @ xm[0], metric, qn, nm[0])[:, None].contiguous()
        beam = kernels.hnsw_graph_beam(adj, xm, nm, q, qn, seed, sd, ef=100, iters=150,
                                       metric=metric)
        cand_i, cand_d = beam.cand_i.clone(), beam.cand_d.clone()
        cand_i[::9, 60:], cand_d[::9, 60:] = -1, float("inf")
        for alpha in (1.0, 1.2):
            before = kernels.launches["hnsw_select_sorted"]
            ki, kd, kp = kernels.hnsw_select_sorted(xm, cand_i, cand_d, deg=32, metric=metric,
                                                    alpha=alpha)
            assert kernels.launches["hnsw_select_sorted"] == before + 1
            pi, pd, pp = kernels.hnsw_select_sorted_plain(xm, cand_i, cand_d, deg=32,
                                                          metric=metric, alpha=alpha)
            same = (ki == pi).all(1)
            assert same.float().mean() >= 0.99, (metric, alpha)
            assert torch.equal(kd[same], pd[same]) and torch.equal(kp[same], pp[same])


def test_hnsw_wave_build_and_vacuum_on_cuda_match_cpu(cuda):
    """The wave build (K9, K8, K7 in both modes) and a vacuum through the
    waves on the card give the CPU run's graph: rows equal on >= 99 %,
    recall within 0.02."""
    from turdb_tpu_torch.models import hnsw as th

    pool = make_pool(np.random.default_rng(0), 6_256, 32, n_clusters=64)
    x, q = pool[:6000], pool[6000:]
    flat = FlatIndex(dim=32, capacity=6000, device=cuda)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    dead = np.random.default_rng(1).choice(6000, 1500, replace=False)
    out = {}
    for dev in ("cpu", cuda):
        idx = th.HnswIndex(dim=32, ef_construction=64, build_batch=256, bulk_threshold=10**9,
                           device=dev)
        before = dict(kernels.launches)
        idx.add(x)
        if dev != "cpu":
            for k in ("hnsw_greedy", "hnsw_graph_beam", "hnsw_select_sorted", "hnsw_select"):
                assert kernels.launches[k] > before[k], k
        _, ids = idx.search(q, k=10, ef=64)
        rows = [a[:6000].cpu().numpy() for a in (idx.state.adj0, *idx.state.adj_hi)]
        idx.delete(dead)
        mapping = idx.vacuum()
        out[str(dev)] = (recall_of(ids, truth), rows, mapping,
                         [a[:4500].cpu().numpy() for a in (idx.state.adj0, *idx.state.adj_hi)])
    (rc, rows_c, map_c, vac_c), (rg, rows_g, map_g, vac_g) = out["cpu"], out["cuda"]
    assert abs(rc - rg) <= 0.02 and rg >= 0.95, (rc, rg)
    np.testing.assert_array_equal(map_g, map_c)
    for a, b in (*zip(rows_g, rows_c), *zip(vac_g, vac_c)):
        assert (a == b).all(1).mean() >= 0.99


def test_hnsw_greedy_launches_once_a_wave_and_once_a_search(cuda):
    """K9 walks every upper level in one launch: one for each wave that
    has a graph to descend and a row below the top level, and one for a
    search at descent_ef 1."""
    from turdb_tpu_torch.models import hnsw as th

    x = make_pool(np.random.default_rng(2), 3_000, 32, n_clusters=32)
    idx = th.HnswIndex(dim=32, ef_construction=64, build_batch=256, bulk_threshold=10**9,
                       device=cuda)
    levels = th.select_levels(np.arange(len(x), dtype=np.uint64), idx.cfg)
    want, off = 0, 0
    while off < len(x):
        w = min(idx.build_batch, len(x) - off, max(1, off))
        want += off > 0 and bool((levels[off:off + w] < idx.cfg.max_levels - 1).any())
        off += w
    kernels.reset_launches()
    idx.add(x)
    assert kernels.launches["hnsw_greedy"] == want > 0
    kernels.reset_launches()
    idx.search(x[:100], k=10, ef=64)
    assert idx._descent_ef == 1 and kernels.launches["hnsw_greedy"] == 1


def test_hnsw_wave_limits_raise_and_leave_no_error_behind(cuda):
    """K7's presorted mode past SELECT_W_MAX and K8-SQ past EF_MAX:
    ValueError before a launch; K9 on rows of 30 (not a multiple of 4)
    reads a zero-padded copy; the next launches run and agree with their
    plain versions."""
    from turdb_tpu_torch.ops.quantize import sq_rows_encode

    x = torch.randn(2048, 32, device=cuda)
    n = (x * x).sum(1)
    adj = torch.randint(0, 2048, (2048, 16), dtype=torch.int32, device=cuda)
    w = kernels.SELECT_W_MAX + 1
    with pytest.raises(ValueError):
        kernels.hnsw_select_sorted(x, torch.zeros(4, w, dtype=torch.int32, device=cuda),
                                   torch.zeros(4, w, device=cuda), deg=16, metric=0, alpha=1.0)
    cur = torch.zeros(4, dtype=torch.int32, device=cuda)
    x30 = torch.randn(2048, 30, device=cuda)      # rows read from a zero-padded copy
    n30 = (x30 * x30).sum(1)
    ki, kd, _ = kernels.hnsw_greedy(adj, x30, n30, x30[:4], n30[:4], cur, n30[:4], metric=0)
    pi, pd, _ = kernels.hnsw_greedy_plain(adj, x30, n30, x30[:4], n30[:4], cur, n30[:4], metric=0)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-3)
    rows = sq_rows_encode(x, 8)
    with pytest.raises(ValueError):
        kernels.hnsw_graph_beam(adj, rows, n, x[:4], n[:4], cur[:, None], n[:4, None],
                                   ef=kernels.EF_MAX + 1, iters=8, metric=0)
    ki, kd, _ = kernels.hnsw_greedy(adj, rows, n, x[:4], n[:4], cur, n[:4], metric=0)
    pi, pd, _ = kernels.hnsw_greedy_plain(adj, rows, n, x[:4], n[:4], cur, n[:4], metric=0)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-3)
    torch.cuda.synchronize()


def test_dense_blocks_kernel_matches_plain(cuda):
    """K10, fused into K2 (`topk_rows(..., cell_block=, u=)`), bit-equal to
    `dense_blocks_plain` of K2's own selection: rows with many repeated
    blocks, rows with fewer than u distinct blocks, u >= P (the gather), a
    probe list past one warp's width, and a row of K2's segmented path
    (N > 2048); one launch a call, counted as K2's and K10's."""
    g = torch.Generator(device=cuda).manual_seed(10)
    for nblk, p, u, c in ((6, 12, 4, 600), (40, 16, 8, 600), (3, 9, 6, 600),
                          (500, 256, 100, 600), (50, 8, 8, 600), (900, 16, 8, 7936)):
        cell_block = torch.randint(0, nblk, (c,), device=cuda, generator=g, dtype=torch.int32)
        x = torch.rand(257, c, device=cuda, generator=g)
        before = (kernels.launches["topk_rows"], kernels.launches["dense_blocks"])
        _, top, got = kernels.topk_rows(x, p, cell_block=cell_block, u=u)
        torch.cuda.synchronize()
        assert (kernels.launches["topk_rows"], kernels.launches["dense_blocks"]) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(top, kernels.topk_rows_plain(x, p)[1])
        assert torch.equal(got, kernels.dense_blocks_plain(cell_block, top, u)), (nblk, p, u)
    with pytest.raises(ValueError):
        kernels.topk_rows(x, p, cell_block=cell_block, u=0)


def test_sq8_scan_kernel_matches_plain(cuda):
    """K11 against its plain version: ids equal except where the two
    distances tie within 1e-5 of the scale (fp32 sums in another order),
    over a store with invalid rows, repeated rows, a ragged last chunk and
    k up to SQ8_LIST_MAX and one past it (the distance mode)."""
    from turdb_tpu_torch.ops.quantize import sq8_encode

    g = torch.Generator(device=cuda).manual_seed(11)
    n, d = 3 * kernels.SQ8_CHUNK + 77, 96
    x = torch.randn(n, d, device=cuda, generator=g) * 3
    x[1::50] = x[0::50][: x[1::50].shape[0]]            # exact duplicate rows
    codes, mins, scales = sq8_encode(x)
    valid = torch.rand(n, device=cuda, generator=g) > 0.05
    q = torch.randn(130, d, device=cuda, generator=g) * 3
    for k in (1, 10, 64, kernels.SQ8_LIST_MAX, kernels.SQ8_LIST_MAX + 1):
        args = (q, (q * q).sum(1), q.sum(1), codes, mins, scales, valid, k)
        dk, ik = kernels.sq8_scan(*args)
        dp, ip = kernels.sq8_scan_plain(*args)
        torch.cuda.synchronize()
        scale = float(dp.abs().max())
        assert float((dk - dp).abs().max()) <= 1e-5 * scale
        differ = ik != ip
        assert bool(((dk - dp).abs()[differ] <= 1e-5 * scale).all())
        assert bool(valid[ik.long()].all())


def test_mesh_on_one_card_answers_as_the_plain_index(cuda):
    """A mesh of one repeated card: one shard equals the plain IvfIndex,
    and four shards (K2 merging their lists) reach the plain index's
    recall; the HNSW mesh searches on the card too."""
    from turdb_tpu_torch.parallel import ShardedHnswIndex, ShardedIvfIndex, make_mesh

    pool = make_pool(np.random.default_rng(0), 40_256, 64)
    x, q = pool[:40_000], pool[40_000:]
    flat = FlatIndex(dim=64, capacity=len(x), device=cuda)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    plain = IvfIndex(dim=64, device=cuda)
    plain.add(x)
    dp, ip = plain.search(q, 10, nprobe=8)
    one = ShardedIvfIndex(dim=64, mesh=make_mesh(n_db=1, devices=[cuda]))
    one.add(x)
    d1, i1 = one.search(q, 10, nprobe=8)
    np.testing.assert_array_equal(i1, ip)
    np.testing.assert_array_equal(d1, dp)
    four = ShardedIvfIndex(dim=64, mesh=make_mesh(n_db=4, devices=[cuda] * 4))
    gids = four.add(x)
    before = kernels.launches["topk_rows"]
    _, g4 = four.search(q, 10, nprobe=8)
    assert kernels.launches["topk_rows"] == before + 5     # 4 cell selections + the merge
    lut = {int(v): r for r, v in enumerate(gids)}
    rows = np.array([[lut.get(int(v), -1) for v in row] for row in g4])
    assert recall_of(rows, truth) >= recall_of(ip, truth) - 0.02
    hn = ShardedHnswIndex(dim=64, mesh=make_mesh(n_db=2, devices=[cuda] * 2),
                          ef_construction=64)
    hg = hn.add(x[:6000])
    _, gh = hn.search(x[:50], 1, ef=64)
    assert (gh[:, 0] == hg[:50]).mean() >= 0.95


def test_mesh_across_cards_answers_as_one_card(cuda):
    """Shards on several cards (each kernel launched on its tensors' card,
    whatever card is current) answer exactly as the same shards on copies
    of one card. Needs two or more cards."""
    from turdb_tpu_torch.parallel import ShardedHnswIndex, ShardedIvfIndex, make_mesh

    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    pool = make_pool(np.random.default_rng(1), 40_256, 64)
    x, q = pool[:40_000], pool[40_000:]
    torch.cuda.set_device(0)
    out = {}
    for name, devs in (("one", [cards[0]] * n), ("many", cards)):
        ivf = ShardedIvfIndex(dim=64, mesh=make_mesh(n_db=n, devices=devs))
        ivf.add(x)
        hn = ShardedHnswIndex(dim=64, mesh=make_mesh(n_db=n, devices=devs), ef_construction=64)
        hn.add(x[:8000])
        hn.pack_serving()
        assert [s.state.centroids.device for s in ivf.shards] == devs
        out[name] = (ivf.search(q, 10, nprobe=8), hn.search(q, 10, ef=64),
                     hn.search_serve(q, 10, ef=48))
        assert torch.cuda.current_device() == 0
    for a, b in zip(out["one"], out["many"]):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])


def test_widths_past_the_kernels(cuda):
    """k = 3000 takes K2's wide form (one launch, bit-equal to the plain
    version, and with K10 fused, bit-equal blocks); the widths no kernel
    holds raise on the card before any launch: the IVF rerank past
    SEL_MAX, ef = 1500 in K8 and K6, K7 at W = 100, d = 512; a wave insert
    past SELECT_W_MAX refuses before any write."""
    from turdb_tpu_torch.models import hnsw as th

    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(5000, 16, device=cuda, generator=g)
    q = torch.randn(2, 16, device=cuda, generator=g)
    xn, qn = (x * x).sum(1), (q * q).sum(1)
    kw = dict(rown=qn, coln=xn, epilogue=kernels.EPI_L2)
    before = kernels.launches["topk_rows"]
    dk, ik = kernels.topk_rows(q @ x.T, 3000, **kw)
    assert kernels.launches["topk_rows"] == before + 1 and dk.shape == (2, 3000)
    dp, ip = kernels.topk_rows_plain(q @ x.T, 3000, **kw)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    cell_block = torch.randint(0, 700, (5000,), device=cuda, generator=g, dtype=torch.int32)
    for u in (2100, 3000):
        _, top, blk = kernels.topk_rows(q @ x.T, 3000, cell_block=cell_block, u=u, **kw)
        assert torch.equal(top, ip) and torch.equal(blk, kernels.dense_blocks_plain(
            cell_block, top, u))
    pool = make_pool(np.random.default_rng(3), 20_256, 32, n_clusters=64)
    ivf = IvfIndex(dim=32, device=cuda, n_clusters=16, sq8=True, rerank=2500)
    ivf.add(pool[:20_000])
    with pytest.raises(ValueError, match="SEL_MAX|2048"):
        ivf.search(pool[20_000:], 10, nprobe=8)
    hn = th.HnswIndex(dim=32, device=cuda, ef_construction=64)
    hn.add(pool[:12_000])
    hq = torch.as_tensor(pool[20_000:20_064], device=cuda)
    with pytest.raises(ValueError, match="ef"):
        hn.search(hq, 10, ef=1500)
    hn.pack_serving()
    with pytest.raises(ValueError, match="ef"):
        hn.search_serve(hq, 10, ef=1500)
    x5 = torch.randn(4000, 512, device=cuda, generator=g)
    cand = torch.randint(0, 4000, (64, 100), dtype=torch.int32, device=cuda, generator=g)
    with pytest.raises(ValueError, match="W\\*dim"):
        kernels.hnsw_select(x5, (x5 * x5).sum(1), torch.arange(64, dtype=torch.int32,
                                                               device=cuda), cand,
                            deg=16, metric=0, alpha=1.0)
    wide = th.HnswIndex(dim=32, device=cuda, ef_construction=kernels.SELECT_W_MAX + 1)
    with pytest.raises(ValueError, match="ef_construction"):
        wide.add(pool[:100])
    assert len(wide) == 0
    vk, _ = kernels.topk_rows(x[:4, :100].contiguous(), 5)
    assert torch.equal(vk, kernels.topk_rows_plain(x[:4, :100], 5)[0])


def test_sq8_scan_past_the_list_and_the_slice(cuda):
    """K11 at k = 100 and k = 2100 (the distance mode; K2's wide form past
    SEL_MAX) and at d = 400 (two column slices, 320 + 80, summed in fp32),
    against its plain version with test_sq8_scan_kernel_matches_plain's
    tolerance (1e-5 of the distance scale; ids apart only inside it); every
    K11 launch counts (two a slice of queries at d = 400)."""
    from turdb_tpu_torch.ops.quantize import sq8_encode

    g = torch.Generator(device=cuda).manual_seed(12)
    for d, k in ((24, 100), (24, 2100), (400, 10), (400, 100)):
        x = torch.randn(5000, d, device=cuda, generator=g)
        codes, mins, scales = sq8_encode(x)
        valid = torch.rand(5000, device=cuda, generator=g) > 0.05
        q = torch.randn(70, d, device=cuda, generator=g) * 3
        args = (q, (q * q).sum(1), q.sum(1), codes, mins, scales, valid, k)
        before = kernels.launches["sq8_scan"]
        dk, ik = kernels.sq8_scan(*args)
        assert kernels.launches["sq8_scan"] - before == len(kernels.sq8_slices(d))
        dp, ip = kernels.sq8_scan_plain(*args)
        scale = float(dp.abs().max())
        assert float((dk - dp).abs().max()) <= 1e-5 * scale, (d, k)
        differ = ik != ip
        assert bool(((dk - dp).abs()[differ] <= 1e-5 * scale).all()), (d, k)
        assert bool(valid[ik.long()].all())


def _norm_atol(x, q):
    """Distances' tolerance where two sums of fp32 products part: DOT_RTOL
    of the largest ‖x‖² + ‖q‖² (the terms the L2 epilogue cancels), as
    test_hnsw_graph_beam_at_its_limits holds K8."""
    x, q = (np.asarray(a, np.float32) for a in (x, q))
    return DOT_RTOL * float((x * x).sum(1).max() + (q * q).sum(1).max())


def _cpu_state(state):
    from turdb_tpu_torch.parallel.sharded import _to_device

    return _to_device(state, torch.device("cpu"))


def _cpu_ivf(idx):
    """A CPU copy of an IvfIndex (its state and config): its search runs
    the plain versions."""
    import copy

    cpu = copy.copy(idx)
    cpu.device = torch.device("cpu")
    cpu.state = _cpu_state(idx.state)
    return cpu


@pytest.mark.parametrize("d", (6, 130))
def test_dims_past_a_multiple_of_four(cuda, d):
    """d = 6 and d = 130: the IVF f32 and sq8 stores and the HNSW graph and
    serving pack, built on the card (the kernels read zero-padded copies of
    the rows), answer as the same states searched by the plain versions on
    the CPU."""
    from turdb_tpu_torch.models import hnsw as th
    from turdb_tpu_torch.models.hnsw_serve import serve_search_impl

    pool = make_pool(np.random.default_rng(4), 12_064, d, n_clusters=64)
    x, q = pool[:12_000], pool[12_000:]
    atol = _norm_atol(x, q)
    for flags in (dict(), dict(sq8=True, rerank=40)):
        idx = IvfIndex(dim=d, device=cuda, **flags)
        idx.add(x)
        assert idx.state.pvecs.shape[-1] == d
        dk, ik = idx.search(q, 10, nprobe=8, out="torch")
        dp, ip = _cpu_ivf(idx).search(q, 10, nprobe=8)
        _assert_near(dk.cpu(), ik.cpu(), torch.from_numpy(dp), torch.from_numpy(ip), atol, 0.99)
    hn = th.HnswIndex(dim=d, device=cuda, ef_construction=64)
    hn.add(x[:6000])
    hn.add(x[6000:6500])                      # the waves
    hq = torch.as_tensor(q, device=cuda)
    dk, ik = hn.search(hq, 10, ef=64, out="torch")
    dp, ip = th.hnsw_search_impl(_cpu_state(hn.state), hq.cpu(), None, cfg=hn.cfg, k=10, ef=64,
                                 iters=96, filtered=False, descent_ef=hn._descent_ef)
    _assert_near(dk.cpu(), ik.cpu(), dp, ip, atol, 0.99)
    hn.pack_serving()
    dk, ik = hn.search_serve(hq, 10, ef=64, out="torch")
    dp, ip = serve_search_impl(_cpu_state(hn.serve), hq.cpu(), None, metric=hn.cfg.metric, k=10,
                               ef=64, iters=96)
    _assert_near(dk.cpu(), ik.cpu(), dp, ip, atol, 0.99)


def test_ten_level_graph(cuda):
    """An HnswConfig(max_levels=10) graph (nine upper levels) on the card:
    the descent walks them in two K9 launches (8, then 1) and answers as
    the same state on the CPU."""
    import dataclasses

    from turdb_tpu_torch.models import hnsw as th

    pool = make_pool(np.random.default_rng(5), 8_064, 32, n_clusters=64)
    hn = th.HnswIndex(dim=32, device=cuda, ef_construction=64, bulk_threshold=10**9)
    hn.cfg = dataclasses.replace(hn.cfg, max_levels=10)
    hn.state = th.init_state(hn.cfg, hn.capacity, hn.device)
    hn.add(pool[:4000])
    assert len(hn.state.adj_hi) == 9
    hq = torch.as_tensor(pool[8000:], device=cuda)
    before = kernels.launches["hnsw_greedy"]
    dk, ik = hn.search(hq, 10, ef=64, out="torch")
    assert kernels.launches["hnsw_greedy"] == before + 2
    dp, ip = th.hnsw_search_impl(_cpu_state(hn.state), hq.cpu(), None, cfg=hn.cfg, k=10, ef=64,
                                 iters=96, filtered=False, descent_ef=hn._descent_ef)
    _assert_near(dk.cpu(), ik.cpu(), dp, ip, _norm_atol(pool[:4000], pool[8000:]), 0.99)


def _sql_docs(path, device, x):
    """The port's Database on `device` with x loaded as docs(id, emb, grp)."""
    from turdb_tpu_torch.database.api import Database

    db = Database.create(str(path), device=device)
    db.execute(f"CREATE TABLE docs (id BIGINT PRIMARY KEY, emb VECTOR({x.shape[1]}), grp INT)")
    db.bulk_insert("docs", {"id": np.arange(len(x)), "emb": x, "grp": np.arange(len(x)) % 3})
    return db


def _vec(v):
    return "'[" + ",".join(f"{float(a):.6f}" for a in v) + "]'"


@pytest.mark.parametrize("using,opts", (("IVF", "WITH (nprobe = 8)"),
                                        ("IVF", "WITH (compact = true)"), ("HNSW", "")))
def test_sql_on_cuda_answers_as_on_cpu(cuda, tmp_path, using, opts):
    """The same SQL script on the card and on the CPU: the index on the
    card (its kernels launched), the same ids on >= 98 % of the entries and
    the recall against the exact path within 0.02, also under a filter."""
    pool = make_pool(np.random.default_rng(3), 6_032, 32, n_clusters=64)
    x, q = pool[:6000], pool[6000:]
    out = {}
    for dev in ("cpu", "cuda"):
        db = _sql_docs(tmp_path / dev, dev, x)
        exact = [[r[0] for r in db.query(f"SELECT id FROM docs ORDER BY emb <-> {_vec(v)} "
                                         "LIMIT 10")] for v in q]
        db.execute(f"CREATE INDEX ix ON docs USING {using} (emb) {opts}")
        assert db.catalog["main"]["docs"].hnsw["ix"].index.device.type == dev
        before = sum(kernels.launches.values())
        ids = [[r[0] for r in db.query(f"SELECT id FROM docs ORDER BY emb <-> {_vec(v)} "
                                       "LIMIT 10")] for v in q]
        filt = [db.query(f"SELECT id, grp FROM docs WHERE grp = 1 ORDER BY emb <-> {_vec(v)} "
                         "LIMIT 10") for v in q[:8]]
        if dev == "cuda":
            assert sum(kernels.launches.values()) > before
        assert all(len(f) == 10 and all(r[1] == 1 for r in f) for f in filt)
        rec = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(ids, exact)])
        out[dev] = (np.array(ids), rec)
        db.close()
    (ic, rc), (ig, rg) = out["cpu"], out["cuda"]
    assert abs(rc - rg) <= 0.02 and rg >= 0.9, (rc, rg)
    assert (ic == ig).mean() >= 0.98


@pytest.mark.parametrize("using,limit,bound", (("IVF", 513, "2048"), ("HNSW", 129, "1024")))
def test_sql_limits_past_the_kernels_raise_on_cuda(cuda, tmp_path, using, limit, bound):
    """SQL asks the index for max(4 LIMIT, LIMIT + 8) rows (and HNSW for ef =
    max(64, 2 fetch)): LIMIT 513 on IVF passes the probes' m <= 2048, LIMIT
    129 on HNSW the beams' ef <= 1024. On the card the kernel's ValueError
    reaches the caller of db.query, naming the limit; on the CPU the plain
    versions answer, as the reference does."""
    pool = make_pool(np.random.default_rng(4), 4_001, 32, n_clusters=64)
    x, q = pool[:4000], pool[4000]
    sql = f"SELECT id FROM docs ORDER BY emb <-> {_vec(q)} LIMIT {limit}"
    for dev in ("cpu", "cuda"):
        db = _sql_docs(tmp_path / dev, dev, x)
        db.execute(f"CREATE INDEX ix ON docs USING {using} (emb)")
        if dev == "cpu":
            assert len(db.query(sql)) == limit
        else:
            with pytest.raises(ValueError, match=bound):
                db.query(sql)
            assert len(db.query(sql.replace(f"LIMIT {limit}", "LIMIT 10"))) == 10
        db.close()
