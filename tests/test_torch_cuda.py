"""The port's CUDA kernels against their plain versions on the card, and
the slices (IVF, HNSW) on CUDA against the same slices on the CPU. Marked
`cuda`: these skip where no GPU is present. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q
"""

import sys
from pathlib import Path

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
    bit-equal to the plain version; rows past the query row K1 and K5 keep
    in shared memory (d = 60,000) run their wide forms and agree with the
    plain versions; an argument a C entry point refuses comes back as an
    error and raises (nothing runs in its place), and the next launch is
    not charged with it."""
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
    alive = torch.ones(c, lcap, dtype=torch.bool, device=cuda)
    pnorms = (pvecs * pvecs).sum(-1)
    before = kernels.launches["ivf_probe_f32_wide"]
    dk, ik = kernels.ivf_probe_f32(q, (q * q).sum(1), cells, pvecs, pnorms, members, alive,
                                   metric=0, k=10, m=10, replicated=False)
    assert kernels.launches["ivf_probe_f32_wide"] == before + 1
    dp, ip = kernels.ivf_probe_f32_plain(q, (q * q).sum(1), cells, pvecs, pnorms, members,
                                         alive, None, 0, 10, 10, False)
    _assert_near(dk, ik, dp, ip, 1e-4 * float(dp.abs().max()), 0.9)
    q = torch.randn(2, d, device=cuda)
    cand = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    cd = torch.zeros(2, 4, device=cuda)
    before = kernels.launches["ivf_rerank_wide"]
    dk, ik = kernels.ivf_rerank(q, (q * q).sum(1), cd, cand, cand, pvecs, pnorms, k=2,
                                replicated=False)
    assert kernels.launches["ivf_rerank_wide"] == before + 1
    dp, ip = kernels.ivf_rerank_plain(q, (q * q).sum(1), cd, cand, cand, pvecs, pnorms, None,
                                      None, 2, False)
    _assert_near(dk, ik, dp, ip, 1e-4 * float(dp.abs().max()), 0.5)
    # an entry point's refusal (a tail with no rows) raises; the next
    # launch runs clean
    out = torch.empty(4, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        kernels._launch("ivf_probe_tail_wide", cuda, cells.data_ptr(), 0, c, members.data_ptr(),
                        lcap, cd.data_ptr(), out.data_ptr(), 1, 1, 0, 0, out.data_ptr(),
                        out.data_ptr(), cd.data_ptr(), out.data_ptr(), None, counter=None)
    vk, _ = kernels.topk_rows(x, 5)
    vp, _ = kernels.topk_rows_plain(x, 5)
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


# K2's wide routes at their boundary widths: (rows, n, k, CTAs a row; 0 is
# the global form): a cluster of a CTA per 8,192 columns or 1,024 winners
# (3 at k = 2,049 or 3,000 at any batch, 8 at the wide probes' and the
# flat chunk's widths and at k = n = 8,192, 9 non-portable where 8 cannot
# hold the keys), the global form past 16 CTAs and past 227 KB of winners
K2_WIDE_ROUTES = ((64, 5000, 3000, 3), (8, 8192, 2049, 3), (8, 8193, 2049, 3),
                  (8, 8192, 8192, 8), (4, 2400, 2400, 3), (256, 5000, 3000, 3),
                  (2, 76_800, 4_800, 8), (2, 76_800, 2_400, 8), (4, 131_072, 3_000, 8),
                  (1, 400_000, 3_000, 9), (1, 200_000, 16_384, 9), (1, 800_000, 3_000, 0),
                  (1, 50_000, 20_000, 0))


def test_wide_selections_match_plain(cuda):
    """K2 at k = 300 and 2048, and each wide route at its boundary widths
    (K2_WIDE_ROUTES) with ties across its CTAs' boundaries, +inf lanes and
    K10 fused: bit-equal, one launch counted as `topk_rows_wide` too; K1 at
    P*L = 32768 (chunked) and at m = 600 with replicas, in both output
    modes."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(32, 20_000, device=cuda, generator=g)
    x[:, 5000:10_000] = x[:, :5000]                  # exact ties
    for k in (300, 2048):
        vk, pk = kernels.topk_rows(x, k)
        vp, pp = kernels.topk_rows_plain(x, k)
        assert torch.equal(vk, vp) and torch.equal(pk, pp)
    for b, n, k, ctas in K2_WIDE_ROUTES:
        assert kernels.topk_wide_ctas(n, k) == ctas
        # values on a coarse grid, each CTA's first 64 columns copying the
        # 64 before them: the threshold ties across the boundaries
        xw = torch.round(torch.randn(b, n, device=cuda, generator=g) * 4) / 4
        w = -(-n // max(ctas, 1))
        for s0 in range(w, n, w):
            xw[:, s0:s0 + 64] = xw[:, s0 - 64:s0]
        rown = torch.rand(b, device=cuda, generator=g)
        coln = torch.rand(n, device=cuda, generator=g)
        valid = torch.rand(n, device=cuda, generator=g) < 0.9
        cell_block = torch.randint(0, n // 3, (n,), device=cuda, generator=g, dtype=torch.int32)
        for kw in (dict(), dict(rown=rown, coln=coln, colvalid=valid, epilogue=kernels.EPI_L2,
                                clamp=True)):
            before = kernels.launches["topk_rows_wide"]
            vk, pk = kernels.topk_rows(xw, k, **kw)
            assert kernels.launches["topk_rows_wide"] == before + 1
            vp, pp = kernels.topk_rows_plain(xw, k, **kw)
            assert torch.equal(vk, vp) and torch.equal(pk, pp), (n, k, kw.keys())
        _, top, blk = kernels.topk_rows(xw, k, cell_block=cell_block, u=k - 7, **kw)
        assert torch.equal(top, pp)
        assert torch.equal(blk, kernels.dense_blocks_plain(cell_block, top, k - 7)), (n, k)
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
    # one expansion step past EXP_MAX: the wide form, the same buffers
    opts = dict(ef=kernels.EF_MAX, iters=kernels.EXP_MAX + expand, metric=0, expand=expand)
    before = kernels.launches["hnsw_graph_beam_wide"]
    got = kernels.hnsw_graph_beam(adj, x, norms, q, qn, seeds, sd, **opts)
    assert kernels.launches["hnsw_graph_beam_wide"] == before + 1
    want = kernels.hnsw_graph_beam_plain(adj, x, norms, q, qn, seeds, sd, **opts)
    torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
    assert (got.cand_i == want.cand_i).float().mean() >= 0.99


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
    """Past the fast forms' widths K8 (ef = EF_MAX + 1) and K7 (W =
    SELECT_W_MAX + 1) run their wide forms, one launch each, and answer as
    the plain versions (which, on CPU tensors, take any width)."""
    g = torch.Generator(device=cuda).manual_seed(31)
    x, n, adj = _graph(g, 2048, 32, 16, cuda)
    seed = torch.randint(0, 2048, (4, 1), dtype=torch.int32, device=cuda, generator=g)
    sd = (n[:4] + n[seed[:, 0].long()] - 2 * (x[:4] * x[seed[:, 0].long()]).sum(1))[:, None]
    sd = sd.clamp_min(0).contiguous()
    opts = dict(ef=kernels.EF_MAX + 1, iters=8, metric=0)
    before = kernels.launches["hnsw_graph_beam_wide"]
    got = kernels.hnsw_graph_beam(adj, x, n, x[:4], n[:4], seed, sd, **opts)
    assert kernels.launches["hnsw_graph_beam_wide"] == before + 1
    want = kernels.hnsw_graph_beam_plain(adj, x, n, x[:4], n[:4], seed, sd, **opts)
    torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=1e-3)
    assert (got.cand_i == want.cand_i).float().mean() >= 0.99
    cand = torch.randint(0, 2048, (4, kernels.SELECT_W_MAX + 1), dtype=torch.int32,
                         device=cuda, generator=g)
    before = kernels.launches["hnsw_select_wide"]
    ki, kd, kp = kernels.hnsw_select(x, n, seed[:, 0], cand, deg=16, metric=0, alpha=1.0)
    assert kernels.launches["hnsw_select_wide"] == before + 1
    pi, pd, pp = kernels.hnsw_select_plain(x, n, seed[:, 0], cand, deg=16, metric=0, alpha=1.0)
    assert torch.equal(ki, pi) and torch.equal(kp, pp)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-3)


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
    """K7's presorted mode past SELECT_W_MAX and K8-SQ past EF_MAX run
    their wide forms and agree with the plain versions; K9 on rows of 30
    (not a multiple of 4) reads a zero-padded copy; the next launches run
    and agree with their plain versions."""
    from turdb_tpu_torch.ops.quantize import sq_rows_encode

    x = torch.randn(2048, 32, device=cuda)
    n = (x * x).sum(1)
    adj = torch.randint(0, 2048, (2048, 16), dtype=torch.int32, device=cuda)
    w = kernels.SELECT_W_MAX + 1
    cand_i = torch.randperm(2048, device=cuda)[:4 * w].reshape(4, w).to(torch.int32)
    cand_d = torch.sort(torch.rand(4, w, device=cuda), dim=1).values
    before = kernels.launches["hnsw_select_sorted_wide"]
    ki, kd, kp = kernels.hnsw_select_sorted(x, cand_i, cand_d, deg=16, metric=0, alpha=1.0)
    assert kernels.launches["hnsw_select_sorted_wide"] == before + 1
    pi, pd, pp = kernels.hnsw_select_sorted_plain(x, cand_i, cand_d, deg=16, metric=0,
                                                  alpha=1.0)
    assert torch.equal(ki, pi) and torch.equal(kd, pd) and torch.equal(kp, pp)
    cur = torch.zeros(4, dtype=torch.int32, device=cuda)
    x30 = torch.randn(2048, 30, device=cuda)      # rows read from a zero-padded copy
    n30 = (x30 * x30).sum(1)
    ki, kd, _ = kernels.hnsw_greedy(adj, x30, n30, x30[:4], n30[:4], cur, n30[:4], metric=0)
    pi, pd, _ = kernels.hnsw_greedy_plain(adj, x30, n30, x30[:4], n30[:4], cur, n30[:4], metric=0)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-3)
    rows = sq_rows_encode(x, 8)
    opts = dict(ef=kernels.EF_MAX + 1, iters=8, metric=0)
    sd = kernels._gathered_epilogue((x[:4] * rows[cur.long()]).sum(1), 0, n[:4],
                                    n[cur.long()])[:, None].contiguous()
    before = kernels.launches["hnsw_graph_beam_sq_wide"]
    got = kernels.hnsw_graph_beam(adj, rows, n, x[:4], n[:4], cur[:, None], sd, **opts)
    assert kernels.launches["hnsw_graph_beam_sq_wide"] == before + 1
    want = kernels.hnsw_graph_beam_plain(adj, rows, n, x[:4], n[:4], cur[:, None], sd, **opts)
    torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=1e-3)
    assert (got.cand_i == want.cand_i).float().mean() >= 0.99
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
    version, and with K10 fused, bit-equal blocks); past the fast forms'
    widths the wide forms answer through the entry points as the same index
    does on the CPU: the IVF rerank past SEL_MAX (K5 wide), ef = 1500 in
    the graph search (K8 wide) and the serving search (K6 wide), K7 at
    W = 100, d = 512, and wave inserts past SELECT_W_MAX (K7's presorted
    mode, wide)."""
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
    before = kernels.launches["ivf_rerank_wide"]
    dg, ig = ivf.search(pool[20_000:], 10, nprobe=8)
    assert kernels.launches["ivf_rerank_wide"] > before
    dc, ic = _cpu_ivf(ivf).search(pool[20_000:], 10, nprobe=8)
    assert np.mean(ig == ic) >= 0.99
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-3)
    hn = th.HnswIndex(dim=32, device=cuda, ef_construction=64)
    hn.add(pool[:12_000])
    hq = torch.as_tensor(pool[20_000:20_064], device=cuda)
    flat = FlatIndex(dim=32, capacity=12_000, device=cuda)
    flat.add(pool[:12_000])
    _, truth = flat.search(pool[20_000:20_064], k=10)
    before = kernels.launches["hnsw_graph_beam_wide"]
    _, ids = hn.search(hq, 10, ef=1500)
    assert kernels.launches["hnsw_graph_beam_wide"] > before and recall_of(ids, truth) >= 0.99
    hn.pack_serving()
    before = kernels.launches["hnsw_serve_beam_wide"]
    _, ids = hn.search_serve(hq, 10, ef=1500)
    assert kernels.launches["hnsw_serve_beam_wide"] > before and recall_of(ids, truth) >= 0.99
    x5 = torch.randn(4000, 512, device=cuda, generator=g)
    cand = torch.randint(0, 4000, (64, 100), dtype=torch.int32, device=cuda, generator=g)
    t5 = torch.arange(64, dtype=torch.int32, device=cuda)
    before = kernels.launches["hnsw_select_wide"]
    ki, kd, kp = kernels.hnsw_select(x5, (x5 * x5).sum(1), t5, cand, deg=16, metric=0,
                                     alpha=1.0)
    assert kernels.launches["hnsw_select_wide"] == before + 1
    pi, pd, pp = kernels.hnsw_select_plain(x5, (x5 * x5).sum(1), t5, cand, deg=16, metric=0,
                                           alpha=1.0)
    assert (ki == pi).all(1).float().mean() >= 0.98
    wide = th.HnswIndex(dim=32, device=cuda, ef_construction=kernels.SELECT_W_MAX + 1)
    before = kernels.launches["hnsw_select_sorted_wide"]
    wide.add(pool[:300])
    wide.add(pool[300:400])
    assert len(wide) == 400 and kernels.launches["hnsw_select_sorted_wide"] > before
    _, ids = wide.search(pool[:50], 1, ef=64)
    assert np.mean(ids[:, 0] == np.arange(50)) >= 0.98
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


@pytest.mark.parametrize("using,limit,wide", (("IVF", 513, "ivf_probe_f32_wide"),
                                              ("HNSW", 129, "hnsw_graph_beam_wide")))
def test_sql_limits_past_the_kernels_raise_on_cuda(cuda, tmp_path, using, limit, wide):
    """SQL asks the index for max(4 LIMIT, LIMIT + 8) rows (and HNSW for ef =
    max(64, 2 fetch)): LIMIT 513 on IVF passes the probes' m <= 2048, LIMIT
    129 on HNSW the beams' ef <= 1024. On the card the wide forms answer
    (counted), with LIMIT rows, as the CPU's plain versions do: the same
    ids on 98 % of the places."""
    pool = make_pool(np.random.default_rng(4), 4_001, 32, n_clusters=64)
    x, q = pool[:4000], pool[4000]
    sql = f"SELECT id FROM docs ORDER BY emb <-> {_vec(q)} LIMIT {limit}"
    out = {}
    for dev in ("cpu", "cuda"):
        db = _sql_docs(tmp_path / dev, dev, x)
        db.execute(f"CREATE INDEX ix ON docs USING {using} (emb)")
        before = kernels.launches[wide]
        out[dev] = [r[0] for r in db.query(sql)]
        assert len(out[dev]) == limit
        if dev == "cuda":
            assert kernels.launches[wide] > before
        db.close()
    assert np.mean(np.array(out["cpu"]) == np.array(out["cuda"])) >= 0.98


# ---------------------------------------------------------------------------
# the wide forms (csrc/probe_wide.cu, graph_wide.cu, hnsw_select_wide.cu)
# against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["f32", "sq8_query", "sq8_cell"])
def test_probe_wide_forms_match_plain(cuda, route):
    """K1 and K4 past m = SEL_MAX (2,500 winners of 4,096 or 8,192 lanes):
    every lane's distance, one K2 selection and the wide dedup tail, both
    modes, with replicas and `allowed`, one counted launch a call. K4's
    integer dots make it bit-equal to its plain version on both routes;
    K1's distances are its fast form's fp32 sums: within 1e-5 of their
    size, ids and positions equal on 99 %."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(30)
    lcap, p = (128, 64) if route == "sq8_cell" else (256, 16)
    pvecs, pnorms, members, alive, allowed = _store(g, 300, lcap, 64, 20_000, cuda)
    q = torch.randn(12, 64, device=cuda, generator=g)
    qn = (q * q).sum(1)
    cells = torch.rand(12, 300, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    name = {"f32": "ivf_probe_f32_wide", "sq8_query": "ivf_probe_sq8_wide_query",
            "sq8_cell": "ivf_probe_sq8_wide"}[route]
    if route != "f32":
        codes, mins, scales, _ = _sq8_store(pvecs)
        qc, qs, qsum = quantize_queries(q)
        assert kernels.probe_route(p, lcap, 64, cuda) == route[4:]
    m = 2500
    for mode, k in ((kernels.MODE_TOPK, 2100), (kernels.MODE_CAND, m)):
        for allow in (None, allowed):
            kw = dict(k=k, m=m, replicated=True, mode=mode)
            before = kernels.launches[name]
            if route == "f32":
                args = (q, qn, cells, pvecs, pnorms, members, alive, allow)
                got = kernels.ivf_probe_f32(*args, metric=0, **kw)
                want = kernels.ivf_probe_f32_plain(*args, metric=0, **kw)
            else:
                args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                        allow)
                got = kernels.ivf_probe_sq8(*args, **kw)
                want = kernels.ivf_probe_sq8_plain(*args, **kw)
            assert kernels.launches[name] == before + 1
            if route == "f32":
                torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
                for a, b in zip(got[1:], want[1:]):
                    assert (a == b).float().mean() >= 0.99
            else:
                for a, b in zip(got, want):
                    assert torch.equal(a, b)


@pytest.mark.parametrize("d", [100, 3072, 4608])
def test_probe_sq8_query_major_wide_pass_matches_plain(cuda, d):
    """K4's query-major wide pass (rows of 4-byte words at d = 100, of
    16-byte words at 3,072 and past DIM_MAX at 4,608) at B = 1 with P = 20
    and 600 (one (query, probe) spread over CTAs, then whole cells) and at
    B = 256, P = 50: both modes, replicas, `allowed`; bit-equal to the
    plain version, one `ivf_probe_sq8_wide_query` launch a call."""
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(33 + d)
    lcap, c = 128, 620
    pvecs, pnorms, members, alive, allowed = _store(g, c, lcap, d, 6000, cuda)
    codes, mins, scales, _ = _sq8_store(pvecs)
    del pvecs
    for b, p in ((1, 20), (1, 600), (256, 50)):
        q = torch.randn(b, d, device=cuda, generator=g)
        qc, qs, qsum = quantize_queries(q)
        qn = (q * q).sum(1)
        cells = torch.rand(b, c, device=cuda, generator=g).topk(p).indices.to(torch.int32)
        assert kernels.probe_route(p, lcap, d, cuda) == "query"
        args = (qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive, allowed)
        for mode, k in ((kernels.MODE_TOPK, 2100), (kernels.MODE_CAND, 2400)):
            kw = dict(k=k, m=2400, replicated=True, mode=mode)
            before = kernels.launches["ivf_probe_sq8_wide_query"]
            got = kernels.ivf_probe_sq8(*args, **kw)
            assert kernels.launches["ivf_probe_sq8_wide_query"] == before + 1
            want = kernels.ivf_probe_sq8_plain(*args, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y)


def test_profile_trace_holds_device_spans(cuda, tmp_path):
    """`profile_trace` around a search writes a Chrome trace with the
    search's device spans in it."""
    import json

    from turdb_tpu_torch.utils.timing import profile_trace

    x = make_pool(np.random.default_rng(9), 4000, 32, n_clusters=32)
    idx = IvfIndex(dim=32, device=cuda)
    idx.add(x[:3900])
    with profile_trace(tmp_path / "trace") as info:
        idx.search(x[3900:], 10, nprobe=4)
    assert info["device_spans"] > 0
    events = json.loads(open(info["path"]).read())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_rerank_wide_form_matches_plain(cuda):
    """K5 past r = SEL_MAX (2,500 candidates) over the f32 and the SQ16
    store, with and without replicas: one counted launch writes the exact
    distances in K5's order and K2 selects; within DOT_RTOL (and 1e-4),
    ids apart only inside that band and equal on 99 %."""
    g = torch.Generator(device=cuda).manual_seed(32)
    pvecs, pnorms, members, alive, _ = _store(g, 300, 256, 64, 3000, cuda)
    _, mins, scales, u16 = _sq8_store(pvecs)
    q = torch.randn(16, 64, device=cuda, generator=g)
    qn = (q * q).sum(1)
    cells = torch.rand(16, 300, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    r = 2500
    cd, ci, cpos = kernels.ivf_probe_f32(q, qn, cells, pvecs, pnorms, members, alive, metric=0,
                                         k=r, m=r, replicated=True, mode=kernels.MODE_CAND)
    for store, meta in ((pvecs, ()), (u16, (mins, scales))):
        for replicated in (True, False):
            args = (q, qn, cd, ci, cpos, store, pnorms, *meta)
            before = kernels.launches["ivf_rerank_wide"]
            dk, ik = kernels.ivf_rerank(*args, k=50, replicated=replicated)
            assert kernels.launches["ivf_rerank_wide"] == before + 1
            dp, ip = kernels.ivf_rerank_plain(*args, *(None, None)[len(meta):], k=50,
                                              replicated=replicated)
            _assert_near(dk, ik, dp, ip, 1e-4, 0.99)


@pytest.mark.parametrize("store", ["f32", "sq8", "sq16"])
def test_graph_beam_wide_form_matches_plain(cuda, store):
    """K8 (f32 rows) and K8-SQ (u8 / u16 codes) past the fast forms'
    widths: ef = 1,500 at iters 2,250 (past EF_MAX and EXP_MAX) with the
    expanded ids, with the filtered result buffer at k_res 1,100, and 40 x
    32 slots a step (past SLOTS_MAX), all with their state in shared
    memory; then the widest ef whose state fits there and the next, in the
    global scratch; and 96 seeds in falling distance order: one counted
    launch a call, the plain version's buffers but at near ties of the fp32
    dots (ids equal on 99 %)."""
    g = torch.Generator(device=cuda).manual_seed(33)
    x, norms, adj = _graph(g, 8000, 32, 32, cuda)
    rows = dict(_sq_stores(x))[store]
    q = (x[torch.randint(0, 8000, (16,), device=cuda, generator=g)]
         + 0.5 * torch.randn(16, 32, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    allowed = torch.rand(8000, device=cuda, generator=g) < 0.5
    seeds = torch.rand(16, 8000, device=cuda, generator=g).topk(8).indices.to(torch.int32)
    sd = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, rows[seeds.long()]), 0,
                                    qn[:, None], norms[seeds.long()]).contiguous()
    atol = 1e-5 * float(qn.max() + norms.max())
    name = "hnsw_graph_beam_wide" if store == "f32" else "hnsw_graph_beam_sq_wide"
    lib = kernels.build.library()
    # the SQL LIMIT 200 shape runs in shared memory; the widest ef that does
    # (iters 1.5 ef) and the next, the first in the global scratch
    assert lib.hnsw_beam_wide_bytes(32, 1600, 2400, 4, 800, 0) == 0
    ef_lo = next(ef for ef in range(3000, 8000, 4)
                 if lib.hnsw_beam_wide_bytes(32, ef + 4, (ef + 4) * 3 // 2, 4, 0, 0) > 0)
    # 96 seeds in falling distance order: their ranks cross warps, so each
    # lands after every warp has initialised the buffer
    many = torch.rand(16, 8000, device=cuda, generator=g).topk(96).indices.to(torch.int32)
    many_d = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, rows[many.long()]), 0,
                                        qn[:, None], norms[many.long()])
    order = many_d.argsort(1, descending=True)
    many, many_d = many.gather(1, order).contiguous(), many_d.gather(1, order).contiguous()
    for s_i, s_d, kw in (
            (seeds, sd, dict(return_expanded=True)), (seeds, sd, dict(allowed=allowed, k_res=1100)),
            (seeds, sd, dict(expand=40)),
            (seeds, sd, dict(ef=ef_lo, iters=ef_lo * 3 // 2, return_expanded=True)),
            (seeds, sd, dict(ef=ef_lo + 4, iters=(ef_lo + 4) * 3 // 2, return_expanded=True)),
            (many, many_d, dict(return_expanded=True)),
            (many, many_d, dict(allowed=allowed, k_res=1100))):
        opts = dict(ef=1500, iters=2250, metric=0)
        opts.update(kw)
        before = kernels.launches[name]
        got = kernels.hnsw_graph_beam(adj, rows, norms, q, qn, s_i, s_d, **opts)
        assert kernels.launches[name] == before + 1
        want = kernels.hnsw_graph_beam_plain(adj, rows, norms, q, qn, s_i, s_d, **opts)
        torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
        assert (got.cand_i == want.cand_i).float().mean() >= 0.99, kw
        assert (got.stats == want.stats).all(1).float().mean() >= 0.9
        if "k_res" in kw:
            torch.testing.assert_close(got.res_d, want.res_d, rtol=1e-5, atol=atol)
            assert bool(allowed[got.res_i[got.res_i >= 0].long()].all())
        if "return_expanded" in kw:
            assert (got.exp_ids == want.exp_ids).float().mean() >= 0.95



def _rerank_case(cuda, seed, d, r, b=4, n_ids=None):
    """A probe's r candidates a query over a store with repeated ids (every
    copy of an id carries its row), +inf lanes and id -1, and the SQ16
    copy of the store."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pvecs, pnorms, members, alive, _ = _store(g, 300, 128, d, n_ids or r, cuda)
    _, mins, scales, u16 = _sq8_store(pvecs)
    q = torch.randn(b, d, device=cuda, generator=g)
    qn = (q * q).sum(1)
    cells = torch.rand(b, 300, device=cuda, generator=g).topk(r // 100 + 1).indices
    cells = cells.to(torch.int32)
    cd, ci, cpos = kernels.ivf_probe_f32(q, qn, cells, pvecs, pnorms, members, alive, metric=0,
                                         k=r, m=r, replicated=False, mode=kernels.MODE_CAND)
    ci = ci.clone()
    ci[:, 7] = -1
    assert bool(torch.isinf(cd).any())
    return q, qn, cd, ci, cpos, ((pvecs, pnorms), (u16, pnorms, mins, scales))


def _rerank_wide_at(q, qn, cd, ci, cpos, pvecs, pnorms, mins=None, scales=None, *, k, replicated):
    """K5's wide form at any r (the wrapper takes it past SEL_MAX): the
    distance pass, K2, the id gather."""
    b, r = cd.shape
    sq16 = pvecs.dtype == torch.int16
    ex = torch.empty((b, r), dtype=torch.float32, device=q.device)
    table = kernels._rerank_table(b, r, replicated, q.device)
    kernels._launch("ivf_rerank_dist", q.device, q.data_ptr(), qn.data_ptr(), cd.data_ptr(),
                    ci.data_ptr(), cpos.data_ptr(), b, r, pvecs.data_ptr(), int(sq16),
                    pnorms.data_ptr(), kernels._ptr(mins), kernels._ptr(scales), pvecs.shape[2],
                    int(replicated), kernels._ptr(table), ex.data_ptr(), counter=None)
    dk, pos = kernels.topk_rows(ex, k)
    return dk, torch.where(torch.isinf(dk), -1, torch.gather(ci, 1, pos.long()))


@pytest.mark.parametrize("d", [64, 384])
def test_rerank_wide_distances_are_the_fast_forms_bit_for_bit(cuda, d):
    """K5 wide's distance pass (a grid of query chunks, PD_R rows in flight a
    warp, the sums meeting in reduce_rows; the SQ16 decode) sums each row in
    K5's order: at r <= SEL_MAX, where the fast form also runs, K2's
    selection of its distances equals the fast form's outputs bit for bit,
    f32 and SQ16, with and without replicas, at k = r and below."""
    q, qn, cd, ci, cpos, stores = _rerank_case(cuda, 50, d, 2000, n_ids=700)
    for store in stores:
        for replicated in (True, False):
            for k in (2000, 100):
                args = (q, qn, cd, ci, cpos, *store)
                fast = kernels.ivf_rerank(*args, k=k, replicated=replicated)
                wide = _rerank_wide_at(*args, k=k, replicated=replicated)
                for a, b in zip(fast, wide):
                    assert torch.equal(a, b), (len(store), replicated, k)


@pytest.mark.parametrize("d, r, n_ids", [(384, 2400, 900), (384, 9000, 3000), (4160, 2500, 900)])
def test_rerank_wide_claims_match_plain(cuda, d, r, n_ids):
    """K5 past SEL_MAX with many repeated ids: at the SQL LIMIT 600 call's
    width (2,400: the claim table in each CTA's shared memory), past what a
    CTA's table holds (9,000: the global table a claim pass fills) and past
    DIM_MAX, f32 and SQ16: one counted launch a call, the same candidates
    dropped as mask_duplicates drops (the finite ids at k = r are the plain
    version's, as a set), distances within DOT_RTOL and ids apart only
    inside that band."""
    q, qn, cd, ci, cpos, stores = _rerank_case(cuda, 51, d, r, b=2, n_ids=n_ids)
    words = kernels.build.library().ivf_rerank_dist_table_words(r, 1)
    assert (words == 0) == (r <= 8192)
    for store in stores:
        for replicated in (True, False):
            args = (q, qn, cd, ci, cpos, *store)
            before = kernels.launches["ivf_rerank_wide"]
            dk, ik = kernels.ivf_rerank(*args, k=r, replicated=replicated)
            assert kernels.launches["ivf_rerank_wide"] == before + 1
            dp, ip = kernels.ivf_rerank_plain(*args, *(None, None)[len(store) - 2:], k=r,
                                              replicated=replicated)
            _assert_near(dk, ik, dp, ip, 1e-4, 0.99)
            for a, b in zip(ik, ip):
                assert torch.equal(a[a >= 0].sort().values, b[b >= 0].sort().values)


@pytest.mark.parametrize("d", [768, 36])
def test_graph_beam_sq_wide_staged_routes_match_plain(cuda, d):
    """K8-SQ wide scores from rows staged in shared memory: SQ8 and SQ16 at
    ef 1,600 (the state in shared memory beside the query row and the
    stage; at 768-d SQ16 a step's 128 slots take two batches), and at ef
    5,600 (the state in the global scratch, the stage still in shared
    memory), d = 36 with 4-byte copies: one counted launch a call, the
    plain beam's buffers but at near ties of the fp32 dots."""
    from turdb_tpu_torch.ops.quantize import sq_rows_encode

    g = torch.Generator(device=cuda).manual_seed(52)
    n = 6000
    x, norms, adj = _graph(g, n, d, 32, cuda)
    q = (x[torch.randint(0, n, (4,), device=cuda, generator=g)]
         + 0.5 * torch.randn(4, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    seeds = torch.rand(4, n, device=cuda, generator=g).topk(8).indices.to(torch.int32)
    atol = 1e-5 * float(qn.max() + norms.max())
    d4 = d + (-d % 4)
    for bits in (8, 16):
        rows = sq_rows_encode(x, bits)
        sd = kernels._gathered_epilogue(torch.einsum("bd,bsd->bs", q, rows[seeds.long()]), 0,
                                        qn[:, None], norms[seeds.long()]).contiguous()
        for ef in (1600, 5600):
            glob = kernels._beam_sq_wide_bytes(32, ef, ef * 3 // 2, 4, 0, d4, bits) > 0
            assert glob == (ef == 5600)
            opts = dict(ef=ef, iters=ef * 3 // 2, metric=0, return_expanded=True)
            sl = slice(None) if ef == 1600 else slice(0, 2)
            args = (adj, rows, norms, q[sl], qn[sl], seeds[sl], sd[sl])
            before = kernels.launches["hnsw_graph_beam_sq_wide"]
            got = kernels.hnsw_graph_beam(*args, **opts)
            assert kernels.launches["hnsw_graph_beam_sq_wide"] == before + 1
            want = kernels.hnsw_graph_beam_plain(*args, **opts)
            torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=atol)
            assert (got.cand_i == want.cand_i).float().mean() >= 0.99, (bits, ef)
            assert (got.stats == want.stats).all(1).float().mean() >= 0.5
            assert (got.exp_ids == want.exp_ids).float().mean() >= 0.95

def test_serve_beam_wide_form_matches_plain(cuda):
    """K6 past EF_MAX and EXP_MAX: ef 1,500 at iters 2,250, the rerank of
    all 1,500 and of 1,100 under `allowed`, every metric, in shared memory;
    then the widest ef whose state fits there and the next, in the global
    scratch; 96 seeds in falling distance order: one counted launch; its
    int8 dots are exact, so the beams are the plain version's (equal
    stats); the rerank's fp32 dots differ in the last bits."""
    from turdb_tpu_torch.models.hnsw_serve import pack_serving
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(34)
    x, norms, adj = _graph(g, 6000, 64, 32, cuda)
    pack = pack_serving(x, norms, adj, 6000, Metric.L2)
    q = (x[:32] + 0.5 * torch.randn(32, 64, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    seeds = torch.rand(32, 6000, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    seed_d = torch.arange(16, device=cuda, dtype=torch.float32).expand(32, 16).contiguous()
    allowed = torch.rand(6000, device=cuda, generator=g) < 0.6
    atol = 1e-5 * float(qn.max() + norms.max())
    # the widest ef whose state (with the rerank of all ef) fits shared
    # memory beside the stage, and the next, in the global scratch
    ef_lo = next(ef for ef in range(2500, 8000, 4)
                 if kernels.serve_wide_stage(32, ef + 4, (ef + 4) * 3 // 2, 4, ef + 4, 64)[0])
    # and 96 seeds in falling distance order, whose ranks cross warps
    many = torch.rand(32, 6000, device=cuda, generator=g).topk(96).indices.to(torch.int32)
    many_d = torch.arange(95, -1, -1, device=cuda, dtype=torch.float32).expand(32, 96).contiguous()
    cases = [(metric, 1500, rerank, allow, seeds, seed_d) for metric in (0, 1, 2)
             for rerank, allow in ((0, None), (1100, allowed))]
    cases += [(0, ef, 0, None, seeds, seed_d) for ef in (ef_lo, ef_lo + 4)]
    cases += [(0, 1500, rerank, allow, many, many_d) for rerank, allow in ((0, None), (1100, allowed))]
    for metric, ef, rerank, allow, s_i, s_d in cases:
        args = (pack.nbr_codes, pack.nbr_meta, x, norms, q, qn, qc, qs, qsum, s_i, s_d, allow)
        opts = dict(ef=ef, iters=ef * 3 // 2, expand=4, rerank=rerank, k=100, metric=metric)
        before = kernels.launches["hnsw_serve_beam_wide"]
        dk, ik, sk = kernels.hnsw_serve_beam(*args, **opts)
        assert kernels.launches["hnsw_serve_beam_wide"] == before + 1
        dp, ip, sp = kernels.hnsw_serve_beam_plain(*args, **opts)
        assert torch.equal(sk, sp)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=atol)
        assert (ik == ip).float().mean() >= 0.999


@pytest.mark.parametrize("route, d, ef", [("nodes", 2048, 1100), ("global", 384, 3500),
                                         ("rows", 8192, 1100), ("words", 36, 1500)])
def test_serve_beam_wide_stage_routes_match_plain(cuda, route, d, ef):
    """K6 wide's stage where a step's blocks do not all fit: two of its four
    nodes a batch (2,048-d), the state in the global scratch beside a whole
    step's stage (ef 3,500), and rows of one node a batch with the state in
    the global scratch (8,192-d, a node's block past shared memory); and
    rows of 36 bytes, copied by 4-byte cp.async and scored a 4-byte word a
    lane: one counted launch, the plain version's beam work, distances
    within DOT_RTOL, ids equal but at near ties."""
    from turdb_tpu_torch.models.hnsw_serve import pack_serving
    from turdb_tpu_torch.ops.distance import Metric
    from turdb_tpu_torch.ops.quantize import quantize_queries

    g = torch.Generator(device=cuda).manual_seed(36)
    n = 1500 if d > 1024 else 6000
    x, norms, adj = _graph(g, n, d, 32, cuda)
    glob, rows = kernels.serve_wide_stage(32, ef, ef * 3 // 2, 4, ef, d)
    assert (glob, rows) == {"nodes": (False, 64), "global": (True, 128),
                            "rows": (True, 27), "words": (False, 128)}[route]
    pack = pack_serving(x, norms, adj, n, Metric.L2)
    q = (x[:4] + 0.5 * torch.randn(4, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    qc, qs, qsum = quantize_queries(q)
    seeds = torch.rand(4, n, device=cuda, generator=g).topk(16).indices.to(torch.int32)
    seed_d = torch.arange(16, device=cuda, dtype=torch.float32).expand(4, 16).contiguous()
    args = (pack.nbr_codes, pack.nbr_meta, x, norms, q, qn, qc, qs, qsum, seeds, seed_d, None)
    opts = dict(ef=ef, iters=ef * 3 // 2, expand=4, rerank=0, k=200, metric=0)
    before = kernels.launches["hnsw_serve_beam_wide"]
    dk, ik, sk = kernels.hnsw_serve_beam(*args, **opts)
    assert kernels.launches["hnsw_serve_beam_wide"] == before + 1
    dp, ip, sp = kernels.hnsw_serve_beam_plain(*args, **opts)
    assert torch.equal(sk, sp)
    _assert_near(dk, ik, dp, ip, 1e-5 * float(qn.max() + norms.max()), 0.99)


@pytest.mark.parametrize("b", [1, 256, 513])
def test_greedy_wide_batches_and_levels_match_plain(cuda, b):
    """K9 wide at 4,608-d, a block a query: B = 1, 256 and 513 queries over
    the f32 rows and the SQ8 / SQ16 store, three levels in one launch, each
    query down to its own lowest level (some walk none): one counted launch,
    the plain chain's ends (distances within DOT_RTOL of their scale, ids
    apart only at near ties) and its work where the ends agree."""
    g = torch.Generator(device=cuda).manual_seed(37 + b)
    n, d = 3000, 4608
    centers = torch.randn(24, d, device=cuda, generator=g)
    x = (centers[torch.randint(0, 24, (n,), device=cuda, generator=g)]
         + 0.6 * torch.randn(n, d, device=cuda, generator=g)).contiguous()
    norms = (x * x).sum(1)
    adjs = [torch.randint(0, n, (n, 16), device=cuda, generator=g, dtype=torch.int32)
            for _ in range(3)]
    for a in adjs:
        a[torch.rand(n, 16, device=cuda, generator=g) < 0.05] = -1
    q = (x[torch.randint(0, n, (b,), device=cuda, generator=g)]
         + 0.6 * torch.randn(b, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    cur = torch.randint(0, n, (b,), device=cuda, generator=g, dtype=torch.int32)
    lowest = torch.randint(0, 4, (b,), device=cuda, generator=g, dtype=torch.int32)
    lowest[0] = 0
    for name, rows in _sq_stores(x):
        cd = kernels._gathered_epilogue((q * rows[cur.long()]).sum(1), 0, qn,
                                        norms[cur.long()]).contiguous()
        args = (adjs, rows, norms, q, qn, cur, cd)
        before = kernels.launches["hnsw_greedy_wide"]
        ki, kd, ks = kernels.hnsw_greedy(*args, metric=0, lowest=lowest)
        assert kernels.launches["hnsw_greedy_wide"] == before + 1
        pi, pd, ps = kernels.hnsw_greedy_plain(*args, metric=0, lowest=lowest)
        _assert_near(kd[:, None], ki[:, None], pd[:, None], pi[:, None],
                     1e-5 * float(pd.abs().max()), 0.99)
        same = ki == pi
        assert torch.equal(ks[same], ps[same]), name
        assert int(ps[:, 0].max()) > 1, name


def test_greedy_wide_form_matches_plain(cuda):
    """K9 on rows past DIM_MAX (d = 4,100) over the f32 rows and the SQ8 /
    SQ16 store, three levels in one launch: one counted launch a call, each
    neighbour's sum in warp_dot's order (4-byte code words where an SQ8 row
    of 4,100 codes is no whole 16-byte words), so the plain version's ends
    (distances within 1e-5 of their scale, ids equal on 99 %)."""
    g = torch.Generator(device=cuda).manual_seed(35)
    n, d = 3000, 4100
    x = torch.randn(n, d, device=cuda, generator=g)
    norms = (x * x).sum(1)
    adjs = [torch.randint(0, n, (n, 16), device=cuda, generator=g, dtype=torch.int32)
            for _ in range(3)]
    q = (x[:64] + 0.5 * torch.randn(64, d, device=cuda, generator=g)).contiguous()
    qn = (q * q).sum(1)
    cur = torch.randint(0, n, (64,), device=cuda, generator=g, dtype=torch.int32)
    for name, rows in _sq_stores(x):
        cd = kernels._gathered_epilogue((q * rows[cur.long()]).sum(1), 0, qn,
                                        norms[cur.long()]).contiguous()
        before = kernels.launches["hnsw_greedy_wide"]
        ki, kd, ks = kernels.hnsw_greedy(adjs, rows, norms, q, qn, cur, cd, metric=0)
        assert kernels.launches["hnsw_greedy_wide"] == before + 1
        pi, pd, ps = kernels.hnsw_greedy_plain(adjs, rows, norms, q, qn, cur, cd, metric=0)
        torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-5 * float(pd.abs().max()))
        assert (ki == pi).float().mean() >= 0.99, name


@pytest.mark.parametrize("w, d", [(300, 128), (128, 384), (64, 768)])
def test_select_wide_form_matches_plain(cuda, w, d):
    """K7 and its presorted mode past the fast form's widths: W = 300 (past
    SELECT_W_MAX) and the bulk build's W·d·4 = 196,608 bytes of rows at d =
    384 (upper levels, W = 8 x 16) and d = 768 (level 0, W = 2 x 32), every
    metric, alpha 1.0 and 1.2: one counted launch a call; rows equal the
    plain version's on >= 98 % (the rest at near ties of the fp32 dots),
    their distances within DOT_RTOL of the distance scale (the L2
    epilogue cancels norms of 2 x 10^4 at d = 768), n_pairs with them."""
    g = torch.Generator(device=cuda).manual_seed(36)
    x, _, adj = _graph(g, 6000, d, 32, cuda)
    targets = torch.randperm(6000, device=cuda, generator=g)[:400].to(torch.int32)
    cand = torch.randint(0, 6000, (400, w), device=cuda, generator=g, dtype=torch.int32)
    cand[:, :32] = adj[targets.long()]
    cand[:, w // 2] = cand[:, 7]
    cand[:, w - 1] = targets
    cand[::5, w - w // 4:] = -1
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=cuda), -1)
    drop = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, -1)
            | (cand == targets[:, None]) | (cand < 0))
    for metric in (0, 1, 2):
        xm = (x / x.norm(dim=1, keepdim=True) if metric == 1 else x).contiguous()
        nm = (xm * xm).sum(1)
        atol = DOT_RTOL * float(2 * nm.max())
        sd = kernels._gathered_epilogue(torch.einsum("ud,uwd->uw", xm[targets.long()],
                                                     xm[cand.clamp_min(0).long()]),
                                        metric, nm[targets.long()][:, None],
                                        nm[cand.clamp_min(0).long()])
        sd, order = torch.where(drop, float("inf"), sd).sort(dim=1, stable=True)
        cs = torch.gather(torch.where(drop, -1, cand), 1, order).contiguous()
        for alpha in (1.0, 1.2):
            for name, fn, plain, args in (
                    ("hnsw_select", kernels.hnsw_select, kernels.hnsw_select_plain,
                     (xm, nm, targets, cand)),
                    ("hnsw_select_sorted", kernels.hnsw_select_sorted,
                     kernels.hnsw_select_sorted_plain, (xm, cs, sd.contiguous()))):
                before = kernels.launches[name + "_wide"]
                ki, kd, kp = fn(*args, deg=32, metric=metric, alpha=alpha)
                assert kernels.launches[name + "_wide"] == before + 1
                pi, pd, pp = plain(*args, deg=32, metric=metric, alpha=alpha)
                same = (ki == pi).all(1)
                assert same.float().mean() >= 0.98, (name, metric, alpha)
                torch.testing.assert_close(kd[same], pd[same], rtol=DOT_RTOL, atol=atol)
                assert (kp[same] == pp[same]).float().mean() >= 0.99, (name, metric, alpha)


# ---------------------------------------------------------------------------
# the redesigned wide forms: K1 wide's distance pass and dedup tail
# (csrc/probe_wide.cu), K7 wide's cluster form (csrc/hnsw_select_wide.cu)
# ---------------------------------------------------------------------------

def _f32_probe(cuda, seed, p, lcap, d, n_ids, b=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    pvecs, pnorms, members, alive, allowed = _store(g, 300, lcap, d, n_ids, cuda)
    q = torch.randn(b, d, device=cuda, generator=g)
    cells = torch.rand(b, 300, device=cuda, generator=g).topk(p).indices.to(torch.int32)
    return q, (q * q).sum(1), cells, pvecs, pnorms, members, alive, allowed


def _probe_wide_f32(q, qn, cells, pvecs, pnorms, members, alive, allowed, *, metric, k, m,
                    replicated, mode):
    """K1's wide form at any m: the distance pass, K2, the tail (the wide
    tail past SEL_MAX, the fast one below)."""
    b, p = cells.shape
    nb, lcap, d = pvecs.shape
    return kernels._probe_wide("ivf_probe_f32", lambda s, e, dist: (
        q[s:].data_ptr(), qn[s:].data_ptr(), cells[s:].data_ptr(), e - s, p, pvecs.data_ptr(),
        pnorms.data_ptr(), members.data_ptr(), kernels._ptr(kernels._as_u8(alive)),
        kernels._ptr(kernels._as_u8(allowed)), lcap, d, metric, dist.data_ptr()),
        cells, members, k, m, replicated, mode)


@pytest.mark.parametrize("d", [64, 384])
def test_probe_wide_distance_pass_is_the_fast_forms_bit_for_bit(cuda, d):
    """K1 wide's distance pass sums each row in K1's order (a fmaf chain a
    lane over float4 lane, lane + 32, ..., the rows' sums meeting in
    reduce_rows), as K1's fast form and the earlier wide pass did: at m <= 2048,
    where the fast form also runs, the wide form's outputs (the fast tail)
    equal the fast form's bit for bit, every metric, with `allowed`, in
    both modes."""
    q, qn, cells, pvecs, pnorms, members, alive, allowed = _f32_probe(cuda, 40, 16, 128, d, 3000)
    for metric in (0, 1, 2):
        for mode, k, m in ((kernels.MODE_TOPK, 1000, 2000), (kernels.MODE_CAND, 2000, 2000)):
            for allow in (None, allowed):
                args = (q, qn, cells, pvecs, pnorms, members, alive, allow)
                kw = dict(metric=metric, k=k, m=m, replicated=True, mode=mode)
                fast = kernels.ivf_probe_f32(*args, **kw)
                wide = _probe_wide_f32(*args, **kw)
                for a, b in zip(fast, wide):
                    assert torch.equal(a, b), (metric, mode, allow is None)


@pytest.mark.parametrize("m", [4800, 9000])
def test_probe_tail_wide_dedup_is_mask_duplicates_exactly(cuda, m):
    """The wide tail's claim-table dedup and prefix-count compaction: the
    top-k mode's outputs are mask_duplicates (the first copy of an id
    wins) and a stable top-k over the candidate mode's m winners, bit for
    bit, with many repeated ids, k below and above the survivors, +inf
    lanes; m = 4,800 (the SQL LIMIT 600 call's) holds a row's winners in
    shared memory, m = 9,000 takes the global scratch. One counted launch
    a call."""
    q, qn, cells, pvecs, pnorms, members, alive, allowed = _f32_probe(cuda, 41, 96, 128,
                                                                       64, 2500)
    assert (kernels.build.library().ivf_probe_tail_wide_words(m, 1, kernels.MODE_TOPK) == 0) \
        == (m == 4800)
    args = (q, qn, cells, pvecs, pnorms, members, alive, allowed)
    cd, ci, _ = kernels.ivf_probe_f32(*args, metric=0, k=m, m=m, replicated=True,
                                      mode=kernels.MODE_CAND)
    assert bool(torch.isinf(cd).any()) and bool(torch.isfinite(cd).any())
    i0, d0 = kernels.mask_duplicates(ci, cd)
    survivors = torch.isfinite(d0).sum(1)
    for k in (m // 8, m // 2):
        before = kernels.launches["ivf_probe_f32_wide"]
        dk, ik = kernels.ivf_probe_f32(*args, metric=0, k=k, m=m, replicated=True)
        assert kernels.launches["ivf_probe_f32_wide"] == before + 1
        want_d, pos = kernels.topk_rows_plain(d0, k)
        want_i = torch.where(torch.isinf(want_d), -1, torch.gather(i0, 1, pos.long()))
        assert torch.equal(dk, want_d) and torch.equal(ik, want_i), k
        if k == m // 2:
            assert bool((survivors < k).any())     # padded rows


def _chip_smoke():
    """chip_smoke.py at the repository's root, for the checks it shares with
    these tests."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _select_case(cuda, seed, n, w, d, u):
    """Targets and W candidates with duplicates, -1 and the target itself."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x, _, adj = _graph(g, n, d, 32, cuda)
    targets = torch.randperm(n, device=cuda, generator=g)[:u].to(torch.int32)
    cand = torch.randint(0, n, (u, w), device=cuda, generator=g, dtype=torch.int32)
    cand[:, :32] = adj[targets.long()]
    cand[:, w // 2] = cand[:, 7]
    cand[:, w - 1] = targets
    cand[::5, w - w // 4:] = -1
    return x, targets, cand


def _sorted_inputs(xm, nm, targets, cand, metric):
    """The presorted mode's inputs: the candidates deduplicated and sorted
    by their distance to the target, as a beam's buffer arrives."""
    w = cand.shape[1]
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=cand.device), -1)
    drop = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, -1)
            | (cand == targets[:, None]) | (cand < 0))
    sd = kernels._gathered_epilogue(torch.einsum("ud,uwd->uw", xm[targets.long()],
                                                 xm[cand.clamp_min(0).long()]),
                                    metric, nm[targets.long()][:, None],
                                    nm[cand.clamp_min(0).long()])
    sd, order = torch.where(drop, float("inf"), sd).sort(dim=1, stable=True)
    return torch.gather(torch.where(drop, -1, cand), 1, order).contiguous(), sd.contiguous()


@pytest.mark.parametrize("w, d", [(128, 384), (64, 768), (100, 768), (300, 128)])
def test_select_cluster_form_is_the_global_forms_bit_for_bit(cuda, w, d, monkeypatch):
    """K7's cluster form keeps the global form's arithmetic (the wide
    form's first design: every dot in warp_dot's order, the same epilogues): at the bulk
    build's windows (W = 128 at d = 384, W = 64 at d = 768), the waves'
    (W = 100 at d = 768) and W = 300, forced through the cluster form at
    every CTA count from the one its route picks to 4 (W = 128 splits 43 /
    43 / 42 over 3) and through the global form, ids, distances and
    n_pairs are equal bit for bit, both modes, every metric, alpha 1.0 and
    1.2; each call one counted launch of the wide form."""
    x, targets, cand = _select_case(cuda, 50, 3000, w, d, 96)
    least = kernels.select_wide_ctas(w, d, False)
    assert 1 <= least <= 2
    for metric in (0, 1, 2):
        xm = (x / x.norm(dim=1, keepdim=True) if metric == 1 else x).contiguous()
        nm = (xm * xm).sum(1)
        cs, sd = _sorted_inputs(xm, nm, targets, cand, metric)
        for alpha in (1.0, 1.2):
            for name, fn, args in (("hnsw_select", kernels.hnsw_select, (xm, nm, targets, cand)),
                                   ("hnsw_select_sorted", kernels.hnsw_select_sorted,
                                    (xm, cs, sd))):
                kw = dict(deg=32 if metric else 16, metric=metric, alpha=alpha)
                outs = {}
                for ctas in (0, *range(least, 5)):
                    with monkeypatch.context() as mp:
                        mp.setattr(kernels, "select_wide_ctas", lambda w_, d_, s_, c=ctas: c)
                        before = kernels.launches[name + "_wide"]
                        outs[ctas] = fn(*args, **kw)
                        assert kernels.launches[name + "_wide"] == before + 1
                for ctas, got in outs.items():
                    for a, b in zip(got, outs[0]):
                        assert torch.equal(a, b), (name, metric, alpha, ctas)


@pytest.mark.parametrize("w, d, route", [(128, 384, "one"), (64, 768, "one"),
                                         (100, 768, "cluster"), (100, 4608, "non-portable"),
                                         (300, 4100, "global")])
def test_select_wide_routes_by_shape(cuda, w, d, route):
    """The wide form's route at the bulk build's windows (196,608 B: one
    CTA of 227 KB a target), K7s' wave window (307,200 B: two CTAs), a
    window that needs a non-portable cluster (W 100 x 4,608-d: more than 8
    CTAs) and one past 16 CTAs, which keeps the global scratch: the route
    `select_wide_ctas` picks, then both modes against their plain versions
    as chip_smoke's wide_check holds them (rows equal on >= 98 %, and every
    row that differs in its ids or n_pairs has a decision within 4x the
    fp32 disagreement of an fp64 tie), one counted launch a call."""
    ctas = kernels.select_wide_ctas(w, d + (-d % 4), False)
    want = {"one": ctas == 1, "cluster": 2 <= ctas <= 8, "non-portable": 8 < ctas <= 16,
            "global": ctas == 0}
    assert want[route], ctas
    x, targets, cand = _select_case(cuda, 51, 1500 if d > 1000 else 4000, w, d, u=256)
    nm = (x * x).sum(1)
    cs, sd = _sorted_inputs(x, nm, targets, cand, 0)
    kw = dict(deg=16, metric=0, alpha=1.2)
    for name, fn, plain, args in (
            ("hnsw_select", kernels.hnsw_select, kernels.hnsw_select_plain, (x, nm, targets, cand)),
            ("hnsw_select_sorted", kernels.hnsw_select_sorted, kernels.hnsw_select_sorted_plain,
             (x, cs, sd))):
        before = kernels.launches[name + "_wide"]
        got = fn(*args, **kw)
        assert kernels.launches[name + "_wide"] == before + 1
        want = plain(*args, **kw)
        row = _chip_smoke()._select_agreement(name, got, want, args, kw)
        assert (row["ctas"] == 0) == (route == "global"), (name, row["ctas"])
        same = (got[0] == want[0]).all(1)
        torch.testing.assert_close(got[1][same], want[1][same], rtol=DOT_RTOL,
                                   atol=DOT_RTOL * float(2 * nm.max()))


def _cell_select_plain64(q, qn, cents, cn):
    """K12's yardstick: the fp64 product and K2's epilogue in fp64, sorted
    stably: ([B, C] distances ascending, [B, C] positions)."""
    dist = (qn.double()[:, None] + cn.double()[None, :]) - 2.0 * (q.double() @ cents.double().T)
    return torch.sort(dist, dim=1, stable=True)


def _assert_cells(dk, ik, q, qn, cents, cn, p):
    """K12 against the fp64 plain version: the chosen cells equal where the
    p-th and (p+1)-th plain distances are more than 1e-6 apart (relative);
    each distance that of its cell within fp32 rounding (DOT_RTOL of the
    norms' sum); ascending; +inf cells only after every finite one, and
    those the lowest positions."""
    sd, si = _cell_select_plain64(q, qn, cents, cn)
    c = cents.shape[0]
    assert dk.shape == ik.shape == (q.shape[0], p)
    assert bool((ik >= 0).all()) and bool((ik < c).all())
    assert bool((dk[:, 1:] >= dk[:, :-1]).all())
    exact = torch.gather((qn.double()[:, None] + cn.double()[None, :])
                         - 2.0 * (q.double() @ cents.double().T), 1, ik.long())
    scale = qn.double()[:, None] + torch.where(torch.isinf(cn), 0.0, cn.double())[ik.long()]
    fin = torch.isfinite(exact)
    assert torch.equal(fin, torch.isfinite(dk))
    assert bool(((dk.double() - exact).abs() <= DOT_RTOL * scale)[fin].all())
    if p < c:
        kth, nxt = sd[:, p - 1], sd[:, p]
        clear = (nxt - kth).abs() > 1e-6 * kth.abs().clamp_min(1e-30)
        clear &= torch.isfinite(kth)
        same = torch.sort(ik.long(), 1).values == torch.sort(si[:, :p], 1).values
        assert bool(same.all(1)[clear].all()), int((~same.all(1) & clear).sum())
    # +inf cells: after the finite ones, by position, as K2 ranks them
    n_fin = int(torch.isfinite(cn).sum())
    if n_fin < p:
        assert torch.equal(ik[:, n_fin:], si[:, n_fin:p].to(torch.int32))


@pytest.mark.parametrize("b", [1, 7, 129, 4096])
@pytest.mark.parametrize("c", [64, 3906, 20_000])
def test_cell_select_matches_plain(cuda, b, c):
    """K12 at every d and P the main paths use (P up to the kernel's
    limit), at any batch (below CELLSEL_B_MIN `cell_select` keeps the
    pair; `cell_select_kernel` launches K12 there too): one launch a call,
    the segments merged inside it."""
    g = torch.Generator(device=cuda).manual_seed(b * 7 + c)
    for d in (128, 96, 36):     # 36: a last chunk of 4 dims
        q = torch.randn(b, d, device=cuda, generator=g) * 4
        cents = torch.randn(c, d, device=cuda, generator=g) * 4
        qn, cn = (q * q).sum(1), (cents * cents).sum(1)
        for p in (1, 2, 5, 8, kernels.CELLSEL_P_MAX):
            if p > c:
                continue
            plan = kernels.cell_select_plan(b, c, d, p, kernels._sm_count(q.device))
            assert plan is not None
            before = kernels.launches["cell_select"]
            dk, ik = kernels.cell_select_kernel(q, qn, cents, cn, p)
            assert kernels.launches["cell_select"] == before + 1
            _assert_cells(dk, ik, q, qn, cents, cn, p)
            assert b > 16 or plan[1] > 1 or c <= kernels.CELLSEL_TC   # small batches split


@pytest.mark.parametrize("b, c, p", [(1, 20_000, 8), (129, 3906, 5), (4096, 20_000, 32)])
def test_cell_select_ties_and_infinite_cells(cuda, b, c, p):
    """Duplicate centroids give bit-equal distances: the lower position is
    taken first, within a tile, across tiles and across segments; +inf
    cnorms (pad or empty cells) rank after every finite cell, and where
    fewer than P are finite, by position."""
    g = torch.Generator(device=cuda).manual_seed(c + p)
    half = c // 2
    q = torch.randn(b, 128, device=cuda, generator=g) * 4
    base = torch.randn(half, 128, device=cuda, generator=g) * 4
    cents = torch.cat([base, base])                  # column j + half copies column j
    qn, cn = (q * q).sum(1), (cents * cents).sum(1)
    dk, ik = kernels.cell_select_kernel(q, qn, cents, cn, p)
    _assert_cells(dk, ik, q, qn, cents, cn, p)
    ids = ik.long()
    hi = ids >= half
    rank = torch.arange(p, device=cuda).expand_as(ids)
    for r in range(b):
        pos = {int(v): int(k) for v, k in zip(ids[r], rank[r])}
        for v in ids[r][hi[r]].tolist():
            assert pos.get(v - half, p) < pos[v], (r, v)
    # +inf cells: most of them; where fewer than P are finite, the lowest
    # positions of the +inf cells fill the row
    cn_inf = cn.clone()
    cn_inf[p // 2:] = float("inf")
    dk, ik = kernels.cell_select_kernel(q, qn, cents, cn_inf, p)
    _assert_cells(dk, ik, q, qn, cents, cn_inf, p)
    assert torch.equal(ik[:, p // 2:], torch.arange(p // 2, p, device=cuda,
                                                      dtype=torch.int32).expand(b, -1))


def test_cell_select_routes_and_sizes(cuda):
    """The plan's shared memory is the library's; wide P, d past the
    kernel's or no multiple of 4, and a batch under CELLSEL_B_MIN keep the
    GEMM + K2 pair (no K12 launch), and agree with it; the IVF search at a
    batch of CELLSEL_B_MIN takes K12, the SQL path's single query the
    pair."""
    lib = kernels.build.library()
    for mi in (1, 2, 4, 8):
        for d in (96, 128, 256):
            assert kernels.cell_select_smem(mi, d) == lib.cell_select_smem(mi, d)
    g = torch.Generator(device=cuda).manual_seed(5)
    for b, d, p in ((2048, 128, 64), (2048, 384, 8), (2048, 130, 8), (33, 128, 8)):
        q = torch.randn(b, d, device=cuda, generator=g)
        cents = torch.randn(500, d, device=cuda, generator=g)
        qn, cn = (q * q).sum(1), (cents * cents).sum(1)
        assert not kernels.cell_select_fused(cuda, b, 500, d, p)
        before = kernels.launches["cell_select"]
        got = kernels.cell_select(q, qn, cents, cn, p)
        assert kernels.launches["cell_select"] == before
        want = kernels.topk_rows(q @ cents.T, p, rown=qn, coln=cn, epilogue=kernels.EPI_L2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    pool = make_pool(np.random.default_rng(1), 20_000 + kernels.CELLSEL_B_MIN, 32,
                     n_clusters=64)
    idx = IvfIndex(dim=32, device=cuda)
    idx.add(pool[:20_000])
    before = kernels.launches["cell_select"]
    idx.search(pool[20_000:], k=10, nprobe=8)
    assert kernels.launches["cell_select"] == before + 1
    idx.search(pool[20_000:20_001], k=10, nprobe=8)
    assert kernels.launches["cell_select"] == before + 1
