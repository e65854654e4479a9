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
    """A width past a kernel's limits comes back from the C entry point as
    an error and raises; the next launch is not charged with it."""
    x = torch.randn(4, 1000, device=cuda)
    with pytest.raises(RuntimeError):
        kernels.topk_rows(x, 300)                     # k past the selection width
    c, lcap, d = 64, 8192, 4                          # P*L keys past shared memory
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
