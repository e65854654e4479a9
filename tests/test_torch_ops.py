"""Port ops vs the JAX reference: distances, exact top-k with planted
ties, dedup / membership, the kernels' plain versions, and the package
guards (no jax import, CPU wrappers never count a launch, chip_smoke.py
refuses to run without CUDA)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turdb_tpu.ops import distance as jd
from turdb_tpu.ops import topk as jt
from turdb_tpu_torch import kernels
from turdb_tpu_torch.ops import distance as td
from turdb_tpu_torch.ops import quantize as tq
from turdb_tpu_torch.ops import topk as tt

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-3   # fp32 dot products summed in another order


def _data(seed, b=24, n=300, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32) * 2,
            rng.standard_normal((n, d)).astype(np.float32) * 2)


@pytest.mark.parametrize("name", ["L2", "COSINE", "IP"])
def test_pairwise_gathered_self_distances(name):
    q, x = _data(1)
    if name == "COSINE":
        q = np.asarray(jd.normalize_rows(jnp.asarray(q)))
        x = np.asarray(jd.normalize_rows(jnp.asarray(x)))
    jm, tm = jd.Metric[name], td.Metric[name]
    want = np.asarray(jd.pairwise_distances(jnp.asarray(q), jnp.asarray(x), jm))
    got = td.pairwise_distances(torch.from_numpy(q), torch.from_numpy(x), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    vecs = x[:96].reshape(24, 4, 16)
    want = np.asarray(jd.gathered_distances(jnp.asarray(q), jnp.asarray(vecs), jm))
    got = td.gathered_distances(torch.from_numpy(q), torch.from_numpy(vecs), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jd.self_distances(jnp.asarray(x[:50]), jm))
    got = td.self_distances(torch.from_numpy(x[:50]), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_norms_and_metric_enum():
    q, _ = _data(2)
    np.testing.assert_allclose(td.prep_norms(torch.from_numpy(q)).numpy(),
                               np.asarray(jd.prep_norms(jnp.asarray(q))), rtol=1e-6)
    np.testing.assert_allclose(td.normalize_rows(torch.from_numpy(q)).numpy(),
                               np.asarray(jd.normalize_rows(jnp.asarray(q))), rtol=1e-6)
    for m in jd.Metric:
        assert td.Metric[m.name].value == m.value
    for name in ("l2", "euclidean", "cosine", "ip", "dot", "inner_product"):
        assert td.Metric.from_name(name).value == jd.Metric.from_name(name).value


def _tied(rng, b, n):
    """Small integers: every value repeats, so exact ties are everywhere;
    a few +inf lanes make ties at the tail too."""
    d = rng.integers(0, 40, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.1] = np.inf
    return d


@pytest.mark.parametrize("n,k", [(300, 7), (300, 250), (2048, 64)])
def test_topk_smallest_planted_ties(n, k):
    rng = np.random.default_rng(n + k)
    d = _tied(rng, 8, n)
    ids = rng.permutation(8 * n).reshape(8, n).astype(np.int32)
    wd, wi = jt.topk_smallest(jnp.asarray(d), jnp.asarray(ids), k)
    gd, gi = tt.topk_smallest(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("n,k", [(4096, 10), (24576, 64)])
def test_topk_smallest_wide_planted_ties(n, k):
    """Exact ties planted as adjacent pairs (same bucket of the reference's
    two-level selector), where both selectors must prefer the lower index."""
    rng = np.random.default_rng(n)
    base = np.stack([rng.permutation(n // 2) for _ in range(4)]).astype(np.float32)
    d = np.repeat(base, 2, axis=1)
    wd, wp = jt.topk_smallest_wide(jnp.asarray(d), k)
    gd, gp = tt.topk_smallest_wide(torch.from_numpy(d), k)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # the wide path of topk_smallest (rows > 2048 lanes) agrees as well
    ids = np.arange(4 * n, dtype=np.int32).reshape(4, n)
    _, wi = jt.topk_smallest(jnp.asarray(d), jnp.asarray(ids), k)
    _, gi = tt.topk_smallest(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_merge_topk_parity():
    rng = np.random.default_rng(3)
    da, db = _tied(rng, 6, 10), _tied(rng, 6, 10)
    da.sort(1)
    db.sort(1)
    ia = rng.integers(0, 100, (6, 10)).astype(np.int32)
    ib = rng.integers(0, 100, (6, 10)).astype(np.int32)
    want = jt.merge_topk(*map(jnp.asarray, (da, ia, db, ib)), 10)
    got = tt.merge_topk(*map(torch.from_numpy, (da, ia, db, ib)), 10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mask_duplicates_and_member_mask_parity():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 12, (5, 30)).astype(np.int32)
    d = rng.standard_normal((5, 30)).astype(np.float32)
    wi, wd = jt.mask_duplicates(jnp.asarray(ids), jnp.asarray(d))
    gi, gd = tt.mask_duplicates(torch.from_numpy(ids), torch.from_numpy(d))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    table = rng.integers(-1, 12, (5, 7)).astype(np.int32)
    want = jt.member_mask(jnp.asarray(ids), jnp.asarray(table))
    got = tt.member_mask(torch.from_numpy(ids), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,clamp", [("L2", True), ("L2", False), ("COSINE", False),
                                        ("IP", False)])
def test_topk_rows_epilogues_match_reference(name, clamp):
    """K2's plain version with a fused epilogue + valid mask selects what
    the reference's distance + where + lax.top_k selects."""
    q, x = _data(5, n=700)
    rng = np.random.default_rng(5)
    valid = rng.random(700) < 0.8
    jm = jd.Metric[name]
    qn, xn = (q * q).sum(1), (x * x).sum(1)
    if name == "L2":
        dots = np.asarray(jax.lax.dot_general(
            jnp.asarray(q), jnp.asarray(x), (((1,), (1,)), ((), ())),
            precision=jd.PRECISE))
        full = qn[:, None] + xn[None, :] - 2.0 * dots
        want = np.maximum(full, 0.0) if clamp else full
    else:
        want = np.asarray(jd.pairwise_distances(jnp.asarray(q), jnp.asarray(x), jm))
        dots = q @ x.T
    want = np.where(valid[None, :], want, np.inf)
    nd, wi = jax.lax.top_k(-jnp.asarray(want), 20)
    gd, gi = kernels.topk_rows(
        torch.from_numpy(np.ascontiguousarray(dots, np.float32)), 20,
        rown=torch.from_numpy(qn), coln=torch.from_numpy(xn),
        colvalid=torch.from_numpy(valid), epilogue=jm.value + kernels.EPI_L2,
        clamp=clamp)
    np.testing.assert_allclose(gd.numpy(), -np.asarray(nd), rtol=RTOL, atol=ATOL)
    assert np.mean(gi.numpy() == np.asarray(wi)) >= 0.99


def test_cpu_wrappers_leave_launch_counters_at_zero():
    kernels.reset_launches()
    q, x = _data(6)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    kernels.topk_rows(qt @ xt.T, 5)
    kernels.kmeans_assign(qt, xt, td.prep_norms(qt), td.prep_norms(xt), 2)
    cells = torch.zeros((24, 1), dtype=torch.int32)
    pv = xt[:32].reshape(4, 8, 16).contiguous()
    kernels.ivf_probe_f32(qt, td.prep_norms(qt), cells, pv, td.prep_norms(pv),
                          torch.arange(32, dtype=torch.int32).reshape(4, 8),
                          torch.ones((4, 8), dtype=torch.bool), None,
                          metric=0, k=3, m=3, replicated=False)
    members = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    alive = torch.ones((4, 8), dtype=torch.bool)
    c8, mins, scales, _ = tq.sq8_store(xt[:32])
    qc, qs, qsum = tq.quantize_queries(qt)
    cd, ci, cpos = kernels.ivf_probe_sq8(
        qc, qs, qsum, td.prep_norms(qt), cells, c8.reshape(4, 8, 16),
        mins.reshape(4, 8), scales.reshape(4, 8), td.prep_norms(pv), members, alive,
        k=5, m=5, replicated=True, mode=kernels.MODE_CAND)
    kernels.ivf_rerank(qt, td.prep_norms(qt), cd, ci, cpos, pv, td.prep_norms(pv),
                       k=3, replicated=True)
    # the HNSW kernels: a ring graph over the 32 rows
    adj = ((torch.arange(32)[:, None] + torch.tensor([1, -1, 5, -5])) % 32).to(torch.int32)
    xn = td.prep_norms(xt[:32])
    seed_i = torch.zeros((24, 1), dtype=torch.int32)
    seed_d = (td.prep_norms(qt) + xn[0] - 2 * qt @ xt[0])[:, None]
    kernels.hnsw_graph_beam(adj, xt[:32].contiguous(), xn, qt, td.prep_norms(qt), seed_i,
                            seed_d, ef=8, iters=8, metric=0)
    kernels.hnsw_select(xt[:32].contiguous(), xn, torch.arange(4, dtype=torch.int32),
                        torch.arange(40, dtype=torch.int32).reshape(4, 10) % 32, deg=4,
                        metric=0, alpha=1.2)
    meta = torch.stack([mins, scales, xn], 1).view(torch.int32)
    meta = torch.cat([meta, torch.arange(32, dtype=torch.int32)[:, None]], 1)
    kernels.hnsw_serve_beam(c8[adj.long()], meta[adj.long()], xt[:32].contiguous(), xn, qt,
                            td.prep_norms(qt), qc, qs, qsum, seed_i, seed_d, ef=8, iters=8,
                            expand=2, rerank=0, k=3, metric=0)
    rows = tq.sq_rows_encode(xt[:32], 8)
    kernels.hnsw_graph_beam(adj, rows, xn, qt, td.prep_norms(qt), seed_i, seed_d, ef=8,
                               iters=8, metric=0)
    kernels.hnsw_greedy(adj, rows, xn, qt, td.prep_norms(qt), seed_i[:, 0], seed_d[:, 0],
                        metric=0)
    cand = torch.arange(40, dtype=torch.int32).reshape(4, 10) % 32
    kernels.hnsw_select_sorted(xt[:32].contiguous(), cand, torch.arange(40.0).reshape(4, 10),
                               deg=4, metric=0, alpha=1.0)
    kernels.topk_rows(qt @ xt.T, 4, cell_block=torch.arange(300, dtype=torch.int32) // 3, u=2)
    u8, m8, s8 = tq.sq8_encode(xt[:32])
    kernels.sq8_scan(qt, td.prep_norms(qt), qsum, u8, m8, s8,
                     torch.ones(32, dtype=torch.bool), 3)
    kernels.cell_select(qt, td.prep_norms(qt), xt, td.prep_norms(xt), 3)
    assert set(kernels.launches) == {"ivf_probe_f32", "topk_rows", "kmeans_assign",
                                     "ivf_probe_sq8", "ivf_rerank", "hnsw_serve_beam",
                                     "hnsw_select", "hnsw_graph_beam", "hnsw_select_sorted",
                                     "hnsw_graph_beam_sq", "hnsw_greedy", "dense_blocks",
                                     "sq8_scan", "cell_select", "topk_rows_wide",
                                     "ivf_probe_f32_wide",
                                     "ivf_probe_sq8_wide", "ivf_probe_sq8_wide_query",
                                     "ivf_rerank_wide", "hnsw_serve_beam_wide",
                                     "hnsw_select_wide", "hnsw_graph_beam_wide",
                                     "hnsw_select_sorted_wide", "hnsw_graph_beam_sq_wide",
                                     "hnsw_greedy_wide"}
    assert not any(kernels.launches.values()), kernels.launches


def test_wrappers_never_fall_back():
    """Tensors off the CPU and off CUDA (here: meta) are refused, as are
    mixed devices: the plain version runs only for CPU tensors, at any
    width. On CUDA no width routes to it: K2 and K11 take any k (and K11
    any d) in kernels of their own, and a width past what a fast kernel
    holds (m or r past SEL_MAX in the probes and the rerank, the beams past
    EF_MAX / SLOTS_MAX / EXP_MAX or DIM_MAX, K7 past SELECT_W_MAX /
    SELECT_SMEM_MAX, K9 past DIM_MAX) runs that kernel's wide form. A
    failed build or launch raises; nothing falls back after it. A k past
    the row still raises."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        kernels.topk_rows(x, 3)
    with pytest.raises(ValueError):
        kernels.kmeans_assign(x, torch.empty((8, 64)), torch.empty(4), torch.empty(8))
    with pytest.raises(ValueError):
        kernels.cell_select(x, torch.empty(4, device="meta"), torch.empty((8, 64), device="meta"),
                            torch.empty(8, device="meta"), 3)
    with pytest.raises(ValueError):
        kernels.topk_rows(torch.zeros((2, 8)), 9)   # k > N


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import turdb_tpu_torch\n"
        "for m in pkgutil.walk_packages(turdb_tpu_torch.__path__, 'turdb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'turdb_tpu.'))"
        " or k == 'turdb_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA here: chip_smoke.py exits non-zero with no result line, in
    the repository and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
