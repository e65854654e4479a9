"""Port ivf_search_impl on an exported JAX IvfState vs the reference's
own search: ids equal on every finite entry (except near ties), the same
number of +inf entries, distances within rtol 1e-4 — for L2, COSINE, IP,
with and without replicas, an `allowed` mask, C > 1024 and pad cells.
Plus the build pieces: assignment agreement and the build options."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_ivf

from turdb_tpu.models import ivf as jivf
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch.convert import ivf_state_from_numpy
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.ops.distance import Metric

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

DIM = 32


def _clustered(rng, n, d=DIM, c=32):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, c, n)] + rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """One reference index per metric (3000 x 32, 64 cells, replicas on)."""
    rng = np.random.default_rng(21)
    x = _clustered(rng, 3000)
    q = x[:48] + 0.05 * rng.standard_normal((48, DIM)).astype(np.float32)
    out = {}
    for name in ("L2", "COSINE", "IP"):
        idx = jivf.IvfIndex(dim=DIM, metric=JaxMetric[name], n_clusters=64, nprobe=8)
        idx.add(x)
        idx.train()
        out[name] = idx
    return out, q


def _both(state_np, cfg_np, jstate, jcfg, q, allowed=None, k=10, nprobe=8):
    want = jivf.ivf_search_impl(jstate, jnp.asarray(q),
                                None if allowed is None else jnp.asarray(allowed),
                                cfg=jcfg, k=k, nprobe=nprobe)
    state, cfg = ivf_state_from_numpy(state_np, cfg_np, "cpu")
    got = tivf.ivf_search_impl(state, torch.from_numpy(q),
                               None if allowed is None else torch.from_numpy(allowed),
                               cfg=cfg, k=k, nprobe=nprobe)
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    fin = np.isfinite(wd)
    # the port reports -1 for +inf entries; the reference leaves the lane's id
    assert (gi[~fin] == -1).all()
    assert_knn_match(wd, np.where(fin, wi, -1), gd, gi)
    return wd, gd


@pytest.mark.parametrize("name", ["L2", "COSINE", "IP"])
@pytest.mark.parametrize("replicated", [True, False])
def test_search_parity_on_exported_state(built, name, replicated):
    idxs, q = built
    idx = idxs[name]
    assert idx.cfg.replicated
    jcfg = dataclasses.replace(idx.cfg, replicated=replicated)
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if name == "COSINE" else q
    arrays, conf = export_ivf(idx.state, jcfg)
    _both(arrays, conf, idx.state, jcfg, qq.astype(np.float32))


def test_search_parity_with_allowed_mask(built):
    idxs, q = built
    idx = idxs["L2"]
    arrays, conf = export_ivf(idx.state, idx.cfg)
    allowed = np.random.default_rng(22).random(arrays["members"].shape) < 0.4
    wd, _ = _both(arrays, conf, idx.state, idx.cfg, q, allowed=allowed)
    assert np.isfinite(wd).any()


def test_search_parity_with_pad_cells(built):
    """A reference state carrying pad cells (cnorms +inf, members all -1):
    probing more cells than are real reaches them, and both sides report
    the same +inf entries."""
    idxs, q = built
    idx = idxs["L2"]
    arrays, conf = export_ivf(idx.state, idx.cfg)
    c, cap = arrays["members"].shape
    pad = 64
    padded = {
        "centroids": np.concatenate([arrays["centroids"], np.zeros((pad, DIM), np.float32)]),
        "cnorms": np.concatenate([arrays["cnorms"], np.full(pad, np.inf, np.float32)]),
        "members": np.concatenate([arrays["members"], np.full((pad, cap), -1, np.int32)]),
        "pvecs": np.concatenate([arrays["pvecs"], np.zeros((pad, cap, DIM), np.float32)]),
        "pnorms": np.concatenate([arrays["pnorms"], np.full((pad, cap), np.inf, np.float32)]),
        "alive": np.concatenate([arrays["alive"], np.zeros((pad, cap), bool)]),
    }
    jcfg = dataclasses.replace(idx.cfg, n_clusters=c + pad)
    jstate = idx.state._replace(**{k: jnp.asarray(v) for k, v in padded.items()})
    conf = dict(conf, n_clusters=c + pad)
    _both(padded, conf, jstate, jcfg, q, k=10, nprobe=c + 16)
    # only 6 visible lanes: the tail of every answer is +inf
    few = np.zeros((c + pad, cap), bool)
    mc, ml = np.nonzero(padded["members"] >= 0)
    few[mc[:6], ml[:6]] = True
    wd, _ = _both(padded, conf, jstate, jcfg, q[:8], allowed=few, k=10, nprobe=c + pad)
    assert np.isinf(wd).sum() == 8 * 4


def _wide_state(c=2048, lcap=8, d=16):
    rng = np.random.default_rng(23)
    n = c * lcap
    centers = rng.standard_normal((64, d)).astype(np.float32) * 6.0
    a = rng.integers(0, 64, size=n)
    pts = centers[a] + rng.standard_normal((n, d)).astype(np.float32)
    pv = pts[np.argsort(a, kind="stable")].reshape(c, lcap, d)
    cents = pv.mean(axis=1)
    members = np.arange(n, dtype=np.int32).reshape(c, lcap)
    members[::7, -1] = -1
    alive = rng.random((c, lcap)) < 0.97
    arrays = {
        "centroids": cents, "cnorms": (cents ** 2).sum(1), "members": members,
        "pvecs": pv, "pnorms": np.where(members >= 0, (pv ** 2).sum(-1), np.inf),
        "alive": alive,
    }
    arrays = {k: np.asarray(v, np.float32 if v.dtype.kind == "f" else v.dtype)
              for k, v in arrays.items()}
    jstate = jivf.IvfState(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        codes=jnp.zeros((1, 1, 1), jnp.int8), mins=jnp.zeros((1, 1)),
        scales=jnp.zeros((1, 1)),
    )
    q = centers[rng.integers(0, 64, 32)] + rng.standard_normal((32, d)).astype(np.float32)
    return arrays, jstate, q.astype(np.float32)


@pytest.mark.parametrize("replicated", [True, False])
def test_search_parity_two_level_cell_selection(replicated):
    """C = 2048 > 1024: the reference selects cells with its two-level
    exact selector, the port with K2 in one pass; both pick the same cells."""
    arrays, jstate, q = _wide_state()
    c, lcap = arrays["members"].shape
    jcfg = jivf.IvfConfig(dim=16, n_clusters=c, cluster_cap=lcap, replicated=replicated)
    arrays_cfg = dataclasses.asdict(jcfg) | {"metric": 0}
    _both(arrays, arrays_cfg, jstate, jcfg, q, k=5, nprobe=32)


def test_assignment_agrees_with_reference():
    rng = np.random.default_rng(24)
    x = _clustered(rng, 6000)
    cents = x[rng.choice(6000, 96, replace=False)]
    xpad = jivf._pad_rows(x, jivf._KM_CHUNK)
    want = np.asarray(jivf._assign_all(jnp.asarray(xpad), jnp.asarray(cents)))[:6000]
    got = tivf._assign_all(torch.from_numpy(x), torch.from_numpy(cents)).numpy()
    assert np.mean(got == want) >= 0.995
    wi, wd = jivf._assign_topk_all(jnp.asarray(xpad), jnp.asarray(cents), k=2)
    gi, gd = tivf._assign_topk_all(torch.from_numpy(x), torch.from_numpy(cents), k=2)
    assert np.mean((gi.numpy() == np.asarray(wi)[:6000]).all(1)) >= 0.995
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd)[:6000], rtol=1e-4, atol=1e-2)
    # excluded (cn = +inf) clusters never win
    cn = (cents ** 2).sum(1)
    cn[::2] = np.inf
    got = tivf._assign_all(torch.from_numpy(x), torch.from_numpy(cents),
                           torch.from_numpy(cn)).numpy()
    assert (got % 2 == 1).all()


def test_kmeans_and_two_means_track_reference():
    """Lloyd's from the same seeds, and the batched 2-means split, land
    where the reference's do (fp32 update sums differ only in order)."""
    rng = np.random.default_rng(25)
    x = _clustered(rng, 4096)
    init = x[rng.choice(4096, 40, replace=False)]
    want = np.asarray(jivf._kmeans(jnp.asarray(x), jnp.asarray(init), iters=4))
    got = tivf._kmeans(torch.from_numpy(x), torch.from_numpy(init), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    pts = x[:8 * 64].reshape(8, 64, DIM)
    valid = np.arange(64)[None, :] < rng.integers(20, 65, (8, 1))
    wl, wc = jivf._two_means_batched(jnp.asarray(pts), jnp.asarray(valid))
    gl, gc = tivf._two_means_batched(torch.from_numpy(pts), torch.from_numpy(valid))
    assert np.mean(gl.numpy()[valid] == np.asarray(wl)[valid]) >= 0.99
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-3, atol=1e-3)


def test_unported_paths_raise():
    """No build option is left unported: the index takes fast_build (held
    against the reference in tests/test_torch_fast_build.py) and dense
    block packing (tests/test_torch_dense.py), and refuses neither."""
    assert tivf.IvfIndex(dim=8, fast_build=True, device="cpu").fast_build
    idx = tivf.IvfIndex(dim=8, dense_pack=True, nblocks=4, device="cpu")
    assert idx.dense_pack and idx.nblocks == 4
    assert Metric.L2.value == 0


def test_rerank_past_the_selection_width():
    """sq8 with rerank = 2500 candidate lanes (past SEL_MAX = 2048, where
    on the card the probe and K5 run their wide forms): the reference's
    answers on its own state."""
    rng = np.random.default_rng(25)
    x = _clustered(rng, 3000)
    q = x[:16] + 0.05 * rng.standard_normal((16, DIM)).astype(np.float32)
    ref = jivf.IvfIndex(dim=DIM, n_clusters=16, nprobe=8, sq8=True, rerank=2500)
    ref.add(x)
    ref.train()
    assert ref.cfg.rerank > 2048 and 8 * ref.cfg.cluster_cap >= ref.cfg.rerank
    _both(*export_ivf(ref.state, ref.cfg), ref.state, ref.cfg, q)


@pytest.mark.parametrize("sq8", [False, True], ids=["f32", "sq8"])
def test_dim_not_a_multiple_of_four(sq8):
    """d = 6 (the card's row kernels read rows zero-padded to 8): the
    reference's state, loaded by convert.py, answers as the reference; the
    port's own build of the same rows keeps the true dim and recalls as the
    reference's build."""
    d = 6
    rng = np.random.default_rng(26)
    x = _clustered(rng, 2000, d=d, c=16)
    q = x[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    kw = dict(n_clusters=32, nprobe=4, sq8=sq8, rerank=20 if sq8 else 0)
    ref = jivf.IvfIndex(dim=d, **kw)
    ref.add(x)
    ref.train()
    arrays, conf = export_ivf(ref.state, ref.cfg)
    state, _ = ivf_state_from_numpy(arrays, conf, "cpu")
    assert state.pvecs.shape[-1] == d
    _both(arrays, conf, ref.state, ref.cfg, q)
    port = tivf.IvfIndex(dim=d, device="cpu", **kw)
    port.add(x)
    port.train()
    assert port.state.pvecs.shape[-1] == d
    exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    rec = [np.mean([len(set(a) & set(b)) / 10 for a, b in zip(np.asarray(ids), exact)])
           for ids in (ref.search(q, k=10)[1], port.search(q, k=10)[1])]
    assert rec[1] >= rec[0] - 0.02, rec
