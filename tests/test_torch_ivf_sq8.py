"""The SQ8-probe + exact-rerank IVF path against the JAX reference.

- `sq8_encode` / `sq8_decode`, the store's centred codes, m′ and SQ16
  codes, and the int8 query quantization are bit-equal to the reference
  (queries planted with exact .5 ratios, rows with a zero scale);
- `ivf_search_impl` on exported reference sq8 states (rerank over the f32
  rows, the compact SQ16 store with and without rerank, sq8 without
  rerank, the f32 store with rerank, and a wide state with P·L > 2048)
  equals the reference's own search: ids equal on every finite entry
  except near ties, the same +inf entries, distances within
  `assert_knn_match`'s rtol 1e-4 / atol 1e-3 (fp32 dots summed in another
  order) — for L2, COSINE and IP, replicas on and off, an `allowed` mask;
- the port's builds reach the reference's quality (tests/test_ivf.py);
- `hard_pool` gives the reference's arrays from the same generator.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_headline_geometry import headline_geometry
from torch_parity import assert_knn_match, export_ivf

from turdb_tpu.models import ivf as jivf
from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.ops import quantize as jq
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu.utils import datasets as jdata
from turdb_tpu_torch.convert import ivf_state_from_numpy
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.ops import quantize as tq
from turdb_tpu_torch.utils.datasets import hard_pool, recall_of

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

DIM = 32


def _clustered(rng, n, d=DIM, c=32):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, c, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _rows_with_ties(rng):
    x = rng.standard_normal((64, DIM)).astype(np.float32) * 3
    x[0] = 1.25                              # constant row: scale 0
    # min 0, max 255: scale 1, so (x - min) / scale lands on exact .5
    x[1] = rng.integers(0, 255, DIM) + 0.5
    x[1, :2] = (0.0, 255.0)
    return x


def test_sq8_encodings_bit_equal():
    x = _rows_with_ties(np.random.default_rng(30))
    wc, wm, ws = (np.asarray(a) for a in jq.sq8_encode(jnp.asarray(x)))
    gc, gm, gs = (a.numpy() for a in tq.sq8_encode(torch.from_numpy(x)))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gm.view(np.int32), wm.view(np.int32))
    np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))
    assert (gc[1, 2:] % 2 == 0).all()         # half to even
    np.testing.assert_array_equal(
        tq.sq8_decode(*map(torch.from_numpy, (gc, gm, gs))).numpy(),
        np.asarray(jq.sq8_decode(*map(jnp.asarray, (wc, wm, ws)))))
    # the store's centred codes, m′ and SQ16 codes (ivf.py _pack_body)
    jp, codes, mins, scales, _ = jivf._pack_body(
        jnp.zeros((64, 1, DIM), jnp.uint16), jnp.zeros((64, 1, DIM), jnp.int8),
        jnp.zeros((64, 1)), jnp.zeros((64, 1)), jnp.zeros((64, 1)), jnp.asarray(x),
        jnp.arange(64), jnp.zeros(64, jnp.int32), sq8=True, keep_f32=False,
        probe_only=False)
    c8, m_prime, s8, m8 = tq.sq8_store(torch.from_numpy(x))
    np.testing.assert_array_equal(c8.numpy(), np.asarray(codes)[:, 0])
    np.testing.assert_array_equal(m_prime.numpy(), np.asarray(mins)[:, 0])
    np.testing.assert_array_equal(s8.numpy(), np.asarray(scales)[:, 0])
    u16 = tq.sq16_encode(torch.from_numpy(x), m8, s8)
    np.testing.assert_array_equal(u16.numpy().view(np.uint16), np.asarray(jp)[:, 0])
    # dequantized as the reference's rerank does (ivf.py:362-369)
    base = np.asarray(mins)[:, 0] - 128.0 * np.asarray(scales)[:, 0]
    s16 = np.asarray(scales)[:, 0] * np.float32(255.0 / 65535.0)
    want = base[:, None] + s16[:, None] * np.asarray(jp)[:, 0].astype(np.float32)
    np.testing.assert_array_equal(tq.sq16_decode(u16, m_prime, s8).numpy(), want)


def test_query_quantization_bit_equal():
    rng = np.random.default_rng(31)
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    # max|q| = 127 makes qs = 1: q / qs keeps the planted .5 fractions
    q[:4] = rng.integers(-126, 126, (4, DIM)) + 0.5
    q[:4, 0] = 127.0
    q[4] = 0.0                                 # qs at its 1e-30 floor
    qj = jnp.asarray(q)
    qs_w = jnp.maximum(jnp.max(jnp.abs(qj), axis=-1), 1e-30) / 127.0
    qc_w = jnp.clip(jnp.round(qj / qs_w[:, None]), -127, 127).astype(jnp.int8)
    qc, qs, qsum = tq.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(qc_w))
    np.testing.assert_array_equal(qs.numpy().view(np.int32), np.asarray(qs_w).view(np.int32))
    assert (qc.numpy()[:4, 1:] % 2 == 0).all()
    np.testing.assert_allclose(qsum.numpy(), np.asarray(jnp.sum(qj, axis=-1)), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# search on exported reference states
# ---------------------------------------------------------------------------

STORES = {
    # name: IvfIndex flags
    "sq8_rerank": dict(sq8=True, rerank=64),
    "sq8": dict(sq8=True, rerank=0),
    "compact_rerank": dict(sq8=True, keep_f32=False, rerank=64),
    "probe_only": dict(sq8=True, keep_f32=False, rerank=0),
}


@pytest.fixture(scope="module")
def built():
    """One reference index per store (3000 x 32, 64 cells, replicas on)."""
    rng = np.random.default_rng(32)
    x = _clustered(rng, 3000)
    q = x[:40] + 0.05 * rng.standard_normal((40, DIM)).astype(np.float32)
    out = {}
    for name, flags in STORES.items():
        idx = jivf.IvfIndex(dim=DIM, n_clusters=64, nprobe=8, **flags)
        idx.add(x)
        idx.train()
        assert idx.cfg.replicated
        out[name] = idx
    return out, q


def _both(arrays, conf, jstate, jcfg, q, allowed=None, k=10, nprobe=8):
    want = jivf.ivf_search_impl(jstate, jnp.asarray(q),
                                None if allowed is None else jnp.asarray(allowed),
                                cfg=jcfg, k=k, nprobe=nprobe)
    state, cfg = ivf_state_from_numpy(arrays, conf, "cpu")
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


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("name", ["L2", "COSINE", "IP"])
@pytest.mark.parametrize("replicated", [True, False])
def test_search_parity_on_exported_sq8_state(built, store, name, replicated):
    """The sq8 probe and the rerank are L2 whatever the config's metric
    says, in both packages: the metric changes nothing here."""
    idxs, q = built
    idx = idxs[store]
    jcfg = dataclasses.replace(idx.cfg, metric=JaxMetric[name], replicated=replicated)
    arrays, conf = export_ivf(idx.state, jcfg)
    if store == "compact_rerank":
        assert arrays["pvecs"].dtype == np.uint16
    if store == "probe_only":
        assert arrays["pvecs"].shape == (1, 1, 1)
    _both(arrays, conf, idx.state, jcfg, q)


@pytest.mark.parametrize("store", ["sq8_rerank", "compact_rerank", "probe_only"])
def test_search_parity_with_allowed_mask(built, store):
    idxs, q = built
    idx = idxs[store]
    arrays, conf = export_ivf(idx.state, idx.cfg)
    allowed = np.random.default_rng(33).random(arrays["members"].shape) < 0.4
    wd, _ = _both(arrays, conf, idx.state, idx.cfg, q, allowed=allowed)
    assert np.isfinite(wd).any()


@pytest.mark.parametrize("name", ["L2", "IP"])
def test_search_parity_f32_store_with_rerank(built, name):
    """rerank on the f32 store (no sq8): the f32 probe ranks candidates by
    the metric, the rerank by exact L2, as in the reference."""
    idxs, q = built
    idx = idxs["sq8_rerank"]
    jcfg = dataclasses.replace(idx.cfg, sq8=False, rerank=40, metric=JaxMetric[name])
    arrays, conf = export_ivf(idx.state, jcfg)
    _both(arrays, conf, idx.state, jcfg, q, k=10, nprobe=6)


def _wide_sq8_state(c=512, lcap=8, d=16):
    rng = np.random.default_rng(34)
    n = c * lcap
    centers = rng.standard_normal((64, d)).astype(np.float32) * 6.0
    a = rng.integers(0, 64, size=n)
    pts = centers[a] + rng.standard_normal((n, d)).astype(np.float32)
    pv = pts[np.argsort(a, kind="stable")].reshape(c, lcap, d)
    members = np.arange(n, dtype=np.int32).reshape(c, lcap)
    members[::7, -1] = -1
    # replica-like copies: the same row under the same id in two cells
    members[1::5, 0] = members[0::5, 1][: len(members[1::5])]
    pv[1::5, 0] = pv[0::5, 1][: len(members[1::5])]
    alive = rng.random((c, lcap)) < 0.97
    codes, mins, scales = jq.sq8_encode(jnp.asarray(pv.reshape(n, d)))
    s16 = scales * (255.0 / 65535.0)
    u16 = jnp.clip(jnp.round((jnp.asarray(pv.reshape(n, d)) - mins[:, None])
                             / jnp.where(s16 == 0, 1.0, s16)[:, None]), 0, 65535)
    cents = pv.mean(axis=1)
    arrays = {
        "centroids": cents, "cnorms": (cents ** 2).sum(1), "members": members,
        "pvecs": np.asarray(u16.astype(jnp.uint16)).reshape(c, lcap, d),
        "pnorms": np.where(members >= 0, (pv ** 2).sum(-1), np.inf).astype(np.float32),
        "alive": alive,
        "codes": (np.asarray(codes).astype(np.int16) - 128).astype(np.int8).reshape(c, lcap, d),
        "mins": np.asarray(mins + 128.0 * scales).reshape(c, lcap),
        "scales": np.asarray(scales).reshape(c, lcap),
    }
    arrays = {k: np.asarray(v, np.float32) if v.dtype.kind == "f" else v
              for k, v in arrays.items()}
    jstate = jivf.IvfState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    q = centers[rng.integers(0, 64, 24)] + rng.standard_normal((24, d)).astype(np.float32)
    return arrays, jstate, q.astype(np.float32)


@pytest.mark.parametrize("rerank", [0, 64, 300])
def test_search_parity_wide_sq8_state(rerank):
    """P·L = 2400 lanes > 2048 with 8r <= P·L: the reference selects the
    candidates with its two-level selector (`topk_smallest_wide`, at r = 300
    too), the port in one pass; the rerank reads the SQ16 store, replicas
    on."""
    arrays, jstate, q = _wide_sq8_state()
    c, lcap = arrays["members"].shape
    jcfg = jivf.IvfConfig(dim=16, n_clusters=c, cluster_cap=lcap, sq8=True,
                          rerank=rerank, replicated=True)
    conf = dataclasses.asdict(jcfg) | {"metric": 0}
    _both(arrays, conf, jstate, jcfg, q, k=10, nprobe=300)


# ---------------------------------------------------------------------------
# build quality (mirrors tests/test_ivf.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(35)
    x = _clustered(rng, 3000)
    q = x[:64] + 0.01 * rng.standard_normal((64, DIM)).astype(np.float32)
    flat = JaxFlat(dim=DIM)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    return x, q, truth


def test_sq8_rerank_build_recall_matches_reference(data):
    x, q, truth = data
    ref = jivf.IvfIndex(dim=DIM, n_clusters=64, nprobe=8, sq8=True, rerank=64)
    port = tivf.IvfIndex(dim=DIM, n_clusters=64, nprobe=8, sq8=True, rerank=64,
                         device="cpu")
    for idx in (ref, port):
        idx.add(x)
        idx.train()
    assert port.cfg.sq8 and port.cfg.rerank == 64 and port.state.codes.dtype == torch.int8
    r_ref = recall_of(ref.search(q, k=10)[1], truth)
    r_port = recall_of(port.search(q, k=10)[1], truth)
    assert r_port >= r_ref - 0.02 and r_port >= 0.93, (r_port, r_ref)


def test_compact_store_recall_and_append():
    rng = np.random.default_rng(36)
    centers = rng.standard_normal((16, DIM)).astype(np.float32) * 4.0
    pool = (centers[rng.integers(0, 16, 4256)]
            + rng.standard_normal((4256, DIM))).astype(np.float32)
    x, q = pool[:4000], pool[4000:4128]
    flat = JaxFlat(dim=DIM)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    idx = tivf.IvfIndex(dim=DIM, sq8=True, keep_f32=False, n_clusters=64, device="cpu")
    idx.add(x)
    assert idx.state is not None and idx.state.pvecs.dtype == torch.int16
    assert idx.cfg.rerank == 64                 # rerank=None under sq8
    _, ids = idx.search(q, k=10, nprobe=16)
    assert recall_of(ids, truth) >= 0.9
    extra = (centers[rng.integers(0, 16, 8)] + rng.standard_normal((8, DIM))).astype(np.float32)
    slots = idx.add(extra)
    _, ids2 = idx.search(extra, k=1, nprobe=16)
    assert (ids2[:, 0] == slots).mean() >= 0.75
    # the SQ16 rows decode to the stored rows within half an SQ16 step
    # (range / 65535 / 2) plus the fp32 rounding of m′, base and the
    # product (a few ulps of the row's magnitude); a retrain rebuilds from them
    st = idx.state
    live = st.members >= 0
    decoded = tq.sq16_decode(st.pvecs, st.mins, st.scales)[live].numpy()
    rows = np.concatenate([x, extra])[st.members[live].numpy()]
    step = (rows.max(1) - rows.min(1)) / 65535.0
    ulps = 8 * np.finfo(np.float32).eps * np.abs(rows).max(1)
    assert (np.abs(decoded - rows) <= (0.5 * step + ulps)[:, None]).all()
    idx._retrain_with(np.zeros((0, DIM), np.float32), np.zeros(0, np.int64))
    assert idx.state.pvecs.dtype == torch.int16 and idx.size == 4008
    _, ids3 = idx.search(extra, k=1, nprobe=16)
    assert (ids3[:, 0] == slots).mean() >= 0.75


def test_probe_only_store_searches_and_refuses_appends(data):
    x, q, truth = data
    idx = tivf.IvfIndex(dim=DIM, n_clusters=64, sq8=True, keep_f32=False, rerank=0,
                        device="cpu")
    idx.add(x)
    idx.train()
    assert idx.probe_only and idx.state.pvecs.shape == (1, 1, 1)
    _, ids = idx.search(q, k=10, nprobe=16)
    assert recall_of(ids, truth) >= 0.75
    with pytest.raises(RuntimeError, match="probe-only"):
        idx.add(x[:2])


@pytest.mark.parametrize("n,sq8,dim", [(1_000_000, False, 128), (1_000_000, True, 128),
                                       (500_000, False, 384), (100_000, False, 128)])
def test_geometry_rule_matches_reference(n, sq8, dim):
    """At >= 500k rows the f32 store takes n//128 cells, the sq8 store
    n//64 (tests/test_headline_geometry.py pins the reference's rule;
    the port keeps no `_cpad` pad cells)."""
    c_work, cap = headline_geometry(n, sq8=sq8, dim=dim)
    c, got_cap = tivf.IvfIndex(dim=dim, sq8=sq8, device="cpu")._geometry(n)
    assert jivf._cpad(c) == c_work and got_cap == cap


def test_hard_pool_matches_reference():
    a = hard_pool(np.random.default_rng(37), 3000, 16, n_queries=200, n_clusters=24)
    b = jdata.hard_pool(np.random.default_rng(37), 3000, 16, n_queries=200, n_clusters=24)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
