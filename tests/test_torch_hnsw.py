"""The HNSW graph path of the port against the JAX reference.

- `select_levels`, `_bulk_layer_adj_host`, `_bulk_reverse_lists` and
  `_union_rows` are exactly the reference's on the same inputs;
- `_select_from_candidates` (K7's plain version) selects the reference's
  rows for L2 / COSINE / IP and alpha 1.0 / 1.2, with duplicates, -1 and
  the target planted among the candidates: rows equal on >= 99 %;
- `_beam_level` (K8's plain version) in its four modes and
  `hnsw_search_impl` (descent_ef 1 and 32, filtered or not) on a graph
  imported from the reference equal the reference's search within
  `assert_knn_match` (fp32 dots summed in another order);
- the port's own bulk build (the exact route, and the self-probe route by
  lowering `_BULK_BRUTE` / `_BULK_EXACT` in both packages) is reachable
  from its entry over its levels (>= 0.99; level 0 alone is as reachable
  as the reference's) and its recall@10 is within 0.02 of the
  reference's on the same data;
- deletes and `allowed` masks; wave inserts at an ef_construction past
  K7's SELECT_W_MAX build the reference's graph.
The reference's graph is built once per module at 9000 x 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_hnsw

from turdb_tpu.models import hnsw as jh
from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu_torch.convert import hnsw_index_from_numpy
from turdb_tpu_torch.kernels import SELECT_W_MAX
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.utils.datasets import recall_of

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, DIM, NQ = 9000, 32, 64
METRICS = (Metric.L2, Metric.COSINE, Metric.IP)


def _clustered(rng, n, d=DIM, c=64):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4.0
    a = rng.integers(0, c, size=n)
    r = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    return (centers[a] + r * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _reachable(adjs, entry, n):
    """Fraction of the n nodes reachable from `entry` (BFS) over the edges
    of every adjacency array in `adjs`."""
    seen = np.zeros(n, bool)
    seen[entry] = True
    frontier = np.array([entry])
    while len(frontier):
        nxt = np.concatenate([a[frontier].ravel() for a in adjs])
        nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen.mean()


def _levels(state):
    return [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in (state.adj0, *state.adj_hi)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = _clustered(rng, N + NQ)
    base, queries = x[:N], x[N:]
    flat = JaxFlat(dim=DIM, capacity=N)
    flat.add(base)
    _, truth = flat.search(queries, k=10)
    return base, queries, np.asarray(truth)


@pytest.fixture(scope="module")
def ref(data):
    """The reference's bulk-built graph (exact route at 9000 rows)."""
    base, _, _ = data
    idx = jh.HnswIndex(dim=DIM, capacity=N, bulk_threshold=4096)
    idx.add(base)
    return idx


def _port_of(ref_idx, device="cpu"):
    arrays, conf = export_hnsw(ref_idx.state, ref_idx.cfg, ref_idx.size)
    return hnsw_index_from_numpy(arrays, conf, ref_idx.size, alive=ref_idx._alive,
                                 descent_ef=ref_idx._descent_ef, device=device)


def test_select_levels_bit_equal():
    ids = np.random.default_rng(40).integers(0, 2**63, 100_000, dtype=np.uint64)
    for m in (16, 8):
        want = jh.select_levels(ids, jh.HnswConfig(dim=4, m=m, m0=2 * m))
        got = th.select_levels(ids, th.HnswConfig(dim=4, m=m, m0=2 * m))
        np.testing.assert_array_equal(got, want)
    assert got.max() == th.HNSW_MAX_LEVELS - 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_bulk_layer_adj_host_equal(metric):
    rng = np.random.default_rng(41)
    x = _clustered(rng, 700)
    if metric is Metric.COSINE:
        x = _unit(x)
    slots = np.sort(rng.choice(5000, 700, replace=False)).astype(np.int64)
    want = jh._bulk_layer_adj_host(slots, x, 16, JaxMetric(metric.value), r_mult=8, alpha=1.2)
    got = th._bulk_layer_adj_host(slots, x, 16, metric, r_mult=8, alpha=1.2)
    np.testing.assert_array_equal(got, want)


def test_bulk_reverse_lists_equal():
    """Ties in distance and -1 entries; sources point at repeated targets."""
    rng = np.random.default_rng(42)
    ns, deg = 3000, 24
    slots = np.sort(rng.choice(40_000, ns, replace=False)).astype(np.int64)
    adj = slots[rng.integers(0, ns, (ns, deg))].astype(np.int32)
    adj[rng.random((ns, deg)) < 0.1] = -1
    seld = rng.integers(0, 50, (ns, deg)).astype(np.float32) * 0.25   # many exact ties
    seld[:, 0] = -seld[:, 0]
    want = jh._bulk_reverse_lists(slots, adj, seld, 16)
    got = th._bulk_reverse_lists(slots, adj, seld, 16)
    np.testing.assert_array_equal(got, want)


def test_union_rows_equal():
    rng = np.random.default_rng(43)
    cand = rng.integers(-1, 60, (500, 48)).astype(np.int32)
    want = np.asarray(jh._union_rows(jnp.asarray(cand), 32))
    got = th._union_rows(torch.from_numpy(cand), 32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", (1.0, 1.2))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_select_from_candidates_matches_reference(metric, alpha):
    rng = np.random.default_rng(44)
    x = _clustered(rng, 3000)
    if metric is Metric.COSINE:
        x = _unit(x)
    norms = np.einsum("ij,ij->i", x, x).astype(np.float32)
    u, w = 400, 64
    targets = rng.choice(3000, u, replace=False).astype(np.int32)
    # each target's nearest 40 rows (by L2), then random ones, with planted
    # duplicates, -1 and the target itself
    d2 = norms[targets, None] + norms[None, :] - 2.0 * x[targets] @ x.T
    near = np.argsort(d2, axis=1)[:, :40]
    cand = np.concatenate([near, rng.integers(0, 3000, (u, w - 40))], axis=1).astype(np.int32)
    cand = np.take_along_axis(cand, rng.permuted(np.tile(np.arange(w), (u, 1)), axis=1), 1)
    cand[:, 5] = cand[:, 1]
    cand[:, 9] = -1
    cand[:, 13] = targets
    want_i, want_d = (np.asarray(a) for a in jh._bulk_select_jit(
        jnp.asarray(x), jnp.asarray(norms), jnp.asarray(targets), jnp.asarray(cand),
        deg=16, metric=JaxMetric(metric.value), alpha=alpha))
    got_i, got_d = th._select_from_candidates(
        torch.from_numpy(x), torch.from_numpy(norms), torch.from_numpy(targets),
        torch.from_numpy(cand), 16, metric, alpha)
    same = (got_i.numpy() == want_i).all(1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got_d.numpy()[same], want_d[same], rtol=1e-4, atol=1e-3)
    assert not (got_i.numpy() == targets[:, None]).any()


_ref_beam = jax.jit(jh._beam_level, static_argnames=(
    "ef", "iters", "metric", "k_res", "expand", "return_expanded"))

BEAM_MODES = ("plain", "multi_seed_active", "filtered", "expanded")


@pytest.mark.parametrize("mode", BEAM_MODES)
def test_beam_level_matches_reference(ref, data, mode):
    """`_beam_level` on the imported level 0 from the entry point (or, with
    several seeds, from the reference's upper-level beam), in each mode."""
    _, queries, _ = data
    port = _port_of(ref)
    st, pst = ref.state, port.state
    q = jnp.asarray(queries)
    qn = jnp.sum(q * q, axis=1)
    seed_i, seed_d = jh._seed_from_entry(st.vectors, st.norms, q, qn, st.entry, JaxMetric.L2)
    kw = dict(ef=48, iters=72, metric=JaxMetric.L2)
    active = None
    if mode == "multi_seed_active":
        seed_d, seed_i = _ref_beam(st.adj_hi[0], st.vectors, st.norms, q, qn, seed_i, seed_d,
                                   ef=32, iters=64, metric=JaxMetric.L2, expand=2)
        active = np.arange(NQ) % 5 != 0
        kw["active"] = jnp.asarray(active)
    allowed = None
    if mode == "filtered":
        allowed = np.random.default_rng(45).random(pst.vectors.shape[0]) < 0.5
        kw.update(allowed=jnp.asarray(allowed), k_res=16)
    want = [np.asarray(a) for a in _ref_beam(st.adj0, st.vectors, st.norms, q, qn, seed_i,
                                              seed_d, return_expanded=mode == "expanded",
                                              **kw)]
    tq = torch.from_numpy(queries)
    got = th._beam_level(
        pst.adj0, pst.vectors, pst.norms, tq, torch.sum(tq * tq, 1),
        torch.from_numpy(np.asarray(seed_i)), torch.from_numpy(np.asarray(seed_d)), 48, 72,
        Metric.L2, active=None if active is None else torch.from_numpy(active),
        allowed=None if allowed is None else torch.from_numpy(allowed),
        k_res=kw.get("k_res"), return_expanded=mode == "expanded")
    got = [g.numpy() for g in got]
    assert_knn_match(want[0], want[1], got[0], got[1])
    if mode == "filtered":
        assert_knn_match(want[2], want[3], got[2], got[3])
        assert allowed[got[3][got[3] >= 0]].all()
    if mode == "expanded":
        assert (got[2] == want[2]).all(1).mean() >= 0.95
    if mode == "multi_seed_active":
        assert (got[1][~active] == -1).all()


@pytest.mark.parametrize("metric", (Metric.COSINE, Metric.IP), ids=lambda m: m.name)
def test_beam_level_metrics_match_reference(ref, data, metric):
    """The COSINE and IP epilogues, on the imported graph with unit rows."""
    _, queries, _ = data
    st = ref.state
    v = np.asarray(st.vectors)
    v = np.where(np.linalg.norm(v, axis=1, keepdims=True) > 0, v, 1.0)
    v = _unit(v)
    norms = np.einsum("ij,ij->i", v, v).astype(np.float32)
    q = _unit(queries)
    qn = np.einsum("ij,ij->i", q, q).astype(np.float32)
    seed_i = np.full(NQ, int(st.entry), np.int32)
    seed_d = 1.0 - q @ v[int(st.entry)] if metric is Metric.COSINE else -(q @ v[int(st.entry)])
    seed_d = seed_d.astype(np.float32)
    want = _ref_beam(st.adj0, jnp.asarray(v), jnp.asarray(norms), jnp.asarray(q),
                     jnp.asarray(qn), jnp.asarray(seed_i), jnp.asarray(seed_d), ef=48, iters=72,
                     metric=JaxMetric(metric.value))
    got = th._beam_level(torch.from_numpy(np.asarray(st.adj0)), torch.from_numpy(v),
                         torch.from_numpy(norms), torch.from_numpy(q), torch.from_numpy(qn),
                         torch.from_numpy(seed_i), torch.from_numpy(seed_d), 48, 72, metric)
    assert_knn_match(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("descent_ef", (1, 32))
@pytest.mark.parametrize("filtered", (False, True))
def test_hnsw_search_impl_matches_reference(ref, data, descent_ef, filtered):
    _, queries, _ = data
    port = _port_of(ref)
    allowed = None
    if filtered:
        allowed = np.zeros(port.capacity, bool)
        allowed[:N] = np.random.default_rng(46).random(N) < 0.6
    want = jh.hnsw_search_impl(ref.state, jnp.asarray(queries),
                               None if allowed is None else jnp.asarray(allowed),
                               cfg=ref.cfg, k=10, ef=64, iters=96, filtered=filtered,
                               descent_ef=descent_ef)
    got = th.hnsw_search_impl(port.state, torch.from_numpy(queries),
                              None if allowed is None else torch.from_numpy(allowed),
                              cfg=port.cfg, k=10, ef=64, iters=96, filtered=filtered,
                              descent_ef=descent_ef)
    assert_knn_match(np.asarray(want[0]), np.asarray(want[1]), got[0].numpy(), got[1].numpy())
    if filtered:
        ids = got[1].numpy()
        assert allowed[ids[ids >= 0]].all()


def _quality(idx, queries, truth, n):
    """(reachability from the entry over every level, over level 0 alone,
    recall@10 of search, of search_serve)."""
    _, i_g = idx.search(queries, k=10, ef=64)
    _, i_s = idx.search_serve(queries, k=10, ef=64)
    adjs, entry = _levels(idx.state), int(idx.state.entry)
    return (_reachable(adjs, entry, n), _reachable(adjs[:1], entry, n),
            recall_of(i_g, truth), recall_of(i_s, truth))


@pytest.mark.parametrize("route", ("exact", "self_probe"))
def test_port_bulk_build_quality(ref, data, route, monkeypatch):
    base, queries, truth = data
    if route == "self_probe":
        # L0 (9000 rows) then takes the self-probe, L1 (~570) the host route
        for mod in (jh, th):
            monkeypatch.setattr(mod, "_BULK_BRUTE", 1024)
            monkeypatch.setattr(mod, "_BULK_EXACT", 2048)
        ref = jh.HnswIndex(dim=DIM, capacity=N, bulk_threshold=4096)
        ref.add(base)
    port = th.HnswIndex(dim=DIM, capacity=N, bulk_threshold=4096, device="cpu")
    slots = port.add(base)
    np.testing.assert_array_equal(slots, np.arange(N))
    assert port.state.max_level == int(ref.state.max_level)
    np.testing.assert_array_equal(port.state.levels.numpy(), np.asarray(ref.state.levels))
    reach, reach0, r_graph, r_serve = _quality(port, queries, truth, N)
    w_reach, w_reach0, w_graph, w_serve = _quality(ref, queries, truth, N)
    # a bulk graph's level 0 holds only near-neighbour edges, so on these
    # well-separated blobs it is one island per blob in both packages; the
    # levels above connect them
    assert reach >= 0.99 and reach >= w_reach - 0.005, (reach, w_reach)
    assert abs(reach0 - w_reach0) <= 0.01, (reach0, w_reach0)
    assert r_graph >= w_graph - 0.02, (r_graph, w_graph)
    assert r_serve >= w_serve - 0.02, (r_serve, w_serve)
    assert r_graph >= 0.95 and r_serve >= 0.95


def test_delete_and_allowed_never_return_hidden(ref, data):
    _, queries, truth = data
    port = _port_of(ref)
    victims = np.unique(truth[:, 0])
    port.delete(victims)
    allowed = np.random.default_rng(47).random(N) < 0.5
    for search in (port.search, port.search_serve):
        _, ids = search(queries, k=10, ef=64)
        assert not np.isin(ids, victims).any()
        _, ids = search(queries, k=10, ef=64, allowed=allowed)
        got = ids[ids >= 0]
        assert len(got) and allowed[got].all() and not np.isin(got, victims).any()


def test_unported_paths_raise(data):
    """Every mutation path of the index is ported (tests/test_torch_hnsw_wave.py
    and tests/test_torch_hnsw_sq.py hold them to the reference): an add
    below bulk_threshold and into a non-empty index take the waves, and
    quantize, dequantize and vacuum run. No width raises on the CPU: the
    waves select from the ef_construction beam, and at ef_construction =
    300, past K7's SELECT_W_MAX (on the card K7's wide form takes it), wave
    inserts build the reference's graph."""
    base, _, _ = data
    efc = 300
    assert efc > SELECT_W_MAX
    wide = th.HnswIndex(dim=DIM, ef_construction=efc, device="cpu")
    want = jh.HnswIndex(dim=DIM, ef_construction=efc)
    for idx in (wide, want):
        idx.add(base[:300])                     # below bulk_threshold: the waves
        idx.add(base[300:400])
    assert len(wide) == 400 and (wide.state.entry, wide.state.max_level) == (
        int(want.state.entry), int(want.state.max_level))
    for a, b in zip((wide.state.adj0, *wide.state.adj_hi), (want.state.adj0, *want.state.adj_hi)):
        assert (a.numpy()[:400] == np.asarray(b)[:400]).all(1).mean() >= 0.99
    small = th.HnswIndex(dim=DIM, device="cpu")
    np.testing.assert_array_equal(small.add(base[:100]), np.arange(100))
    idx = th.HnswIndex(dim=DIM, capacity=4096, bulk_threshold=2000, device="cpu")
    idx.add(base[:3000])
    np.testing.assert_array_equal(idx.add(base[3000:3100]), np.arange(3000, 3100))
    assert len(idx) == 3100 and idx._descent_ef == 32
    idx.quantize_sq16()
    _, ids = idx.search(base[3000:3020], k=1, ef=64)
    assert (ids[:, 0] == np.arange(3000, 3020)).mean() >= 0.9
    idx.dequantize()
    assert isinstance(idx.state.vectors, torch.Tensor)
    idx.delete(np.arange(0, 3100, 2))
    mapping = idx.vacuum()
    assert len(idx) == 1550 and (mapping[::2] == -1).all()
    np.testing.assert_array_equal(mapping[1::2], np.arange(1550))
    empty = th.HnswIndex(dim=DIM, device="cpu")
    d, i = empty.search(base[:3], k=4)
    assert (i == -1).all() and np.isinf(d).all()


def test_ten_levels_through_convert(data):
    """A reference state with HnswConfig(max_levels=10), nine upper levels
    (past K9's GREEDY_LEVELS_MAX = 8 a launch), loaded by convert.py: the
    port walks them in launches of at most eight, top first, and answers
    as the reference's `hnsw_search_impl`, with and without a mask."""
    import dataclasses

    base, queries, _ = data
    ref = jh.HnswIndex(dim=DIM, capacity=2048)
    ref.cfg = dataclasses.replace(ref.cfg, max_levels=10)
    ref.state = jh.init_state(ref.cfg, ref.capacity)
    ref.add(base[:1500])
    assert len(ref.state.adj_hi) == 9
    arrays, conf = export_hnsw(ref.state, ref.cfg, ref.size)
    port = hnsw_index_from_numpy(arrays, conf, ref.size, alive=ref._alive, device="cpu")
    assert port.cfg.max_levels == 10 and len(port.state.adj_hi) == 9
    allowed = np.random.default_rng(48).random(port.capacity) < 0.7
    for mask in (None, allowed):
        want = jh.hnsw_search_impl(ref.state, jnp.asarray(queries),
                                   None if mask is None else jnp.asarray(mask), cfg=ref.cfg,
                                   k=10, ef=64, iters=96, filtered=mask is not None)
        got = th.hnsw_search_impl(port.state, torch.from_numpy(queries),
                                  None if mask is None else torch.from_numpy(mask), cfg=port.cfg,
                                  k=10, ef=64, iters=96, filtered=mask is not None)
        assert_knn_match(*(np.asarray(a) for a in want), *(a.numpy() for a in got))


def test_dim_not_a_multiple_of_four():
    """d = 6 (the card's row kernels read rows zero-padded to 8): the
    reference's wave-built graph, loaded by convert.py, answers as the
    reference; the port's own waves over the same rows keep the true dim
    and recall as the reference's (graph search and the serving pack's
    search)."""
    d = 6
    rng = np.random.default_rng(49)
    x = _clustered(rng, 1500, d=d, c=16)
    q = x[:24] + 0.05 * rng.standard_normal((24, d)).astype(np.float32)
    ref = jh.HnswIndex(dim=d, ef_construction=64)
    ref.add(x)
    arrays, conf = export_hnsw(ref.state, ref.cfg, ref.size)
    port = hnsw_index_from_numpy(arrays, conf, ref.size, alive=ref._alive, device="cpu")
    assert port.state.vectors.shape[1] == d
    assert_knn_match(*ref.search(q, k=10, ef=64), *port.search(q, k=10, ef=64))
    own = th.HnswIndex(dim=d, ef_construction=64, device="cpu")
    own.add(x)
    assert own.state.vectors.shape[1] == d
    own.pack_serving()
    assert own.serve.nbr_codes.shape[-1] == d
    exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    rec = [np.mean([len(set(a) & set(b)) / 10 for a, b in zip(np.asarray(ids), exact)])
           for ids in (ref.search(q, k=10, ef=64)[1], own.search(q, k=10, ef=64)[1],
                       own.search_serve(q, k=10, ef=64)[1])]
    assert min(rec[1:]) >= rec[0] - 0.02, rec
