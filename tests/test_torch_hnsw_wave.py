"""The HNSW insert waves of the port against the JAX reference.

- `_greedy_level` (K9's plain version) on every level, from the entry, from
  random starts and from -1, for L2 / COSINE / IP: ids equal on >= 99 %,
  and where they differ the two distances tie within `assert_knn_match`'s
  tolerance (fp32 dots summed in another order);
- K7's presorted mode against `_select_neighbors_heuristic` on the
  reference's own beam buffers: rows equal on >= 99 %;
- the one-level descent composed with `_wave_level_core`, and
  `_reverse_dense_core`, on a graph imported from the reference: rows
  equal on >= 99 %, rows no edge touches bit-equal;
- `_entry_update_core` exactly, the empty-graph bootstrap and ties of level
  included;
- one `_insert_wave` from the same imported state: levels, entry and top
  level equal, the rows bit-equal, the norms within 4 ulp (XLA sums x² in
  its own order, a sequential FMA chain at this width), the
  adjacency rows equal on >= 99 %; the reference's padded and unpadded
  waves build the same graph bit for bit;
- `add`'s wave sizes equal the reference's;
- whole wave builds as tests/test_hnsw.py makes them (from empty,
  incremental, empty and single, COSINE): recall@10 within 0.02 of the
  reference's and >= 0.93;
- `vacuum` by both routes: the mapping equal to the reference's, deleted
  rows never returned, survivors found by their own rows.
The reference's graph is tests/test_hnsw.py's: 2000 x 32, built by waves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_hnsw

from turdb_tpu.models import hnsw as jh
from turdb_tpu.models.flat import FlatIndex as JaxFlat
from turdb_tpu.ops.distance import Metric as JaxMetric
from turdb_tpu.ops.distance import prep_norms as jax_prep_norms
from turdb_tpu_torch import kernels
from turdb_tpu_torch.convert import hnsw_index_from_numpy
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.utils.datasets import recall_of

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, DIM, NQ, BB, EFC = 2000, 32, 50, 256, 64
NW = 200           # rows of the inserted wave: the reference pads it to BB
METRICS = (Metric.L2, Metric.COSINE, Metric.IP)

_ref_greedy = jax.jit(jh._greedy_level, static_argnames=("metric",))
_ref_beam = jax.jit(jh._beam_level, static_argnames=("ef", "iters", "metric", "expand"))
_ref_heuristic = jax.jit(jh._select_neighbors_heuristic, static_argnames=("m_out", "metric",
                                                                           "alpha"))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1234)      # tests/test_hnsw.py's data
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    wave = rng.standard_normal((BB, DIM)).astype(np.float32)
    flat = JaxFlat(dim=DIM)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    return x, q, np.asarray(truth), wave


@pytest.fixture(scope="module")
def ref(data):
    """The reference's wave-built graph (tests/test_hnsw.py's index)."""
    idx = jh.HnswIndex(dim=DIM, ef_construction=EFC, build_batch=BB)
    idx.add(data[0])
    return idx


def _clone(idx):
    """A reference index whose arrays the jitted stages may donate."""
    c = copy.copy(idx)
    c.state = jax.tree_util.tree_map(jnp.array, idx.state)
    c._alive = idx._alive.copy()
    return c


def _port_of(ref_idx):
    arrays, conf = export_hnsw(ref_idx.state, ref_idx.cfg, ref_idx.size)
    port = hnsw_index_from_numpy(arrays, conf, ref_idx.size, alive=ref_idx._alive,
                                 descent_ef=ref_idx._descent_ef, device="cpu")
    port.build_batch, port.bulk_threshold = ref_idx.build_batch, ref_idx.bulk_threshold
    return port


def _levels(state):
    return [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in (state.adj0, *state.adj_hi)]


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _ids_match(want_i, want_d, got_i, got_d, rtol=1e-4, atol=1e-3):
    """Ids equal on >= 99 %; where they differ the distances tie within
    the tolerance of `assert_knn_match`."""
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    got_i, got_d = np.asarray(got_i), np.asarray(got_d)
    diff = want_i != got_i
    assert diff.mean() <= 0.01, diff.mean()
    assert np.all(np.abs(want_d[diff] - got_d[diff]) <= atol + rtol * np.abs(want_d[diff]))


def _metric_rows(st, queries, metric):
    """The graph's rows and the queries for `metric`: unit rows for
    COSINE and IP, as in tests/test_torch_hnsw.py."""
    v = np.asarray(st.vectors)
    q = queries
    if metric is not Metric.L2:
        v = _unit(np.where(np.linalg.norm(v, axis=1, keepdims=True) > 0, v, 1.0))
        q = _unit(q)
    norms = np.asarray(jax_prep_norms(jnp.asarray(v)))
    return v, norms, q, np.asarray(jax_prep_norms(jnp.asarray(q)))


def _seed_dists(v, norms, q, qn, ids, metric):
    dots = np.einsum("bd,bd->b", q, v[np.maximum(ids, 0)])
    if metric is Metric.L2:
        d = np.maximum(qn + norms[np.maximum(ids, 0)] - 2.0 * dots, 0.0)
    else:
        d = 1.0 - dots if metric is Metric.COSINE else -dots
    return np.where(ids >= 0, d, np.inf).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_greedy_level_matches_reference(ref, data, metric):
    """From the entry point, from random nodes of the level, and from -1
    (the reference clips it: row 0's list against +inf), on every level."""
    _, _, _, wave = data
    st = ref.state
    v, norms, q, qn = _metric_rows(st, wave, metric)
    rng = np.random.default_rng(50)
    levels = np.asarray(st.levels)[:N]
    for lvl in range(int(st.max_level), -1, -1):
        adj = np.asarray(st.adj0 if lvl == 0 else st.adj_hi[lvl - 1])
        members = np.flatnonzero(levels >= lvl)
        starts = (np.full(BB, int(st.entry), np.int32),
                  rng.choice(members, BB).astype(np.int32),
                  np.full(BB, -1, np.int32))
        for cur in starts:
            cur_d = _seed_dists(v, norms, q, qn, cur, metric)
            want = _ref_greedy(adj, v, norms, q, qn, cur, cur_d, metric=JaxMetric(metric.value))
            got = th._greedy_level(*(torch.from_numpy(a) for a in (adj, v, norms, q, qn, cur,
                                                                   cur_d)), metric)
            _ids_match(want[0], want[1], got[0].numpy(), got[1].numpy())


def _ref_level0_beam(st, q, qn, metric=JaxMetric.L2):
    """The reference's level-0 ef_construction beam from the entry point,
    as `_wave_level_core` runs it (seeds [B], expand 4)."""
    cur_i, cur_d = jh._seed_from_entry(st.vectors, st.norms, q, qn, st.entry, metric)
    return _ref_beam(st.adj0, st.vectors, st.norms, q, qn, cur_i, cur_d, ef=EFC,
                     iters=EFC + EFC // 2, metric=metric)


@pytest.mark.parametrize("alpha", (1.0, 1.2))
def test_select_sorted_matches_heuristic(ref, data, alpha):
    """K7's presorted mode on the reference's beam buffers (W = 64, with
    their -1 / +inf tails) selects the reference heuristic's rows."""
    st = ref.state
    q = jnp.asarray(data[3])
    cand_d, cand_i = _ref_level0_beam(st, q, jnp.sum(q * q, axis=1))
    valid = cand_i >= 0
    want_i, want_d = (np.asarray(a) for a in _ref_heuristic(
        cand_i, jnp.where(valid, cand_d, jnp.inf), st.vectors[jnp.clip(cand_i, 0)], m_out=32,
        metric=JaxMetric.L2, alpha=alpha))
    got_i, got_d, _ = kernels.hnsw_select_sorted(
        torch.from_numpy(np.asarray(st.vectors)), torch.from_numpy(np.asarray(cand_i)),
        torch.from_numpy(np.asarray(cand_d)), deg=32, metric=0, alpha=alpha)
    same = (got_i.numpy() == want_i).all(1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(got_d.numpy()[same], want_d[same])


def _wave(ref_idx, wave, n=NW):
    slots = np.arange(ref_idx.size, ref_idx.size + n, dtype=np.int32)
    return wave[:n], slots, jh.select_levels(slots.astype(np.uint64), ref_idx.cfg)


def test_wave_level_core_matches_reference(ref, data):
    """Every level of one wave of BB rows on the imported graph, each level
    from the reference's seeds: the port's one-level greedy descent for the
    rows that pass through, then `_wave_level_core` (the connecting rows'
    beam and selection) against the reference's `_wave_level_jit`, which
    does both: the next seeds equal but at ties, the selected rows equal
    on >= 99 %."""
    vecs, slots, lvls = _wave(ref, data[3], BB)
    st = ref.state
    port = _port_of(ref)
    q = jnp.asarray(vecs)
    qn = jnp.sum(q * q, axis=1)
    cur_i, cur_d = jh._seed_from_entry(st.vectors, st.norms, q, qn, st.entry, JaxMetric.L2)
    for lvl in range(ref.cfg.max_levels - 1, -1, -1):
        deg = ref.cfg.m0 if lvl == 0 else ref.cfg.m
        connect = lvls >= lvl
        adj = st.adj0 if lvl == 0 else st.adj_hi[lvl - 1]
        want = [np.asarray(a) for a in jh._wave_level_jit(
            adj, st.vectors, st.norms, q, qn, cur_i, cur_d, jnp.asarray(connect),
            metric=JaxMetric.L2, efc=EFC, iters=EFC + EFC // 2, deg_out=deg)]
        args = (th._level_adj(port.state, lvl), port.state.vectors, port.state.norms,
                torch.from_numpy(vecs), torch.from_numpy(np.asarray(qn)))
        ci, cd = torch.from_numpy(np.asarray(cur_i)), torch.from_numpy(np.asarray(cur_d))
        gi, gd = th._greedy_level(*args, ci, cd, Metric.L2)
        conn = torch.from_numpy(connect)
        got = [g.numpy() for g in th._wave_level_core(
            *args, torch.where(conn, ci, gi), torch.where(conn, cd, gd), connect,
            metric=Metric.L2, efc=EFC, iters=EFC + EFC // 2, deg_out=deg)]
        _ids_match(want[0], want[1], got[0], got[1])
        w = want[2].shape[1]
        assert (got[2][:, w:] == -1).all()
        assert (got[2][:, :w] == want[2]).all(1).mean() >= 0.99
        assert (got[2][~connect] == -1).all()
        cur_i, cur_d = jnp.asarray(want[0]), jnp.asarray(want[1])


def test_reverse_dense_core_matches_reference(ref, data):
    """The level-0 reverse edges of one wave (the reference's forward
    selection of BB rows) on the imported graph with the wave's rows
    staged: the rows of the targets equal on >= 99 %, every other row
    bit-equal."""
    vecs, slots, lvls = _wave(ref, data[3], BB)
    st = ref.state
    v = np.array(st.vectors)
    v[slots] = vecs
    norms = np.array(st.norms)
    norms[slots] = np.asarray(jax_prep_norms(jnp.asarray(vecs)))
    q = jnp.asarray(vecs)
    cand_d, cand_i = _ref_level0_beam(st, q, jnp.sum(q * q, axis=1))
    sel_i, sel_d = _ref_heuristic(cand_i, jnp.where(cand_i >= 0, cand_d, jnp.inf),
                                  st.vectors[jnp.clip(cand_i, 0)], m_out=32,
                                  metric=JaxMetric.L2, alpha=1.0)
    dst, src, dd = jh._reverse_edges_prep(jnp.asarray(slots), jnp.ones(BB, bool), sel_i, sel_d)
    adj0 = np.array(st.adj0)
    want = np.asarray(jh._reverse_level_jit(jnp.array(adj0), jnp.asarray(v), jnp.asarray(norms),
                                            dst, src, dd, JaxMetric.L2))
    got = th._reverse_dense_core(torch.from_numpy(adj0.copy()), torch.from_numpy(v),
                                 torch.from_numpy(norms), torch.from_numpy(np.asarray(dst)),
                                 torch.from_numpy(np.asarray(src)),
                                 torch.from_numpy(np.asarray(dd)), Metric.L2).numpy()
    touched = np.zeros(len(adj0), bool)
    touched[np.asarray(dst)[np.asarray(dst) >= 0]] = True
    assert touched.sum() > BB
    np.testing.assert_array_equal(got[~touched], adj0[~touched])
    np.testing.assert_array_equal(want[~touched], adj0[~touched])
    assert (got[touched] == want[touched]).all(1).mean() >= 0.99


@pytest.mark.parametrize("entry, max_level, lvls, want", (
    (-1, -1, [0, 2, 2, 1], (11, 2)),      # the empty graph: the first of the top level
    (5, 2, [2, 2, 0], (5, 2)),            # a tie with max_level: no promotion
    (5, 1, [0, 3, 1, 3], (11, 3)),        # promotion to the first of the new top
    (7, 0, [0, 0], (7, 0)),
    (-1, -1, [0], (10, 0)),               # a single row into the empty graph
))
def test_entry_update_core_exact(entry, max_level, lvls, want):
    slots = np.arange(10, 10 + len(lvls), dtype=np.int32)
    lv = np.asarray(lvls, np.int32)
    ref_e, ref_m = jh._entry_update_core(jnp.int32(entry), jnp.int32(max_level),
                                         jnp.asarray(slots), jnp.asarray(lv),
                                         jnp.ones(len(lv), bool))
    got = th._entry_update_core(entry, max_level, slots, lv)
    assert got == (int(ref_e), int(ref_m)) == want


def test_insert_wave_matches_reference(ref, data):
    """One wave of NW rows into the imported graph: the reference pads it
    to BB lanes, the port does not."""
    vecs, slots, lvls = _wave(ref, data[3])
    r = _clone(ref)
    r._insert_wave(vecs, slots, lvls)
    port = _port_of(ref)
    port._insert_wave(torch.from_numpy(vecs), slots, lvls)
    rs, ps = r.state, port.state
    np.testing.assert_array_equal(ps.vectors.numpy(), np.asarray(rs.vectors))
    np.testing.assert_array_equal(ps.levels.numpy(), np.asarray(rs.levels))
    # 4 ulp: the two sum the 32 squares in different orders
    np.testing.assert_allclose(ps.norms.numpy(), np.asarray(rs.norms), rtol=4 * 2.0**-23)
    assert (ps.entry, ps.max_level) == (int(rs.entry), int(rs.max_level))
    for lvl, (a, b) in enumerate(zip(_levels(ps), _levels(rs))):
        assert (a == b).all(1).mean() >= 0.99, lvl


def test_padded_and_unpadded_waves_build_the_same_graph(ref, data):
    """The reference pads a wave to `build_batch` lanes with masked no-op
    lanes on a scratch slot; with build_batch equal to the wave there is
    no padding. Both build the same graph bit for bit, which is why the
    port never pads."""
    vecs, slots, lvls = _wave(ref, data[3])
    padded, unpadded = _clone(ref), _clone(ref)
    unpadded.build_batch = NW
    padded._insert_wave(vecs, slots, lvls)
    unpadded._insert_wave(vecs, slots, lvls)
    for a, b in zip(_levels(padded.state), _levels(unpadded.state)):
        np.testing.assert_array_equal(a, b)
    cap = ref.capacity
    for f in ("vectors", "norms", "levels"):
        a, b = np.asarray(getattr(padded.state, f)), np.asarray(getattr(unpadded.state, f))
        np.testing.assert_array_equal(a[:cap - 1], b[:cap - 1])   # all but the scratch slot
    assert int(padded.state.entry) == int(unpadded.state.entry)


def _level_by_level_wave(state, new_vecs, new_slots, new_levels, *, cfg, efc, iters):
    """`build_wave_impl` with its descent one K9 call a level, each level's
    walk just before that level's connections (the order the reference
    runs them in)."""
    slots, levels = np.asarray(new_slots, np.int64), np.asarray(new_levels, np.int32)
    sl = torch.as_tensor(slots)
    q, qn = th._stage_vectors_core(state.vectors, state.norms, state.levels, new_vecs, sl,
                                   torch.as_tensor(levels))
    cur_i, cur_d = th._seed_from_entry(state.vectors, state.norms, q, qn, state.entry,
                                       cfg.metric)
    fwd = {}
    for lvl in range(cfg.max_levels - 1, -1, -1):
        adj = th._level_adj(state, lvl)
        connect = (levels >= lvl) & (state.entry >= 0)
        if not connect.all():
            gi, gd = th._greedy_level(adj, state.vectors, state.norms, q, qn, cur_i, cur_d,
                                      cfg.metric)
            conn = torch.as_tensor(connect)
            cur_i, cur_d = torch.where(conn, cur_i, gi), torch.where(conn, cur_d, gd)
        cur_i, cur_d, sel_i, sel_d = th._wave_level_core(
            adj, state.vectors, state.norms, q, qn, cur_i, cur_d, connect, metric=cfg.metric,
            efc=efc, iters=iters, deg_out=cfg.m0 if lvl == 0 else cfg.m)
        th._write_forward(adj, sl, sel_i)
        if connect.any():
            fwd[lvl] = (sel_i, sel_d)
    src = sl.to(torch.int32)
    for lvl, (sel_i, sel_d) in sorted(fwd.items()):
        th._reverse_dense_core(th._level_adj(state, lvl), state.vectors, state.norms,
                               sel_i.reshape(-1), src[:, None].expand_as(sel_i).reshape(-1),
                               sel_d.reshape(-1), cfg.metric)
    entry, max_level = th._entry_update_core(state.entry, state.max_level, slots, levels)
    return state._replace(entry=entry, max_level=max_level)


def _same_state(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("start", ("imported", "empty"))
def test_single_descent_builds_the_level_by_level_graph(ref, data, monkeypatch, start):
    """The waves' descent in one launch before the level loop builds the
    graph that one walk a level, interleaved with the connections, builds,
    bit for bit: one wave of BB rows into the imported graph, and a whole
    build from empty (waves of 1, 2, 4, ... rows, the empty graph's first)."""
    built = []
    for impl in (th.build_wave_impl, _level_by_level_wave):
        monkeypatch.setattr(th, "build_wave_impl", impl)
        if start == "imported":
            idx = _port_of(ref)
            vecs, slots, lvls = _wave(ref, data[3], BB)
            idx._insert_wave(torch.from_numpy(vecs), slots, lvls)
        else:
            idx = th.HnswIndex(dim=DIM, ef_construction=EFC, build_batch=128,
                               bulk_threshold=10**9, device="cpu")
            idx.add(data[0][:700])
        built.append(idx.state)
    _same_state(*built)


@pytest.mark.parametrize("bb, batches", ((64, (1000, 300)), (512, (3, 5, 2000)), (7, (1, 40))))
def test_add_wave_schedule_matches_reference(monkeypatch, bb, batches):
    """The wave sizes of `add` (1, 2, 4, ... up to build_batch, never more
    than the graph holds) are the reference's, recorded by replacing
    `_insert_wave` in both packages."""
    sizes = {}
    for name, cls, kw in (("ref", jh.HnswIndex, {}), ("port", th.HnswIndex, {"device": "cpu"})):
        seen = sizes[name] = []
        monkeypatch.setattr(cls, "_insert_wave", lambda self, v, s, lv, seen=seen: seen.append(
            (int(s[0]), len(s))))
        idx = cls(dim=8, build_batch=bb, bulk_threshold=10**9, **kw)
        rng = np.random.default_rng(52)
        for n in batches:
            idx.add(rng.standard_normal((n, 8)).astype(np.float32))
    assert sizes["port"] == sizes["ref"]
    assert sum(n for _, n in sizes["port"]) == sum(batches)


def test_wave_build_from_empty(ref, data):
    x, q, truth, _ = data
    port = th.HnswIndex(dim=DIM, ef_construction=EFC, build_batch=BB, device="cpu")
    np.testing.assert_array_equal(port.add(x), np.arange(N))
    _, ids = port.search(q, k=10, ef=64)
    _, want = ref.search(q, k=10, ef=64)
    r, w = recall_of(ids, truth), recall_of(np.asarray(want), truth)
    assert r >= w - 0.02 and r >= 0.93, (r, w)
    assert (port.state.entry, port.state.max_level) == (int(ref.state.entry),
                                                        int(ref.state.max_level))
    # queried with its own rows the graph finds them
    _, self_ids = port.search(x[:20], k=1, ef=32)
    assert (self_ids[:, 0] == np.arange(20)).mean() >= 0.95


def test_wave_build_incremental(data):
    x, q, truth, _ = data
    rec = []
    for idx in (jh.HnswIndex(dim=DIM, ef_construction=EFC, build_batch=128),
                th.HnswIndex(dim=DIM, ef_construction=EFC, build_batch=128, device="cpu")):
        idx.add(x[:1000])
        idx.add(x[1000:])
        _, ids = idx.search(q, k=10, ef=64)
        rec.append(recall_of(np.asarray(ids), truth))
    assert rec[1] >= rec[0] - 0.02 and rec[1] >= 0.93, rec


def test_wave_build_empty_and_single():
    idx = th.HnswIndex(dim=8, device="cpu")
    d, i = idx.search(np.zeros((2, 8), np.float32), k=3)
    assert (i == -1).all() and np.isinf(d).all()
    idx.add(np.ones((1, 8), np.float32))
    assert (idx.state.entry, len(idx)) == (0, 1)
    d, i = idx.search(np.zeros((2, 8), np.float32), k=3)
    assert (i[:, 0] == 0).all() and (i[:, 1:] == -1).all()
    np.testing.assert_allclose(d[:, 0], 8.0)


def test_wave_build_cosine():
    """tests/test_hnsw.py's COSINE case (scaled copies are at distance 0),
    and recall@10 against a cosine oracle, within 0.02 of the reference's."""
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((800, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    flat = JaxFlat(dim=16, metric=JaxMetric.COSINE)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    rec = []
    for idx in (jh.HnswIndex(dim=16, metric=JaxMetric.COSINE, ef_construction=64),
                th.HnswIndex(dim=16, metric=Metric.COSINE, ef_construction=64, device="cpu")):
        idx.add(x)
        _, ids = idx.search(q, k=10, ef=64)
        rec.append(recall_of(np.asarray(ids), np.asarray(truth)))
    assert rec[1] >= rec[0] - 0.02 and rec[1] >= 0.93, rec
    _, ids = idx.search(x[:10] * 5.0, k=1, ef=64)
    assert (ids[:, 0] == np.arange(10)).mean() >= 0.9


@pytest.mark.parametrize("route", ("waves", "bulk"))
def test_vacuum_matches_reference(ref, data, route):
    """A quarter of the rows deleted, then vacuum: the 1500 survivors take
    the waves, or (bulk_threshold lowered to 1000) the bulk build."""
    x = data[0]
    r, port = _clone(ref), _port_of(ref)
    if route == "bulk":
        r.bulk_threshold = port.bulk_threshold = 1000
    dead = np.random.default_rng(53).choice(N, N // 4, replace=False)
    for idx in (r, port):
        idx.delete(dead)
    want, got = r.vacuum(), port.vacuum()
    np.testing.assert_array_equal(got, want)
    alive = np.setdiff1d(np.arange(N), dead)
    assert len(port) == len(alive) and port._descent_ef == r._descent_ef
    assert port._descent_ef == (32 if route == "bulk" else 1)
    # the deleted rows are gone: no row of the index lies at distance 0
    d, _ = port.search(x[dead[:64]], k=1, ef=64)
    assert (d[:, 0] > 1e-6).all()
    # the survivors find themselves under their new slots
    _, ids = port.search(x[alive[:200]], k=1, ef=64)
    assert (ids[:, 0] == got[alive[:200]]).mean() >= 0.95
