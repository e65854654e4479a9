"""Live inserts into a bulk-built HNSW graph (`HnswIndex.add` after the
bulk load): the waves descend the upper levels as the graph's own search
does, so the rows they acknowledge are found again.

- A bulk graph over 4,488 make_pool rows (128-d, 5 blobs of ~1,000 rows,
  `default_rng(1)`: about the least size at which a bulk graph's level 0
  falls into one island per blob, so that a greedy descent goes astray)
  takes 512 more rows in waves of 128 through `add`; after each wave a
  query set of 100 is judged against the exact k-NN of the rows
  acknowledged so far (`portbench/reference/knn.py`, TF32 off): recall@10
  at ef 80; then every streamed row is read back (its own id among the k
  answers to its own vector). With the waves' descent greedy, as the
  reference's waves take it into a bulk graph too, 0.8105 of the rows read
  back (recall@10 0.940-0.951 a wave); with the search's beam, 1.0
  (0.954-0.964). (At 4,000 rows and 4 blobs, and at 8,000 and 8, the
  greedy descent read 0.969 and 0.900.)
- A graph whose descent is greedy (`descent_ef` 1: built by waves, or
  read from a file that records no descent) builds the graph it built
  before the beam descent existed, bit for bit: `_greedy_wave` below is
  that `build_wave_impl`, kept as the yardstick.
"""

import copy

import numpy as np
import pytest
import torch

from portbench.reference.knn import exact_knn
from turdb_tpu_torch.models import hnsw as th
from turdb_tpu_torch.utils.datasets import make_pool

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N, DIM, BLOBS, STREAM, WAVE, NQ, K, EF = 5000, 128, 5, 512, 128, 100, 10, 80
N_BULK = N - STREAM


@pytest.fixture(scope="module")
def pool():
    x = make_pool(np.random.default_rng(1), N + 4 * NQ, DIM, n_clusters=BLOBS)
    return x[:N], x[N:].reshape(4, NQ, DIM)


@pytest.fixture(scope="module")
def bulk(pool):
    idx = th.HnswIndex(dim=DIM, ef_construction=100, build_batch=512, capacity=N,
                       bulk_threshold=1024, device="cpu")
    idx.add(pool[0][:N_BULK])
    assert idx._descent_ef == 32
    return idx


def _clone(idx):
    c = copy.copy(idx)
    st = idx.state
    c.state = st._replace(vectors=st.vectors.clone(), norms=st.norms.clone(),
                          adj0=st.adj0.clone(), adj_hi=tuple(a.clone() for a in st.adj_hi),
                          levels=st.levels.clone())
    c._alive = idx._alive.copy()
    return c


def stream(idx, x, query_sets):
    """Each wave through `add`, then a query set judged against the exact
    k-NN of the rows acknowledged so far; then every streamed row read
    back. Returns (the read-back share, recall@10 a query set)."""
    acked, recalls = N_BULK, []
    for w, q in zip(range(N_BULK, N, WAVE), query_sets):
        np.testing.assert_array_equal(idx.add(x[w:w + WAVE]), np.arange(w, w + WAVE))
        acked += WAVE
        _, ids = idx.search(q, K, ef=EF)
        _, truth = exact_knn(torch.from_numpy(x[:acked]), torch.from_numpy(q), K)
        assert ids.max() < acked
        recalls.append(float(np.mean([len(set(a) & set(b)) / K
                                      for a, b in zip(ids, truth.numpy())])))
    _, ids = idx.search(x[N_BULK:], K, ef=EF)
    return float((ids == np.arange(N_BULK, N)[:, None]).any(1).mean()), recalls


def test_acknowledged_rows_are_found_again(bulk, pool):
    readback, recalls = stream(_clone(bulk), *pool)
    assert readback >= 0.98, readback
    assert min(recalls) >= 0.93, recalls


def _greedy_wave(state, new_vecs, new_slots, new_levels, *, cfg, efc, iters):
    """`build_wave_impl` as it was before the beam descent: the greedy
    descent in one K9 launch, the level loop, the reverse edges, the
    entry point."""
    slots = np.asarray(new_slots, np.int64)
    levels = np.asarray(new_levels, np.int32)
    sl, lv = torch.as_tensor(slots), torch.as_tensor(levels)
    q, qn = th._stage_vectors_core(state.vectors, state.norms, state.levels, new_vecs, sl, lv)
    cur_i, cur_d = th._seed_from_entry(state.vectors, state.norms, q, qn, state.entry, cfg.metric)
    if state.entry >= 0 and (levels < len(state.adj_hi)).any():
        cur_i, cur_d = th._greedy_level(state.adj_hi[::-1], state.vectors, state.norms, q, qn,
                                        cur_i, cur_d, cfg.metric, lowest=lv)
    fwd = {}
    for lvl in range(cfg.max_levels - 1, -1, -1):
        adj = th._level_adj(state, lvl)
        connect = (levels >= lvl) & (state.entry >= 0)
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


def _states_equal(a, b):
    for u, v in zip(a, b):
        if isinstance(u, tuple):
            assert all(torch.equal(s, t) for s, t in zip(u, v))
        elif isinstance(u, torch.Tensor):
            assert torch.equal(u, v)
        else:
            assert u == v


@pytest.mark.parametrize("start", ("empty", "bulk_without_descent"))
def test_a_greedy_graph_builds_todays_graph(bulk, pool, monkeypatch, start):
    """Waves from empty (a graph built by waves), and a wave into the bulk
    graph read as a file without `descent_ef` (1): the index's own path
    builds what `_greedy_wave` builds, and never takes the beam descent."""
    x = pool[0]
    built = []
    for impl in (None, _greedy_wave):
        if impl is not None:
            monkeypatch.setattr(th, "build_wave_impl", impl)
        else:
            monkeypatch.setattr(th, "_beam_descent", None)   # a call would raise
        if start == "empty":
            idx = th.HnswIndex(dim=DIM, ef_construction=64, build_batch=128,
                               bulk_threshold=10**9, device="cpu")
            idx.add(x[:256])
        else:
            idx = _clone(bulk)
            idx._descent_ef = 1
            idx.add(x[N_BULK:N_BULK + 64])
        built.append(idx.state)
        monkeypatch.undo()
    _states_equal(*built)
