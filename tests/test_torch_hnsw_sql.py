"""HNSW through SQL in the port against the reference: the HNSW cases of
tests/test_vector_sql.py and tests/test_recall50.py, on the same data
through `turdb_tpu.Database` and `turdb_tpu_torch.Database(device="cpu")`:
EXPLAIN's text is the same, the ANN recall is within RECALL_TOL of the
reference's, and filters, DELETE, UPDATE, transactions, the sq8 / sq16
stores, `PRAGMA ann_pack` and VACUUM work as they do there."""

import numpy as np
import pytest

from test_torch_vector_sql import (RECALL_TOL, Pair, _data, _exact, _explain, _ids, _recalls,
                                   recall50_case, vec_lit)

N = 400   # rows of the HNSW cases (the reference's wave build dominates their time)


def test_recall50_cosine_hnsw(tmp_path):
    recall50_case(tmp_path, "HNSW", n=800)


HNSW_STORES = {
    "f32": "",
    "sq8": "WITH (sq8 = true)",
    "sq16": "WITH (sq16 = true)",
}


@pytest.mark.parametrize("store", HNSW_STORES)
def test_hnsw_sql_path(store, tmp_path):
    x, q = _data(seed=77, n=N)
    pair = Pair(tmp_path, x)
    exact = _exact(pair, q)
    pair.both(f"CREATE INDEX ih ON docs USING HNSW (emb) {HNSW_STORES[store]}")
    assert "AnnIndexScan" in _explain(pair, q[0])
    ref_r, port_r = _recalls(pair, q, exact)
    assert port_r >= ref_r - RECALL_TOL, (store, ref_r, port_r)
    assert port_r >= 0.8, (store, port_r)
    a, b = pair.query(f"SELECT id, tag FROM docs WHERE tag = 'odd' "
                      f"ORDER BY emb <-> {vec_lit(x[10])} LIMIT 5")
    assert len(b) == len(a) == 5 and all(r[1] == "odd" for r in b)
    # the transaction's own delete is visible to it, and undone by ROLLBACK
    pair.both("BEGIN")
    pair.both("DELETE FROM docs WHERE id = 3")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[3])} LIMIT 1")
    assert a[0][0] != 3 and b[0][0] != 3
    pair.both("ROLLBACK")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[3])} LIMIT 1")
    assert a == b == [(3,)]
    far = x[50] + 100.0
    pair.both(f"UPDATE docs SET emb = {vec_lit(far)} WHERE id = 7")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(far)} LIMIT 1")
    assert a == b == [(7,)]
    pair.close()


def test_hnsw_selective_filter_and_ann_off(tmp_path):
    from turdb_tpu_torch.sql.engine import STATS

    x, _ = _data(seed=78, n=N)
    pair = Pair(tmp_path, x)
    pair.both("CREATE INDEX ih ON docs USING HNSW (emb)")
    before = STATS["ann_filtered_searches"]
    a, b = pair.query(f"SELECT id, grp FROM docs WHERE id % 6 = 0 "
                      f"ORDER BY emb <-> {vec_lit(x[12])} LIMIT 10")
    assert STATS["ann_filtered_searches"] == before + 1
    rare = np.arange(0, N, 6)
    d = ((x[rare] - x[12]) ** 2).sum(1)
    expect = set(rare[np.argsort(d)[:10]].tolist())
    assert len(b) == 10 and len(set(_ids(b)) & expect) >= len(set(_ids(a)) & expect) - 1
    pair.both("PRAGMA ann = off")
    assert "AnnIndexScan" not in _explain(pair, x[0])
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[0])} LIMIT 5")
    assert a == b
    pair.close()


def test_hnsw_ann_pack_and_vacuum(tmp_path):
    x, q = _data(seed=4, n=N)
    pair = Pair(tmp_path, x)
    exact = _exact(pair, q)
    pair.both("CREATE INDEX ih ON docs USING HNSW (emb)")
    a, b = pair.both("PRAGMA ann_pack = 'docs'")
    assert a.rows == b.rows and "ih" in b.rows[0][0]
    assert pair.port.catalog["main"]["docs"].hnsw["ih"].index.serve is not None
    ref_r, port_r = _recalls(pair, q, exact)
    assert port_r >= ref_r - RECALL_TOL and port_r >= 0.8, (ref_r, port_r)
    # a write drops the pack; the graph path answers
    pair.both(f"INSERT INTO docs VALUES ({N}, {vec_lit(x[37])}, 0, 'even')")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[37])} LIMIT 2")
    assert set(_ids(a)) == set(_ids(b)) == {37, N}
    assert pair.port.catalog["main"]["docs"].hnsw["ih"].index.serve is None
    # VACUUM compacts the graph to the live rows, once
    pair.both("DELETE FROM docs WHERE id % 10 < 8")
    pair.both("VACUUM")
    pair.both("VACUUM")
    sizes = [db.catalog["main"]["docs"].hnsw["ih"].index.size for db in (pair.ref, pair.port)]
    assert sizes[0] == sizes[1] == len([i for i in range(N + 1) if i % 10 >= 8])
    alive = np.array([i for i in range(N) if i % 10 >= 8])
    d = ((x[alive] - x[8]) ** 2).sum(1)
    expect = set(alive[np.argsort(d)[:10]].tolist())
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[8])} LIMIT 10")
    assert len(set(_ids(b)) & expect) >= max(9, len(set(_ids(a)) & expect) - 1)
    pair.close()
