"""Vector search through SQL in the port against the reference: the exact
path and the IVF cases of tests/test_ivf_sql.py, tests/test_vector_sql.py
and tests/test_recall50.py, on the same data through `turdb_tpu.Database`
and `turdb_tpu_torch.Database(device="cpu")` (the HNSW cases are in
tests/test_torch_hnsw_sql.py).

The exact path's rows equal the reference's; EXPLAIN's text is the same;
the ANN recall (against the exact path) is within RECALL_TOL of the
reference's on the same queries; filters, DELETE, UPDATE, VACUUM's
rebuild and the sq8 / rerank / compact stores work as they do there."""

import numpy as np
import pytest

from turdb_tpu.database.api import Database as RefDatabase
from turdb_tpu_torch.database.api import Database as PortDatabase

RECALL_TOL = 0.05
N, DIM, NQ = 600, 16, 24


def vec_lit(v):
    return "'[" + ",".join(f"{x:.6f}" for x in v) + "]'"


def _data(seed=21, n=N, dim=DIM, blobs=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, dim)).astype(np.float32) * 3
    pool = (centers[rng.integers(0, blobs, n + NQ)]
            + rng.standard_normal((n + NQ, dim)).astype(np.float32)).astype(np.float32)
    return pool[:n], pool[n:]


class Pair:
    """One script, two engines."""

    def __init__(self, tmp_path, vecs, dim=DIM):
        self.ref = RefDatabase.create(str(tmp_path / "ref"))
        self.port = PortDatabase.create(str(tmp_path / "port"), device="cpu")
        self.both(f"CREATE TABLE docs (id BIGINT PRIMARY KEY, emb VECTOR({dim}), grp INT, "
                  "tag TEXT)")
        n = len(vecs)
        cols = {"id": np.arange(n), "emb": vecs, "grp": np.arange(n) % 3,
                "tag": np.where(np.arange(n) % 2 == 0, "even", "odd")}
        for db in (self.ref, self.port):
            db.bulk_insert("docs", dict(cols))

    def both(self, sql):
        return self.ref.execute(sql), self.port.execute(sql)

    def query(self, sql):
        return self.ref.query(sql), self.port.query(sql)

    def close(self):
        self.ref.close()
        self.port.close()


def _ids(rows):
    return [r[0] for r in rows]


def _recalls(pair, queries, exact, limit=10, op="<->"):
    """Each engine's recall@limit against the exact rows `exact`."""
    out = []
    for db in (pair.ref, pair.port):
        hits = [len(set(_ids(db.query(f"SELECT id FROM docs ORDER BY emb {op} {vec_lit(q)} "
                                      f"LIMIT {limit}"))) & set(e)) / limit
                for q, e in zip(queries, exact)]
        out.append(float(np.mean(hits)))
    return out


def _exact(pair, queries, limit=10, op="<->"):
    rows = [pair.query(f"SELECT id FROM docs ORDER BY emb {op} {vec_lit(q)} LIMIT {limit}")
            for q in queries]
    for a, b in rows:
        assert a == b
    return [_ids(a) for a, _ in rows]


def _explain(pair, q):
    a, b = pair.query(f"EXPLAIN SELECT id FROM docs ORDER BY emb <-> {vec_lit(q)} LIMIT 10")
    assert a == b
    return "\n".join(r[0] for r in a)


def test_exact_path_rows_equal(tmp_path):
    x, q = _data()
    pair = Pair(tmp_path, x)
    for sql in (
        f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(q[0])} LIMIT 10",
        f"SELECT id, emb <-> {vec_lit(q[1])} AS d FROM docs ORDER BY d LIMIT 5",
        f"SELECT id FROM docs ORDER BY emb <#> {vec_lit(q[2])} LIMIT 7",
        f"SELECT id, emb <=> {vec_lit(q[3])} FROM docs WHERE grp = 2 "
        f"ORDER BY emb <=> {vec_lit(q[3])} LIMIT 6",
        "SELECT vector_dims(emb) FROM docs LIMIT 1",
    ):
        a, b = pair.query(sql)
        assert a == b, sql
    pair.close()


IVF_STORES = {
    "f32": "WITH (nprobe = 8)",
    "sq8": "WITH (nprobe = 8, sq8 = true)",
    "sq8_rerank": "WITH (nprobe = 8, sq8 = true, rerank = 48)",
    "compact": "WITH (nprobe = 8, compact = true)",
}


@pytest.mark.parametrize("store", IVF_STORES)
def test_ivf_sql_path(store, tmp_path):
    x, q = _data()
    pair = Pair(tmp_path, x)
    exact = _exact(pair, q)
    pair.both(f"CREATE INDEX iv ON docs USING IVF (emb) {IVF_STORES[store]}")
    assert "AnnIndexScan" in _explain(pair, q[0])
    ref_r, port_r = _recalls(pair, q, exact)
    assert port_r >= ref_r - RECALL_TOL, (store, ref_r, port_r)
    assert port_r >= 0.8, (store, port_r)
    # filtered: the rows all pass the predicate, as many as the reference's
    a, b = pair.query(f"SELECT id, grp FROM docs WHERE grp = 1 "
                      f"ORDER BY emb <-> {vec_lit(x[9])} LIMIT 5")
    assert len(b) == len(a) == 5 and all(r[1] == 1 for r in b)
    # a deleted row does not come back; an updated row is found where it went
    pair.both("DELETE FROM docs WHERE id = 9")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[9])} LIMIT 1")
    assert b[0][0] != 9 and a[0][0] != 9
    far = x[50] + 40.0
    pair.both(f"UPDATE docs SET emb = {vec_lit(far)} WHERE id = 7")
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(far)} LIMIT 1")
    assert a == b == [(7,)]
    pair.close()


def test_ivf_vacuum_rebuild(tmp_path):
    x, _ = _data(seed=7, n=1200)
    pair = Pair(tmp_path, x)
    pair.both("CREATE INDEX ie ON docs USING IVF (emb)")
    pair.both("DELETE FROM docs WHERE id % 5 > 0")
    pair.both("VACUUM")
    sizes = [db.catalog["main"]["docs"].hnsw["ie"].index.size for db in (pair.ref, pair.port)]
    assert sizes == [1200 // 5] * 2
    alive = np.arange(0, 1200, 5)
    d = ((x[alive] - x[5]) ** 2).sum(1)
    expect = set(alive[np.argsort(d)[:10]].tolist())
    a, b = pair.query(f"SELECT id FROM docs ORDER BY emb <-> {vec_lit(x[5])} LIMIT 10")
    assert len(set(_ids(b)) & expect) >= len(set(_ids(a)) & expect) - 1
    assert len(set(_ids(b)) & expect) >= 9
    pair.close()


def recall50_case(tmp_path, using, n=1200):
    """tests/test_recall50.py's shape (normalized clustered embeddings,
    cosine, k = 50) through SQL, at a CPU size."""
    dim = 64
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((64, dim)).astype(np.float32) * 3.0
    pool = centers[rng.integers(0, 64, n + 8)] + rng.standard_normal((n + 8, dim))
    pool = (pool / np.linalg.norm(pool, axis=1, keepdims=True)).astype(np.float32)
    x, q = pool[:n], pool[n:]
    pair = Pair(tmp_path, x, dim=dim)
    exact = _exact(pair, q, limit=50, op="<=>")
    opts = "WITH (metric = 'cosine', nprobe = 32)" if using == "IVF" else \
        "WITH (metric = 'cosine')"
    pair.both(f"CREATE INDEX ix ON docs USING {using} (emb) {opts}")
    ref_r, port_r = _recalls(pair, q, exact, limit=50, op="<=>")
    assert port_r >= ref_r - RECALL_TOL, (ref_r, port_r)
    assert port_r >= 0.95, port_r
    pair.close()


def test_recall50_cosine_ivf(tmp_path):
    recall50_case(tmp_path, "IVF")
