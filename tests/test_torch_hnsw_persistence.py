""".hnsw snapshots in the port: tests/test_hnsw_persistence.py's cases
(the snapshot loads and is not rebuilt; rows only in the WAL are
reindexed), and database directories that either package opens.

For the f32, SQ8 and SQ16 stores, a directory written by one package opens
in the other: the snapshot loads, the graph arrays (adj0, adj_hi, levels,
alive, the codes or the rows) come back bit-equal to the writer's, and the
queries answer with the writer's ids. This pins the SQ16 codes, int16 bits
in the port and uint16 in the file and the reference."""

import os

import numpy as np
import pytest

from turdb_tpu.database.api import Database as RefDatabase
from turdb_tpu_torch.database.api import Database as PortDatabase
from turdb_tpu_torch.ops.quantize import Sq8Rows

RNG = np.random.default_rng(31)


def vec_lit(v):
    return "'[" + ",".join(f"{x:.6f}" for x in v) + "]'"


def _port(path, create=False):
    return (PortDatabase.create if create else PortDatabase.open)(path, device="cpu")


def _ref(path, create=False):
    return (RefDatabase.create if create else RefDatabase.open)(path)


def test_snapshot_written_and_loaded(tmp_path):
    p = str(tmp_path / "db")
    db = _port(p, create=True)
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, emb VECTOR(8))")
    vecs = RNG.standard_normal((120, 8)).astype(np.float32)
    for i in range(120):
        db.execute(f"INSERT INTO t VALUES ({i}, {vec_lit(vecs[i])})")
    db.execute("CREATE INDEX ix ON t USING HNSW (emb)")
    db.close()
    assert os.path.exists(os.path.join(p, "main", "t.ix.hnsw"))

    db2 = _port(p)
    info = db2.catalog["main"]["t"]
    assert getattr(info, "_hnsw_loaded", False), "snapshot must load, not rebuild"
    h = info.hnsw["ix"]
    assert len(h.rowid_to_slot) == 120
    rows = db2.query(f"SELECT id FROM t ORDER BY emb <-> {vec_lit(vecs[13])} LIMIT 1")
    assert rows[0][0] == 13
    db2.close()


def test_incremental_reindex_after_wal(tmp_path):
    p = str(tmp_path / "db")
    db = _port(p, create=True)
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, emb VECTOR(8))")
    vecs = RNG.standard_normal((80, 8)).astype(np.float32)
    for i in range(60):
        db.execute(f"INSERT INTO t VALUES ({i}, {vec_lit(vecs[i])})")
    db.execute("CREATE INDEX ix ON t USING HNSW (emb)")
    db.checkpoint()
    for i in range(60, 80):          # rows only in the WAL
        db.execute(f"INSERT INTO t VALUES ({i}, {vec_lit(vecs[i])})")
    far = vecs[5] + 50.0
    db.execute(f"UPDATE t SET emb = {vec_lit(far)} WHERE id = 5")
    db.wal.flush()
    # crash (no close / checkpoint)
    db2 = _port(p)
    rows = db2.query(f"SELECT id FROM t ORDER BY emb <-> {vec_lit(vecs[70])} LIMIT 1")
    assert rows[0][0] == 70, "WAL-only row must be searchable after recovery"
    rows = db2.query(f"SELECT id FROM t ORDER BY emb <-> {vec_lit(far)} LIMIT 1")
    assert rows[0][0] == 5, "WAL-updated vector must be reindexed"
    db2.close()


def _arrays(h):
    """The snapshot's arrays of a table index of either package, as numpy
    (SQ16 codes as their uint16 bits)."""
    idx = h.index
    n = idx.size
    s = idx.state

    def host(a):
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        return a[:n]

    out = {"adj0": host(s.adj0), "levels": host(s.levels), "alive": idx._alive[:n].copy(),
           "entry": int(s.entry), "max_level": int(s.max_level)}
    for j, a in enumerate(s.adj_hi):
        out[f"adj_hi{j}"] = host(a)
    if hasattr(s.vectors, "codes"):
        codes = host(s.vectors.codes)
        out["codes"] = codes.view(np.uint16) if codes.dtype == np.int16 else codes
        out["mins"], out["scales"] = host(s.vectors.mins), host(s.vectors.scales)
        out["norms"] = host(s.norms)
    else:
        out["vectors"] = host(s.vectors)
    return out


STORES = {"f32": "", "sq8": "WITH (sq8 = true)", "sq16": "WITH (sq16 = true)"}


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_directory_opens_in_the_other_package(direction, store, tmp_path):
    write, read = (_ref, _port) if direction == "reference_to_port" else (_port, _ref)
    p = str(tmp_path / "db")
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((160, 8)).astype(np.float32)
    queries = rng.standard_normal((6, 8)).astype(np.float32)
    db = write(p, create=True)
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, emb VECTOR(8), tag TEXT)")
    db.bulk_insert("t", {"id": np.arange(160), "emb": vecs,
                         "tag": np.where(np.arange(160) % 2 == 0, "a", "b")})
    db.execute(f"CREATE INDEX ix ON t USING HNSW (emb) {STORES[store]}")
    db.execute("DELETE FROM t WHERE id = 3")
    sql = [f"SELECT id FROM t ORDER BY emb <-> {vec_lit(q)} LIMIT 5" for q in queries]
    want = [db.query(s) for s in sql]
    h = db.catalog["main"]["t"].hnsw["ix"]
    h.flush_pending()
    written = _arrays(h)
    db.close()

    db2 = read(p)
    info = db2.catalog["main"]["t"]
    assert getattr(info, "_hnsw_loaded", False), "snapshot must load, not rebuild"
    h2 = info.hnsw["ix"]
    if direction == "reference_to_port":
        assert isinstance(h2.index.state.vectors, Sq8Rows) == (store != "f32")
    loaded = _arrays(h2)
    assert loaded.keys() == written.keys()
    for k, v in written.items():
        got = loaded[k]
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype and np.array_equal(got, v), k
        else:
            assert got == v, k
    assert [db2.query(s) for s in sql] == want
    assert (3,) not in db2.query(f"SELECT id FROM t ORDER BY emb <-> {vec_lit(vecs[3])} "
                                 "LIMIT 3")
    db2.close()
