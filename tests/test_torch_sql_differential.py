"""Differential testing of the port's Database against the reference's.

Seeded random SQL scripts (a generator in the manner of
tests/test_sqlite_differential.py) run statement by statement through
`turdb_tpu.Database` and `turdb_tpu_torch.Database(device="cpu")`: DDL,
DML, joins, aggregates, transactions and rollback, upsert, JSON, views,
PRAGMAs, then a checkpoint, a close and a reopen. Every statement must give
both engines the same result: the same rows, columns and counts, or the
same error."""

import json
import random

import pytest

from turdb_tpu.database.api import Database as RefDatabase
from turdb_tpu_torch.database.api import Database as PortDatabase

NAMES = ["ann", "bob", "cat", "dan", None]
DDL = [
    "CREATE TABLE t (id BIGINT PRIMARY KEY, grp INT, val DOUBLE, name TEXT, doc JSONB)",
    "CREATE TABLE u (id BIGINT PRIMARY KEY, t_id BIGINT, qty INT NOT NULL)",
]


def _lit(v):
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return repr(v)


def _t_row(rng, i):
    grp = rng.randint(0, 5)
    doc = {"k": rng.choice(["x", "y", "z"]), "n": rng.randint(0, 9),
           "arr": list(range(rng.randint(0, 3)))}
    return (f"({i}, {grp}, {round(rng.uniform(-100, 100), 3)}, "
            f"{_lit(rng.choice(NAMES))}, {_lit(json.dumps(doc))})")


def _select(rng):
    g = rng.randint(0, 5)
    v = rng.randint(-60, 60)
    return rng.choice([
        f"SELECT id, grp, val, name FROM t WHERE val > {v} ORDER BY id",
        f"SELECT grp, COUNT(*), SUM(val), MIN(val), MAX(val) FROM t GROUP BY grp ORDER BY grp",
        f"SELECT name, COUNT(*) FROM t WHERE grp <> {g} GROUP BY name "
        f"HAVING COUNT(*) > 1 ORDER BY name",
        "SELECT t.id, u.qty FROM t JOIN u ON u.t_id = t.id ORDER BY t.id, u.id",
        "SELECT t.grp, SUM(u.qty) FROM t LEFT JOIN u ON u.t_id = t.id "
        "GROUP BY t.grp ORDER BY t.grp",
        f"SELECT id FROM t WHERE id IN (SELECT t_id FROM u WHERE qty > {rng.randint(0, 9)}) "
        "ORDER BY id",
        "SELECT doc ->> 'k', COUNT(*) FROM t GROUP BY doc ->> 'k' ORDER BY 1",
        "SELECT id, jsonb_typeof(doc -> 'arr'), jsonb_array_length(doc -> 'arr') "
        f"FROM t WHERE grp = {g} ORDER BY id",
        f"SELECT CASE WHEN val > 0 THEN 'p' ELSE 'n' END AS s, AVG(val) FROM t "
        "GROUP BY s ORDER BY s",
        f"SELECT id, val FROM t ORDER BY val DESC, id LIMIT {rng.randint(1, 8)}",
        "SELECT COALESCE(name, 'none'), upper(COALESCE(name, 'none')) FROM t ORDER BY id",
        "SELECT COUNT(DISTINCT grp), COUNT(name) FROM t",
        "SELECT * FROM v ORDER BY grp",
    ])


def _dml(rng, next_id):
    i = rng.randint(0, next_id + 3)
    g = rng.randint(0, 5)
    return rng.choice([
        f"INSERT INTO t VALUES {_t_row(rng, next_id)}",
        f"INSERT INTO t VALUES {_t_row(rng, i)}",                  # may collide
        f"INSERT INTO t VALUES {_t_row(rng, i)} ON CONFLICT (id) DO NOTHING",
        f"INSERT INTO t VALUES {_t_row(rng, i)} ON CONFLICT (id) DO UPDATE "
        "SET val = excluded.val, name = excluded.name",
        f"INSERT INTO u VALUES ({rng.randint(0, 10**6)}, {i}, {rng.randint(0, 9)})",
        f"UPDATE t SET val = val + {rng.randint(-5, 5)} WHERE grp = {g}",
        f"UPDATE t SET name = 'eve' WHERE id = {i} RETURNING id, name",
        f"DELETE FROM t WHERE id % {rng.randint(2, 9)} = {rng.randint(0, 1)} AND grp = {g}",
        f"DELETE FROM u WHERE qty < {rng.randint(0, 3)}",
        f"INSERT INTO u VALUES ({rng.randint(0, 10**6)}, {i}, NULL)",   # NOT NULL fails
    ])


def _script(seed: int) -> list[str]:
    rng = random.Random(seed)
    out = list(DDL)
    n = rng.randint(15, 40)
    out.append("INSERT INTO t VALUES " + ", ".join(_t_row(rng, i) for i in range(n)))
    out.append("INSERT INTO u VALUES " + ", ".join(
        f"({j}, {rng.randint(0, n)}, {rng.randint(0, 9)})" for j in range(n // 2)))
    out.append("CREATE VIEW v AS SELECT grp, COUNT(*) AS c FROM t GROUP BY grp")
    nxt = n
    for _ in range(50):
        r = rng.random()
        if r < 0.1:
            out.append("BEGIN")
            for _ in range(rng.randint(1, 4)):
                out.append(_dml(rng, nxt))
                nxt += 1
                out.append(_select(rng))
            out.append(rng.choice(["COMMIT", "ROLLBACK"]))
        elif r < 0.45:
            out.append(_dml(rng, nxt))
            nxt += 1
        elif r < 0.85:
            out.append(_select(rng))
        elif r < 0.9:
            out.append(rng.choice([
                "CREATE INDEX ig ON t (grp)", "DROP INDEX ig",
                "CREATE UNIQUE INDEX iq ON u (id, t_id)",
                "ALTER TABLE u ADD COLUMN note TEXT",
            ]))
        else:
            out.append(rng.choice([
                "PRAGMA synchronous", "PRAGMA synchronous = FULL", "PRAGMA ann_overfetch",
                "PRAGMA wal_checkpoint_threshold = 50", "PRAGMA wal_checkpoint_threshold",
                "PRAGMA wal_autoflush = off", "PRAGMA database_mode", "PRAGMA ann = off",
                "PRAGMA wal_frame_count", "SHOW ALL", "PRAGMA wal_checkpoint_threshold = 0",
            ]))
    return out


FINAL = [
    "SELECT * FROM t ORDER BY id",
    "SELECT * FROM u ORDER BY id",
    "SELECT grp, COUNT(*), SUM(val) FROM t GROUP BY grp ORDER BY grp",
    "SELECT * FROM v ORDER BY grp",
]


def _run(db, sql):
    try:
        r = db.execute(sql)
    except Exception as e:       # the same error is the same result
        return ("error", type(e).__name__, str(e))
    return ("ok", r.rows_affected, r.rows, r.columns)


@pytest.mark.parametrize("seed", range(24))
def test_random_script(seed, tmp_path):
    ref = RefDatabase.create(str(tmp_path / "ref"))
    port = PortDatabase.create(str(tmp_path / "port"), device="cpu")
    script = _script(seed)
    for sql in script:
        a, b = _run(ref, sql), _run(port, sql)
        assert a == b, f"seed {seed}: {sql}\nreference: {a}\nport: {b}"
    for db in (ref, port):
        if db._txn is not None:
            db.execute("ROLLBACK")
        db.checkpoint()
        db.close()
    ref = RefDatabase.open(str(tmp_path / "ref"))
    port = PortDatabase.open(str(tmp_path / "port"), device="cpu")
    for sql in FINAL:
        a, b = _run(ref, sql), _run(port, sql)
        assert a == b, f"seed {seed} after reopen: {sql}\nreference: {a}\nport: {b}"
    assert _run(port, FINAL[0])[0] == "ok"
    ref.close()
    port.close()
