"""System tables + PRAGMAs + EXPLAIN (reference schema/system_tables.rs:40-46,
pragma.rs:5-28, database/config.rs)."""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.engine import ROWID
from turdb_tpu_torch.sql.expr import Batch, Col
from turdb_tpu_torch.sql.lexer import SqlError
from turdb_tpu_torch.storage.wal import SyncMode
from turdb_tpu_torch.storage.wal import SyncMode


def system_table_batch(db, ref: A.TableRef) -> Batch:
    """Virtual tables under schema turdb_catalog (SQL-queryable
    observability, reference system_tables.rs:58-110)."""
    q = ref.alias or ref.name
    name = ref.name

    def build(cols: list[str], rows: list[tuple]) -> Batch:
        b = Batch(len(rows))
        for j, cn in enumerate(cols):
            arr = np.empty(len(rows), object)
            nulls = np.zeros(len(rows), bool)
            for i, r in enumerate(rows):
                if r[j] is None:
                    nulls[i] = True
                else:
                    arr[i] = r[j]
            from turdb_tpu_torch.sql.expr import _densify

            b.add(q, cn, _densify(Col(arr, nulls)))
        b.add(q, ROWID, Col(np.arange(1, len(rows) + 1, dtype=np.int64)))
        return b

    if name == "memory_stats":
        # reference schema: key-value (stat_name PK, stat_value BIGINT,
        # updated_at TEXT) with the stat names of system_tables.rs:89-97
        import datetime as _dt

        now = _dt.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        used = {p: db.budget.used(p)
                for p in ("cache", "query", "recovery", "schema")}
        used_total = sum(used.values())
        rows = [("memory_budget_total", db.budget.total, now)]
        rows += [(f"memory_used_{p}", u, now) for p, u in used.items()]
        rows += [
            ("memory_used_shared", 0, now),
            ("memory_used_total", used_total, now),
            ("memory_available_shared", db.budget.total - used_total, now),
        ]
        return build(["stat_name", "stat_value", "updated_at"], rows)
    if name == "wal_stats":
        # reference schema: key-value with the names of
        # system_tables.rs:99-105
        import datetime as _dt

        now = _dt.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        rows = [
            ("wal_frame_count", db.wal.frame_count, now),
            ("wal_size_bytes", db.wal.size_bytes, now),
            ("wal_checkpoint_threshold", db.checkpoint_threshold, now),
            ("wal_last_checkpoint_frames",
             getattr(db, "last_checkpoint_frames", 0), now),
            ("wal_segment_count", len(db.wal._segments()), now),
        ]
        return build(["stat_name", "stat_value", "updated_at"], rows)
    if name == "tables":
        rows = []
        for schema, tables in db.catalog.items():
            for tname, info in tables.items():
                read_ts = db.mgr.snapshot_ts()
                nrows = len(info.table.visible_indices(db.mgr, read_ts))
                rows.append(
                    (schema, tname, "table", info.table.table_id, nrows,
                     info.table.nversions)
                )
        for schema, views in db.views.items():
            for vname in views:
                rows.append((schema, vname, "view", None, None, None))
        return build(
            ["schema", "name", "kind", "table_id", "row_count",
             "version_count"], rows
        )
    if name == "statistics":
        # ANALYZE output (reference lexes ANALYZE; PostgreSQL pg_stats
        # shape, reduced): one row per analyzed column
        rows = []
        for (schema, tname), st in sorted(getattr(db, "stats", {}).items()):
            for col, cs in st["columns"].items():
                rows.append((
                    schema, tname, col, st["rows"], cs["n_distinct"],
                    round(cs["null_frac"], 4), st["analyzed_at"],
                ))
        return build(
            ["schema", "table", "column", "row_count", "n_distinct",
             "null_frac", "analyzed_at"], rows
        )
    if name == "views":
        rows = [
            (schema, v.name, v.sql)
            for schema, views in db.views.items()
            for v in views.values()
        ]
        return build(["schema", "name", "definition"], rows)
    if name == "columns":
        rows = []
        for schema, tables in db.catalog.items():
            for tname, info in tables.items():
                for pos, c in enumerate(info.columns):
                    rows.append(
                        (schema, tname, c.name, c.dtype.name, pos,
                         c.nullable, c.primary_key)
                    )
        return build(
            ["schema", "table", "name", "type", "position", "nullable",
             "primary_key"],
            rows,
        )
    if name == "indexes":
        rows = []
        for schema, tables in db.catalog.items():
            for tname, info in tables.items():
                for iname, d in info.index_defs.items():
                    size = (
                        len(info.hnsw[iname].index)
                        if iname in info.hnsw
                        else len(info.btree.get(iname, []))
                    )
                    rows.append(
                        (schema, tname, iname, d.using, d.unique, size,
                         d.where_text)
                    )
        return build(
            ["schema", "table", "name", "using", "is_unique", "entries",
             "predicate"], rows
        )
    if name == "transactions":
        rows = [
            (t.txn_id, t.read_ts, len(t.write_set))
            for t in db.mgr.active.values()
        ]
        return build(["txn_id", "read_ts", "write_set_size"], rows)
    if name == "types":
        rows = []
        for schema, types in db.types.items():
            for tname, td in types.items():
                if td["kind"] == "enum":
                    detail = ",".join(td["values"])
                elif td["kind"] == "domain":
                    detail = td["base"]
                else:
                    detail = ",".join(f[0] for f in td["fields"])
                rows.append((schema, tname, td["kind"], detail))
        return build(["schema", "name", "kind", "detail"], rows)
    if name == "functions":
        rows = [
            (schema, nm, ",".join(fd["params"]), fd["returns"], fd["body"])
            for schema, fns in db.functions.items()
            for nm, fd in fns.items()
        ]
        return build(["schema", "name", "params", "returns", "body"], rows)
    if name == "procedures":
        rows = [
            (schema, nm, ",".join(pd["params"]), pd["body"])
            for schema, prs in db.procedures.items()
            for nm, pd in prs.items()
        ]
        return build(["schema", "name", "params", "body"], rows)
    if name == "triggers":
        rows = [
            (schema, nm, td["table"], td["timing"],
             ",".join(td["events"]), td.get("level", "ROW"), td.get("when"))
            for schema, trs in db.triggers.items()
            for nm, td in trs.items()
        ]
        return build(
            ["schema", "name", "table", "timing", "events", "level",
             "when"], rows
        )
    if name == "grants":
        rows = [
            (g["grantee"], ",".join(g["privileges"]), g["object_type"],
             g["object_name"], g["grant_option"])
            for g in db.grants
        ]
        return build(
            ["grantee", "privileges", "object_type", "object_name",
             "grant_option"], rows
        )
    raise SqlError(f"no such system table: turdb_catalog.{name}")


def execute_pragma(db, p: A.Pragma):
    """PRAGMAs (reference pragma.rs: wal, wal_autoflush, synchronous,
    checkpoint, memory_stats, database_mode, recover_wal + ANN knobs)."""
    from turdb_tpu_torch.database.api import ExecuteResult

    name = p.name.lower()
    v = p.value

    def show(value):
        return ExecuteResult(rows=[(value,)], columns=[name])

    if name == "__show_all":
        # SHOW ALL (reference ShowStmt.all): every scalar setting
        settings = [
            ("wal", db.wal_enabled),
            ("wal_autoflush", db.wal_autoflush),
            ("synchronous", db.sync_mode.value),
            ("wal_checkpoint_threshold", db.checkpoint_threshold),
            ("database_mode", db.mode),
            ("ann", db.ann_enabled),
            ("ann_overfetch", db.ann_overfetch),
            ("memory_budget", db.budget.total),
            ("join_memory_budget", db.join_budget_override),
            ("timing", db.timing_enabled
             if hasattr(db, "timing_enabled") else False),
        ]
        return ExecuteResult(
            rows=[(k, str(val)) for k, val in settings],
            columns=["name", "setting"],
        )

    if name == "wal":
        if v is None:
            return show(db.wal_enabled)
        db.wal_enabled = _as_bool(v)
        db._refresh_durable_hook()
        return show(db.wal_enabled)
    if name == "wal_autoflush":
        if v is None:
            return show(db.wal_autoflush)
        db.wal_autoflush = _as_bool(v)
        return show(db.wal_autoflush)
    if name == "synchronous":
        if v is None:
            return show(db.sync_mode.value)
        db.sync_mode = SyncMode(str(v).lower())
        db.wal.sync_mode = db.sync_mode
        db._refresh_durable_hook()
        return show(db.sync_mode.value)
    if name == "wal_checkpoint_threshold":
        # get/set the auto-checkpoint frame threshold (reference
        # pragma.rs:241-257; wal.rs:278)
        if v is not None:
            try:
                threshold = int(str(v).strip("'\""))
            except ValueError:
                raise SqlError(
                    f"invalid PRAGMA wal_checkpoint_threshold value: {v} "
                    "(use a number)"
                )
            if threshold <= 0:
                raise SqlError(
                    "invalid PRAGMA wal_checkpoint_threshold value: "
                    f"{threshold} (must be positive)"
                )
            db.checkpoint_threshold = threshold
        return show(db.checkpoint_threshold)
    if name in ("checkpoint", "wal_checkpoint"):
        ci = db.checkpoint()
        return ExecuteResult(
            rows=[(ci.frames_checkpointed, ci.wal_truncated)],
            columns=["frames_checkpointed", "wal_truncated"],
        )
    if name == "ann_pack":
        # PRAGMA ann_pack = 'table': build the serving pack (packed
        # int8 neighbor blocks + cell probe + exact rerank — see
        # models/hnsw_serve.py) for every HNSW index on the table;
        # subsequent ANN queries take the packed fast path until the
        # next graph mutation invalidates it.
        if v is None:
            return show(None)
        tname = str(v).strip("'\"")
        packed = []
        for tables in db.catalog.values():
            info = tables.get(tname)
            if info is None:
                continue
            for iname, h in info.hnsw.items():
                if hasattr(h, "pack"):
                    h.pack()
                    packed.append(iname)
        return ExecuteResult(rows=[(",".join(packed),)], columns=[name])
    if name == "wal_frame_count":
        return show(db.wal.frame_count)
    if name == "wal_size":
        return show(db.wal.size_bytes)
    if name == "memory_stats":
        return ExecuteResult(
            rows=db.budget.stats(),
            columns=["pool", "budget_bytes", "used_bytes"],
        )
    if name in ("__reset", "__reset_all"):
        # RESET <knob> | RESET ALL (reference parser.rs:3069): restore
        # session-settable knobs to their defaults
        defaults = {
            "wal_autoflush": ("wal_autoflush", True),
            "synchronous": ("sync_mode", SyncMode.NORMAL),
            "ann": ("ann_enabled", True),
            "ann_overfetch": ("ann_overfetch", 4),
            "join_memory_budget": ("join_budget_override", None),
        }
        if name == "__reset_all":
            for attr, dv in defaults.values():
                setattr(db, attr, dv)
            db.wal.sync_mode = db.sync_mode
            db._refresh_durable_hook()
            return show("ok")
        knob = str(v)
        if knob not in defaults:
            raise SqlError(f"unknown setting: {knob}")
        attr, dv = defaults[knob]
        setattr(db, attr, dv)
        if knob == "synchronous":
            db.wal.sync_mode = db.sync_mode
            db._refresh_durable_hook()
        return show("ok")
    if name == "memory_budget":
        return show(db.budget.total)
    if name == "join_memory_budget":
        # reference pragma.rs: caps the join/query operator pool; spills
        # (Grace partitioning) kick in above it
        if v is None:
            return show(db.join_budget_override or db.budget.pool("query"))
        db.join_budget_override = max(int(v), 0) or None
        return show(db.join_budget_override or db.budget.pool("query"))
    if name == "database_mode":
        return show("ReadWrite" if db.mode == "rw" else "ReadOnlyDegraded")
    if name == "recover_wal":
        if db.mode == "rw":
            return show("ok")
        db.mode = "rw"
        db._replay_wal()
        db._rebuild_indexes()
        return show("recovered")
    if name == "ann":
        if v is None:
            return show(db.ann_enabled)
        db.ann_enabled = _as_bool(v)
        return show(db.ann_enabled)
    if name == "ann_overfetch":
        if v is None:
            return show(db.ann_overfetch)
        db.ann_overfetch = int(v)
        return show(db.ann_overfetch)
    if name == "spill_stats":
        from turdb_tpu_torch.sql.engine import STATS

        return ExecuteResult(
            rows=[(k, int(val)) for k, val in STATS.items()],
            columns=["stat", "value"],
        )
    if name == "timing_stats":
        from turdb_tpu_torch.utils.timing import timing_stats

        return ExecuteResult(
            rows=timing_stats(),
            columns=["phase", "total_ms", "count", "avg_us"],
        )
    if name == "timing_reset":
        from turdb_tpu_torch.utils.timing import reset

        reset()
        return show("ok")
    if name == "vacuum":
        n = 0
        for tables in db.catalog.values():
            for info in tables.values():
                n += info.table.vacuum(db.mgr)
        return show(n)
    raise SqlError(f"unknown pragma: {p.name}")


def _as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    return str(v).lower() in ("on", "true", "1", "yes")


def explain_plan(db, stmt) -> list[str]:
    """Textual plan tree (reference EXPLAIN, database/config.rs). SELECTs
    render the physical plan IR (sql/plan.py) — built by the SAME decision
    helpers the executor calls, so the printed operators are the executed
    operators."""
    from turdb_tpu_torch.sql.plan import plan_select

    lines: list[str] = []

    def emit(depth, text):
        lines.append("  " * depth + text)

    def select(sel: A.Select, depth):
        for ln in plan_select(db, sel).render():
            emit(depth, ln)

    if isinstance(stmt, A.Select):
        select(stmt, 0)
    elif isinstance(stmt, A.Insert):
        emit(0, f"Insert {stmt.table.name}"
             + (f" ({len(stmt.values)} rows)" if stmt.values else " (from query)"))
        if stmt.query:
            select(stmt.query, 1)
    elif isinstance(stmt, A.Update):
        emit(0, f"Update {stmt.table.name}")
        if stmt.where is not None:
            emit(1, f"Filter {A.render_expr(stmt.where)}")
    elif isinstance(stmt, A.Delete):
        emit(0, f"Delete {stmt.table.name}")
        if stmt.where is not None:
            emit(1, f"Filter {A.render_expr(stmt.where)}")
    else:
        emit(0, type(stmt).__name__)
    return lines
