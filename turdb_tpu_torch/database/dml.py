"""DML execution: INSERT/UPDATE/DELETE/TRUNCATE with the constraint
pipeline, index maintenance and RETURNING.

Mirrors reference src/database/dml/ (insert.rs:1-30 pipeline order:
DEFAULT → NOT NULL → CHECK → UNIQUE/PK probe → FK → write → secondary
indexes → HNSW maintenance → txn write entries; update.rs incl.
UPDATE..FROM; delete.rs FK checks + RETURNING), adapted to columnar
storage: the "record build + B-tree insert" steps become a column append
with MVCC stamps (storage/table.py).
"""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.engine import ROWID
from turdb_tpu_torch.sql.expr import Batch, Col, EvalContext, eval_expr, _py
from turdb_tpu_torch.sql.lexer import SqlError
from turdb_tpu_torch.types.datatype import DataType, StorageClass


def _cv(db):
    from turdb_tpu_torch.database.api import ConstraintViolation

    return ConstraintViolation


# ---------------------------------------------------------------------------
# INSERT
# ---------------------------------------------------------------------------


def execute_insert(db, stmt: A.Insert, params, txn):
    from turdb_tpu_torch.database.api import ExecuteResult

    iv = _instead_of_dispatch(db, stmt.table, "INSERT")
    if iv is not None:
        return _instead_of_insert(db, stmt, params, txn, *iv)
    info = db.resolve_table(stmt.table)
    ctx = db._ctx(params, txn)
    if (stmt.on_conflict is not None
            and isinstance(stmt.on_conflict[0], tuple)
            and stmt.on_conflict[0][:1] == ("constraint",)):
        # ON CONFLICT ON CONSTRAINT name (reference OnConflictTarget::
        # Constraint): the named unique index/PK must exist; the action
        # then applies to any unique conflict (same as the column form)
        cname = stmt.on_conflict[0][1]
        known = set(info.index_defs) | {f"{info.table.name}_pkey"}
        if cname not in known:
            raise SqlError(
                f"no such constraint on {info.table.name}: {cname}"
            )
    fire_statement_triggers(db, info, "INSERT", "BEFORE", ctx, txn)
    colnames = [c.name for c in info.columns]

    if stmt.columns is not None:
        for cn in stmt.columns:
            if cn not in colnames:
                raise SqlError(f"no such column: {cn}")
        target_cols = stmt.columns
    else:
        target_cols = colnames

    rows: list[dict] = []
    if stmt.values is not None:
        one = Batch(1)
        for vrow in stmt.values:
            if len(vrow) != len(target_cols):
                raise SqlError(
                    f"INSERT has {len(vrow)} values for {len(target_cols)} columns"
                )
            row = {}
            for cn, e in zip(target_cols, vrow):
                # literal fast path: skips a full vectorized eval per cell
                # (the reference's prepared-insert plan cache analog,
                # prepared.rs:106-136)
                if isinstance(e, A.Literal):
                    row[cn] = e.value
                elif isinstance(e, A.Param):
                    if e.index > len(params):
                        raise SqlError(f"missing bind parameter ${e.index}")
                    row[cn] = params[e.index - 1]
                else:
                    c = eval_expr(e, one, ctx)
                    row[cn] = None if c.nulls[0] else _py(c.values[0])
            rows.append(row)
    else:
        sub = db.engine.run_select(stmt.query, ctx)
        if len([1 for _, nm in sub.names if nm != ROWID]) != len(target_cols):
            raise SqlError("INSERT SELECT column count mismatch")
        keep = [i for i, (_, nm) in enumerate(sub.names) if nm != ROWID]
        for i in range(sub.n):
            row = {}
            for cn, j in zip(target_cols, keep):
                c = sub.cols[j]
                row[cn] = None if c.nulls[i] else _py(c.values[i])
            rows.append(row)

    inserted = 0
    conflicted_updates = 0
    out_rowids = []
    for row in rows:
        prepared = _prepare_row(db, info, row, ctx)
        conflict_rowid = _find_conflict(db, info, prepared, ctx)
        if conflict_rowid is not None:
            if stmt.on_conflict is None:
                raise _cv(db)(
                    f"UNIQUE constraint violated on {info.table.name}"
                )
            cols, action = stmt.on_conflict
            if action == "NOTHING":
                continue
            # DO UPDATE: assignments see the existing row + `excluded`
            _apply_conflict_update(db, info, conflict_rowid, action, prepared, ctx, txn)
            conflicted_updates += 1
            out_rowids.append(conflict_rowid)
            continue
        _check_fks(db, info, prepared, ctx)
        if info.table.name in db._trigger_tables:
            fire_triggers(db, info, "INSERT", "BEFORE", prepared, None,
                          ctx, txn)
        (rowid,) = info.table.insert_rows([prepared], txn)
        db._log_insert(info, rowid, prepared, txn)
        _index_insert(db, info, rowid, prepared)
        if info.table.name in db._trigger_tables:
            fire_triggers(db, info, "INSERT", "AFTER", prepared, None,
                          ctx, txn)
        out_rowids.append(rowid)
        inserted += 1

    fire_statement_triggers(db, info, "INSERT", "AFTER", ctx, txn)
    res = ExecuteResult(
        rows_affected=inserted + conflicted_updates,
        last_rowid=out_rowids[-1] if out_rowids else None,
    )
    if stmt.returning:
        res.columns, res.rows = _returning(db, info, out_rowids, stmt.returning, ctx)
    return res


def insert_plan_rows(db, info, binders, params, txn):
    """Execute a CachedInsertPlan's pre-bound rows: the reference's
    prepared-insert fast path (prepared.rs:106-158) — no parsing, no name
    resolution, no expression dispatch; just bind, validate, insert."""
    from turdb_tpu_torch.database.api import ExecuteResult

    ctx = db._ctx(params, txn)
    fire_statement_triggers(db, info, "INSERT", "BEFORE", ctx, txn)
    inserted = 0
    last = None
    for brow in binders:
        row = {}
        for cn, is_param, payload in brow:
            if is_param:
                if payload >= len(params):
                    raise SqlError(f"missing bind parameter ${payload + 1}")
                row[cn] = params[payload]
            else:
                row[cn] = payload
        prepared = _prepare_row(db, info, row, ctx)
        if _find_conflict(db, info, prepared, ctx) is not None:
            raise _cv(db)(f"UNIQUE constraint violated on {info.table.name}")
        _check_fks(db, info, prepared, ctx)
        if info.table.name in db._trigger_tables:
            fire_triggers(db, info, "INSERT", "BEFORE", prepared, None,
                          ctx, txn)
        (rowid,) = info.table.insert_rows([prepared], txn)
        db._log_insert(info, rowid, prepared, txn)
        _index_insert(db, info, rowid, prepared)
        if info.table.name in db._trigger_tables:
            fire_triggers(db, info, "INSERT", "AFTER", prepared, None,
                          ctx, txn)
        inserted += 1
        last = rowid
    fire_statement_triggers(db, info, "INSERT", "AFTER", ctx, txn)
    return ExecuteResult(rows_affected=inserted, last_rowid=last)


def eval_default(db, cd):
    if cd.default is None:
        return None
    e = cd.default
    if isinstance(e, str):
        from turdb_tpu_torch.database.api import _parse_expr

        e = _parse_expr(e)
    c = eval_expr(e, Batch(1), EvalContext([], db.engine._subquery_fn))
    return None if c.nulls[0] else _py(c.values[0])


def _prepare_row(db, info, row: dict, ctx) -> dict:
    """DEFAULT fill + auto-increment + NOT NULL + typed coercion + CHECK
    (the reference's ConstraintValidator pipeline, constraints/mod.rs:104)."""
    out = dict(row)
    for cd in info.columns:
        v = out.get(cd.name)
        if v is None:
            if cd.auto_increment:
                out[cd.name] = db.last_insert_id = info.table.auto_increment
                info.table.auto_increment += 1
                continue
            if cd.has_default:
                out[cd.name] = eval_default(db, cd)
                continue
        elif cd.auto_increment and isinstance(v, int):
            # explicit value: advance the counter past it so later
            # auto-fills never collide (MySQL semantics)
            if v >= info.table.auto_increment:
                info.table.auto_increment = v + 1
    for cd in info.columns:
        v = out.get(cd.name)
        if v is None and not cd.nullable:
            raise _cv(db)(
                f"NOT NULL constraint violated: {info.table.name}.{cd.name}"
            )
        if v is not None and cd.max_len is not None and len(str(v)) > cd.max_len:
            raise _cv(db)(
                f"value too long for {cd.name} (max {cd.max_len})"
            )
        if v is not None and cd.enum_values is not None and \
                v not in cd.enum_values:
            raise _cv(db)(
                f"invalid value for enum {cd.type_name or cd.name}: {v!r}"
            )
        if v is not None and isinstance(v, str) and cd.dtype in (
                DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
                DataType.TIMESTAMPTZ):
            # validate + canonicalize (reference parsing/literal.rs):
            # non-canonical text ('2024-1-1') breaks memcmp ordering
            from turdb_tpu_torch.sql.functions import parse_temporal

            try:
                out[cd.name] = parse_temporal(cd.dtype.name, v)
            except Exception:
                raise _cv(db)(
                    f"invalid {cd.dtype.name} for {cd.name}: {v!r}"
                )
        if v is not None and cd.dtype is DataType.INTERVAL and \
                isinstance(v, str):
            from turdb_tpu_torch.sql.functions import parse_temporal

            try:
                out[cd.name] = parse_temporal("INTERVAL", v)
            except Exception:
                raise _cv(db)(f"invalid interval for {cd.name}: {v!r}")
        if v is not None and cd.dtype is DataType.UUID:
            import uuid as _uuid

            try:
                out[cd.name] = str(
                    _uuid.UUID(v if isinstance(v, str) else bytes(v).hex())
                )
            except (ValueError, TypeError):
                raise _cv(db)(f"invalid UUID for {cd.name}: {v!r}")
        if v is not None and cd.dtype is DataType.VECTOR:
            arr = np.asarray(
                v if not isinstance(v, str) else _parse_vec(v), np.float32
            )
            if cd.vector_dim and arr.shape != (cd.vector_dim,):
                raise _cv(db)(
                    f"vector dimension mismatch for {cd.name}: "
                    f"got {arr.shape[0] if arr.ndim else 0}, want {cd.vector_dim}"
                )
            out[cd.name] = arr
        # column CHECK
        if cd.check is not None:
            if not _check_passes(db, info, cd.check, out, ctx):
                raise _cv(db)(
                    f"CHECK constraint violated on {info.table.name}.{cd.name}"
                )
    for chk in info.checks:
        if not _check_passes(db, info, chk, out, ctx):
            raise _cv(db)(f"CHECK constraint violated on {info.table.name}")
    _toast_row(db, info, out, ctx)
    return out


def _toast_row(db, info, row: dict, ctx):
    """Swap oversized TEXT/BLOB values for out-of-line pointers AFTER all
    constraint checks (reference insert pipeline: TOAST before record
    build, dml/insert.rs:1-30 + storage/toast.rs:70-73). Chunks are
    WAL-logged so replay can rebuild the store."""
    from turdb_tpu_torch.config import TOAST_THRESHOLD
    from turdb_tpu_torch.storage.toast import Toasted, is_pointer

    for cd in info.columns:
        sc = cd.dtype.storage_class
        if sc not in (StorageClass.TEXT, StorageClass.BYTES):
            continue
        v = row.get(cd.name)
        if v is None or isinstance(v, Toasted):
            continue
        if isinstance(v, str):
            raw = v.encode("utf-8")
            if len(raw) <= TOAST_THRESHOLD:
                continue
            text = True
        elif isinstance(v, (bytes, bytearray)):
            raw = bytes(v)
            # force-toast blobs that LOOK like pointers so the 0xFE
            # marker stays unambiguous in serialized records
            if len(raw) <= TOAST_THRESHOLD and not is_pointer(raw):
                continue
            text = False
        else:
            continue
        store = info.table.toast
        pointer = store.toast(raw)
        db._log_toast(info, pointer, raw, ctx)
        row[cd.name] = Toasted(pointer, store, text)
        info.table.toast_cols.add(cd.name)


def _parse_vec(s):
    from turdb_tpu_torch.sql.expr import parse_vector_text

    return parse_vector_text(s)


def _check_passes(db, info, expr, row: dict, ctx) -> bool:
    if isinstance(expr, str):
        from turdb_tpu_torch.database.api import _parse_expr

        expr = _parse_expr(expr)
    from turdb_tpu_torch.storage.toast import detoast_value

    b = Batch(1)
    for cd in info.columns:
        b.add(info.table.name, cd.name,
              Col.const(detoast_value(row.get(cd.name)), 1))
    c = eval_expr(expr, b, ctx)
    # NULL check result passes (SQL semantics)
    return bool(c.nulls[0] or c.values[0])


def _index_pred_match(db, info, name: str, row: dict, ctx) -> bool:
    """Partial-index predicate against one row (reference table.rs:273
    where_clause). NULL predicate = row NOT in the index (unlike CHECK,
    where NULL passes)."""
    expr = info.btree_where.get(name)
    if expr is None:
        return True
    from turdb_tpu_torch.storage.toast import detoast_value

    b = Batch(1)
    for cd in info.columns:
        b.add(info.table.name, cd.name,
              Col.const(detoast_value(row.get(cd.name)), 1))
    c = eval_expr(expr, b, ctx)
    return bool(not c.nulls[0] and c.values[0])


def _find_conflict(db, info, row: dict, ctx, exclude_rowid=None):
    """Probe unique indexes; returns conflicting (visible) rowid or None
    (reference unique probe, dml/insert.rs:602).

    `exclude_rowid` (UPDATE): skip the row being updated and KEEP
    SCANNING — returning the self-hit from one index (e.g. the
    unchanged PK) used to mask a real conflict on a later unique index
    (round-5 fix; tests/test_weakfixes.py
    test_ddl_after_prepare_rebinds + test_update_unique_second_index)."""
    read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
    own = getattr(ctx, "own_txn", 0)
    for name, idx in info.btree.items():
        if not idx.unique:
            continue
        # a partial unique index only constrains rows matching its
        # predicate — both the incoming row and the probed candidates
        if not _index_pred_match(db, info, name, row, ctx):
            continue
        cols = info.btree_cols[name]
        if cols is None:
            vals = _expr_key_vals_row(db, info, name, row)
        else:
            vals = [row.get(c) for c in cols]
        if any(v is None for v in vals):
            continue  # NULLs never conflict
        key = idx.make_key([_norm_key(v) for v in vals])
        for rid in idx.find(key):
            if exclude_rowid is not None and rid == exclude_rowid:
                continue
            vidx = info.table.visible_version(db.mgr, rid, read_ts, own)
            if vidx is None:
                continue
            # index entries persist until vacuum (MVCC: older snapshots
            # must still find their versions), so re-verify the visible
            # version actually carries this key
            cur_row = None
            if cols is None:
                cur_row = info.table.row_as_dict(vidx)
                cur_vals = _expr_key_vals_row(db, info, name, cur_row)
            else:
                cur_vals = [_vis_cell(info.table, c, vidx) for c in cols]
            cur = idx.make_key([_norm_key(v) for v in cur_vals])
            if cur != key:
                continue
            if name in info.btree_where:
                # the candidate's CURRENT version must still satisfy the
                # predicate (an UPDATE may have moved it out)
                if cur_row is None:
                    cur_row = info.table.row_as_dict(vidx)
                if not _index_pred_match(db, info, name, cur_row, ctx):
                    continue
            return rid
    return None


def _vis_cell(table, colname: str, vidx: int):
    if table.nulls[colname][vidx]:
        return None
    v = table.cols[colname][vidx]
    return _py(v)


def _norm_key(v):
    from turdb_tpu_torch.storage.toast import detoast_value

    v = detoast_value(v)
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return _py(v)


def _check_fks(db, info, row: dict, ctx):
    """Child-side FK existence probe (reference constraint pipeline)."""
    for cols, ref_table, ref_cols, _od, _ou in info.fks:
        vals = [row.get(c) for c in cols]
        if any(v is None for v in vals):
            continue
        parent = _resolve_parent(db, info, ref_table)
        if parent is None:
            raise SqlError(f"no such table: {ref_table}")
        pcols = ref_cols or _pk_cols(parent)
        if not pcols:
            raise SqlError(f"referenced table {ref_table} has no primary key")
        if not _parent_has(db, parent, pcols, vals, ctx):
            raise _cv(db)(
                f"FOREIGN KEY constraint violated: {info.table.name}"
                f"({','.join(cols)}) -> {ref_table}"
            )


def _resolve_parent(db, info, ref_table):
    return db.catalog.get(info.schema, {}).get(ref_table) or db.catalog["main"].get(
        ref_table
    )


def _pk_cols(info):
    for name, d in info.index_defs.items():
        if name.startswith("__pk_"):
            return info.btree_cols[name] or []
    return []


def _parent_has(db, parent, pcols, vals, ctx) -> bool:
    read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
    own = getattr(ctx, "own_txn", 0)
    # indexed probe when pcols matches a unique index
    for name, idx in parent.btree.items():
        if parent.btree_cols[name] is not None and \
                parent.btree_cols[name] == list(pcols):
            key = idx.make_key([_norm_key(v) for v in vals])
            for rid in idx.find(key):
                vidx = parent.table.visible_version(db.mgr, rid, read_ts, own)
                if vidx is not None and idx.make_key(
                    [_norm_key(_vis_cell(parent.table, c, vidx)) for c in pcols]
                ) == key:
                    return True
            return False
    # fallback scan
    vis = parent.table.visible_indices(db.mgr, read_ts, own)
    for i in vis:
        if all(
            not parent.table.nulls[c][i]
            and _py(parent.table.cols[c][int(i)]) == _py(v)
            for c, v in zip(pcols, vals)
        ):
            return True
    return False


def _expr_key_vals_row(db, info, name, row: dict):
    """Evaluate an expression index's exprs against one row dict
    (reference ddl.rs expression indexes)."""
    from turdb_tpu_torch.storage.toast import detoast_value

    b = Batch(1)
    for cd in info.columns:
        b.add(
            info.table.name, cd.name,
            Col.const(detoast_value(row.get(cd.name)), 1),
        )
    ctx = db._ctx([], None)
    out = []
    for e in info.btree_exprs[name]:
        c = eval_expr(e, b, ctx)
        out.append(None if c.nulls[0] else _py(c.values[0]))
    return out


def _batch_unique_check_expr(db, info, name, prepared: dict, n: int, ctx):
    """Unique validation for an expression index over a columnar batch:
    one vectorized eval over the batch, then per-row key probes."""
    from turdb_tpu_torch.database.indexes import SortedKeyIndex  # noqa: F401

    idx = info.btree[name]
    read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
    own = getattr(ctx, "own_txn", 0)
    b = Batch(n)
    for cd in info.columns:
        vals, nulls = prepared.get(cd.name, (None, None))
        if vals is None:
            b.add(info.table.name, cd.name, Col.const(None, n))
        else:
            b.add(info.table.name, cd.name, Col(vals, nulls))
    ectx = db._ctx([], None)
    cols_out = [eval_expr(e, b, ectx) for e in info.btree_exprs[name]]
    seen = set()
    for i in range(n):
        vals = [
            None if c.nulls[i] else _py(c.values[i]) for c in cols_out
        ]
        if any(v is None for v in vals):
            continue
        key = idx.make_key([_norm_key(v) for v in vals])
        if key in seen:
            raise _cv(db)(
                f"UNIQUE constraint violated on {info.table.name}"
            )
        seen.add(key)
        for rid in idx.find(key):
            vidx = info.table.visible_version(db.mgr, rid, read_ts, own)
            if vidx is None:
                continue
            cur_vals = _expr_key_vals_row(
                db, info, name, info.table.row_as_dict(vidx)
            )
            if idx.make_key([_norm_key(v) for v in cur_vals]) == key:
                raise _cv(db)(
                    f"UNIQUE constraint violated on {info.table.name}"
                )


def _index_insert(db, info, rowid: int, row: dict, txn=None):
    ctx = db._ctx([], txn) if info.btree_where else None
    for name, idx in info.btree.items():
        if name in info.btree_where and not _index_pred_match(
            db, info, name, row, ctx
        ):
            continue   # partial index: row outside the predicate
        cols = info.btree_cols[name]
        if cols is None:     # expression index (reference ddl.rs)
            vals = _expr_key_vals_row(db, info, name, row)
            key = idx.make_key([_norm_key(v) for v in vals])
        else:
            key = idx.make_key([_norm_key(row.get(c)) for c in cols])
        idx.insert(key, rowid)
    for h in info.hnsw.values():
        v = row.get(h.column)
        if v is not None:
            h.insert(rowid, np.asarray(v, np.float32), defer=True, txn=txn)


def _index_delete(db, info, rowid: int, row: dict):
    """Index entries are NOT removed at DML time: older snapshots must
    still find their versions through the index (the probe walks the
    version chain and re-verifies values/visibility), exactly like the
    table keeps dead versions until vacuum. VACUUM reindexes. The HNSW
    graph is likewise APPEND-ONLY — deleted rowids are excluded by the
    visibility mask every ANN search passes, so a rollback needs no graph
    surgery and vacuum reclaims stale vectors later."""


def _apply_conflict_update(db, info, rowid, assignments, excluded_row, ctx, txn):
    from turdb_tpu_torch.storage.toast import detoast_value

    vidx = info.table.latest[rowid]
    b = Batch(1)
    for cd in info.columns:
        cur = (
            None
            if info.table.nulls[cd.name][vidx]
            else detoast_value(info.table._get(cd, vidx))
        )
        b.add(info.table.name, cd.name, Col.const(cur, 1))
        b.add("excluded", cd.name,
              Col.const(detoast_value(excluded_row.get(cd.name)), 1))
    # PostgreSQL DO UPDATE scoping: unqualified names bind to the TARGET
    # row; the proposed row needs the explicit `excluded.` qualifier
    # (reference regression_smoke_test.rs:579 `SET counter = counter + 1`)
    import dataclasses

    colnames = {cd.name for cd in info.columns}

    def qualify(node):
        if isinstance(node, A.ColumnRef):
            if node.table is None and node.name in colnames:
                return dataclasses.replace(node, table=info.table.name)
            return node
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            ch = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                nv = qualify(v)
                if nv is not v:
                    ch[f.name] = nv
            return dataclasses.replace(node, **ch) if ch else node
        if isinstance(node, list):
            return [qualify(x) for x in node]
        if isinstance(node, tuple):
            return tuple(qualify(x) for x in node)
        return node

    changes = {}
    for cn, e in assignments:
        c = eval_expr(qualify(e), b, ctx)
        changes[cn] = None if c.nulls[0] else _py(c.values[0])
    _do_update_row(db, info, rowid, changes, ctx, txn)


# ---------------------------------------------------------------------------
# UPDATE
# ---------------------------------------------------------------------------


def execute_update(db, stmt: A.Update, params, txn):
    from turdb_tpu_torch.database.api import ExecuteResult

    iv = _instead_of_dispatch(db, stmt.table, "UPDATE")
    if iv is not None:
        return _instead_of_update(db, stmt, params, txn, *iv)
    info = db.resolve_table(stmt.table)
    ctx = db._ctx(params, txn)
    fire_statement_triggers(db, info, "UPDATE", "BEFORE", ctx, txn)
    # point/range UPDATE takes the same index probe SELECT uses (the
    # reference plans DML scans through index_selection.rs too); the
    # WHERE is re-applied below, so a superset candidate batch is safe
    src = None
    if stmt.from_ is None and stmt.where is not None:
        src = db._try_index_scan(stmt.table, stmt.where, ctx)
    if src is None:
        src = db._scan_batch(stmt.table, ctx)
    if stmt.from_ is not None:
        right = db.engine._from(stmt.from_, ctx)
        from turdb_tpu_torch.sql.engine import _cross_join, _hash_join, _split_equi

        # plan the WHERE as a join condition: equality conjuncts linking
        # the target table to the FROM source become a hash equi-join
        # (reference dml/update.rs:1-25 plans UPDATE..FROM as a join);
        # only the residual falls back to cross-join + filter
        equis, residual = (
            _split_equi(stmt.where, src, right)
            if stmt.where is not None
            else ([], None)
        )
        if equis:
            src = _hash_join(src, right, equis, residual, "inner", ctx)
        else:
            src = _cross_join(src, right, None, ctx)
            if stmt.where is not None:
                c = eval_expr(stmt.where, src, ctx)
                src = src.take(
                    np.flatnonzero(c.values.astype(bool) & ~c.nulls)
                )
    elif stmt.where is not None:
        c = eval_expr(stmt.where, src, ctx)
        src = src.take(np.flatnonzero(c.values.astype(bool) & ~c.nulls))

    q = stmt.table.alias or stmt.table.name
    rid_col = src.resolve(ROWID, q)
    # evaluate assignments against matched rows
    n = src.n
    per_row_changes: dict[int, dict] = {}
    assign_cols = {}
    for cn, e in stmt.assignments:
        if not any(c.name == cn for c in info.columns):
            raise SqlError(f"no such column: {cn}")
        assign_cols[cn] = eval_expr(e, src, ctx)
    affected = []
    seen = set()
    for i in range(n):
        rowid = int(rid_col.values[i])
        if rowid in seen:
            continue  # UPDATE..FROM with multiple matches: first wins
        seen.add(rowid)
        changes = {}
        for cn, c in assign_cols.items():
            changes[cn] = None if c.nulls[i] else _py(c.values[i])
        _do_update_row(db, info, rowid, changes, ctx, txn)
        affected.append(rowid)

    fire_statement_triggers(db, info, "UPDATE", "AFTER", ctx, txn)
    res = ExecuteResult(rows_affected=len(affected))
    if stmt.returning:
        res.columns, res.rows = _returning(db, info, affected, stmt.returning, ctx)
    return res


def _do_update_row(db, info, rowid: int, changes: dict, ctx, txn):
    vidx = info.table.latest[rowid]
    old_row = info.table.row_as_dict(vidx)
    new_row = dict(old_row)
    new_row.update(changes)
    new_row = _prepare_row(db, info, new_row, ctx)
    # unique probe excluding self (the self-hit must not short-circuit
    # the scan of OTHER unique indexes)
    conflict = _find_conflict(db, info, new_row, ctx, exclude_rowid=rowid)
    if conflict is not None:
        raise _cv(db)(f"UNIQUE constraint violated on {info.table.name}")
    _check_fks(db, info, new_row, ctx)
    # ON UPDATE actions for children referencing a changed key: RESTRICT
    # raises here; CASCADE/SET NULL defer until the parent row is updated
    # (the child's own FK re-check must see the NEW parent key)
    deferred = _plan_parent_fk_updates(
        db, info, old_row, new_row, set(changes), ctx, txn
    )
    if info.table.name in db._trigger_tables:
        fire_triggers(db, info, "UPDATE", "BEFORE", new_row, old_row,
                      ctx, txn)
    if not info.table.update_row(rowid, new_row, txn):
        return
    db._log_update(info, rowid, new_row, txn)
    _index_delete(db, info, rowid, old_row)
    _index_insert(db, info, rowid, new_row, txn=txn)
    for run in deferred:
        run()
    if info.table.name in db._trigger_tables:
        fire_triggers(db, info, "UPDATE", "AFTER", new_row, old_row,
                      ctx, txn)


def _plan_parent_fk_updates(db, parent_info, old_row, new_row, changed,
                            ctx, txn):
    """ON UPDATE CASCADE / SET NULL / RESTRICT when a REFERENCED key
    changes (reference dml/update.rs:1925-2000 enforces only FKs that
    declare an ON UPDATE action; tests/constraints_cascade.rs:460-528).
    RESTRICT raises immediately; the cascading child updates return as
    deferred closures to run after the parent row is written."""
    pname = parent_info.table.name
    deferred = []
    for tables in db.catalog.values():
        for child in tables.values():
            for cols, ref_table, ref_cols, _od, on_update in child.fks:
                if ref_table != pname or on_update is None:
                    continue
                pcols = ref_cols or _pk_cols(parent_info)
                if not pcols or not any(c in changed for c in pcols):
                    continue
                old_vals = [old_row.get(c) for c in pcols]
                new_vals = [new_row.get(c) for c in pcols]
                if old_vals == new_vals or any(v is None for v in old_vals):
                    continue
                read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
                own = getattr(ctx, "own_txn", 0)
                vis = child.table.visible_indices(db.mgr, read_ts, own)
                matches = [
                    int(child.table.rowids[i])
                    for i in vis
                    if all(
                        not child.table.nulls[c][i]
                        and _py(child.table.cols[c][int(i)]) == _py(v)
                        for c, v in zip(cols, old_vals)
                    )
                ]
                if not matches:
                    continue
                action = on_update.upper()
                if action == "CASCADE":
                    upd = dict(zip(cols, new_vals))
                elif action == "SET NULL":
                    upd = {c: None for c in cols}
                else:  # RESTRICT / NO ACTION
                    raise _cv(db)(
                        f"FOREIGN KEY constraint: rows in "
                        f"{child.table.name} reference {pname}"
                    )

                def run(child=child, matches=matches, upd=upd):
                    for rid in matches:
                        if rid in child.table.latest:
                            _do_update_row(db, child, rid, dict(upd),
                                           ctx, txn)

                deferred.append(run)
    return deferred


# ---------------------------------------------------------------------------
# DELETE
# ---------------------------------------------------------------------------


def execute_delete(db, stmt: A.Delete, params, txn):
    from turdb_tpu_torch.database.api import ExecuteResult

    iv = _instead_of_dispatch(db, stmt.table, "DELETE")
    if iv is not None:
        return _instead_of_delete(db, stmt, params, txn, *iv)
    info = db.resolve_table(stmt.table)
    ctx = db._ctx(params, txn)
    fire_statement_triggers(db, info, "DELETE", "BEFORE", ctx, txn)
    src = None
    if stmt.using is None and stmt.where is not None:
        # index point/range probe before falling back to a full scan
        src = db._try_index_scan(stmt.table, stmt.where, ctx)
    if src is None:
        src = db._scan_batch(stmt.table, ctx)
    if stmt.using is not None:
        # DELETE .. USING (reference ast.rs:318 / parser.rs:1739):
        # plan like UPDATE..FROM — equality conjuncts linking the target
        # to the USING source become a hash equi-join; residual filters
        right = db.engine._from(stmt.using, ctx)
        from turdb_tpu_torch.sql.engine import _cross_join, _hash_join, _split_equi

        equis, residual = (
            _split_equi(stmt.where, src, right)
            if stmt.where is not None
            else ([], None)
        )
        if equis:
            src = _hash_join(src, right, equis, residual, "inner", ctx)
        else:
            src = _cross_join(src, right, None, ctx)
            if stmt.where is not None:
                c = eval_expr(stmt.where, src, ctx)
                src = src.take(
                    np.flatnonzero(c.values.astype(bool) & ~c.nulls)
                )
    elif stmt.where is not None:
        c = eval_expr(stmt.where, src, ctx)
        src = src.take(np.flatnonzero(c.values.astype(bool) & ~c.nulls))
    q = stmt.table.alias or stmt.table.name
    rid_col = src.resolve(ROWID, q)

    # RETURNING data must be captured before deletion; USING joins can
    # match a target row more than once — delete it once
    ret = None
    rowids = list(dict.fromkeys(int(r) for r in rid_col.values))
    if stmt.returning:
        ret = _returning(db, info, rowids, stmt.returning, ctx)

    count = 0
    for rowid in rowids:
        vidx = info.table.latest.get(rowid)
        if vidx is None:
            continue
        row = info.table.row_as_dict(vidx)
        _enforce_child_fks(db, info, row, ctx, txn)
        if info.table.name in db._trigger_tables:
            fire_triggers(db, info, "DELETE", "BEFORE", None, row, ctx, txn)
        if info.table.delete_row(rowid, txn):
            db._log_delete(info, rowid, txn)
            _index_delete(db, info, rowid, row)
            if info.table.name in db._trigger_tables:
                fire_triggers(db, info, "DELETE", "AFTER", None, row,
                              ctx, txn)
            count += 1
    fire_statement_triggers(db, info, "DELETE", "AFTER", ctx, txn)
    res = ExecuteResult(rows_affected=count)
    if ret is not None:
        res.columns, res.rows = ret
    return res


def _enforce_child_fks(db, parent_info, parent_row: dict, ctx, txn):
    """Parent-side FK enforcement: RESTRICT / CASCADE / SET NULL
    (reference constraints cascade tests, tests/constraints_cascade.rs)."""
    pname = parent_info.table.name
    for tables in db.catalog.values():
        for child in tables.values():
            for cols, ref_table, ref_cols, on_delete, _ou in child.fks:
                if ref_table != pname:
                    continue
                pcols = ref_cols or _pk_cols(parent_info)
                if not pcols:
                    continue
                pvals = [parent_row.get(c) for c in pcols]
                if any(v is None for v in pvals):
                    continue
                read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
                own = getattr(ctx, "own_txn", 0)
                vis = child.table.visible_indices(db.mgr, read_ts, own)
                matches = [
                    int(child.table.rowids[i])
                    for i in vis
                    if all(
                        not child.table.nulls[c][i]
                        and _py(child.table.cols[c][int(i)]) == _py(v)
                        for c, v in zip(cols, pvals)
                    )
                ]
                if not matches:
                    continue
                action = (on_delete or "RESTRICT").upper()
                if action == "CASCADE":
                    for rid in matches:
                        vidx = child.table.latest.get(rid)
                        if vidx is None:
                            continue
                        crow = child.table.row_as_dict(vidx)
                        _enforce_child_fks(db, child, crow, ctx, txn)
                        if child.table.delete_row(rid, txn):
                            db._log_delete(child, rid, txn)
                            _index_delete(db, child, rid, crow)
                elif action == "SET NULL":
                    for rid in matches:
                        _do_update_row(
                            db, child, rid, {c: None for c in cols}, ctx, txn
                        )
                else:  # RESTRICT / NO ACTION
                    raise _cv(db)(
                        f"FOREIGN KEY constraint: rows in {child.table.name} "
                        f"reference {pname}"
                    )


# ---------------------------------------------------------------------------
# TRUNCATE / RETURNING
# ---------------------------------------------------------------------------


def execute_truncate(db, stmt: A.Truncate, txn):
    from turdb_tpu_torch.database.api import ExecuteResult

    info = db.resolve_table(stmt.table)
    ctx = db._ctx([], txn)
    read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
    vis = info.table.visible_indices(db.mgr, read_ts, getattr(ctx, "own_txn", 0))
    count = 0
    for i in vis:
        rowid = int(info.table.rowids[i])
        row = info.table.row_as_dict(int(i))
        if info.table.delete_row(rowid, txn):
            db._log_delete(info, rowid, txn)
            _index_delete(db, info, rowid, row)
            count += 1
    if stmt.restart_identity:
        info.table.auto_increment = 1
    return ExecuteResult(rows_affected=count)


def _returning(db, info, rowids, items, ctx):
    b = Batch(len(rowids))
    cols_data = {c.name: ([], []) for c in info.columns}
    for rowid in rowids:
        vidx = info.table.latest.get(rowid)
        for c in info.columns:
            vals, nulls = cols_data[c.name]
            if vidx is None:
                vals.append(None)
                nulls.append(True)
            else:
                from turdb_tpu_torch.storage.toast import detoast_value

                isnull = bool(info.table.nulls[c.name][vidx])
                vals.append(
                    None if isnull else detoast_value(info.table._get(c, vidx))
                )
                nulls.append(isnull)
    for c in info.columns:
        vals, nulls = cols_data[c.name]
        arr = np.empty(len(vals), object)
        for i, v in enumerate(vals):
            arr[i] = v
        from turdb_tpu_torch.sql.expr import _densify

        b.add(info.table.name, c.name, _densify(Col(arr, np.asarray(nulls, bool))))
    out_cols, out_rows = [], []
    ob = Batch(b.n)
    for it in items:
        if isinstance(it.expr, A.Star):
            for (q, nm), c in zip(b.names, b.cols):
                ob.add(None, nm, c)
            continue
        c = eval_expr(it.expr, b, ctx)
        from turdb_tpu_torch.sql.engine import _output_name

        ob.add(None, it.alias or _output_name(it.expr), c)
    from turdb_tpu_torch.database.api import _batch_to_rows

    return _batch_to_rows(ob)


def bulk_insert_columns(db, info, data: dict, txn):
    """Columnar fast load (reference fast_load.rs FastLoader, 4-6x; here
    ~50x): vectorized NOT NULL + CHECK over the whole batch, one array
    append, ONE columnar WAL frame. Tables with unique indexes or FKs
    fall back to the per-row pipeline (their probes are inherently
    per-key)."""
    from turdb_tpu_torch.database.api import ExecuteResult

    n = len(np.asarray(next(iter(data.values()))))
    if info.fks or info.table.name in db._trigger_tables:
        # child-side FK probes and trigger firing stay per-row
        rows = _columns_to_rows(info, data, n)
        return bulk_insert_rows(db, info, rows, txn)

    ctx = db._ctx([], txn)
    colnames = {c.name for c in info.columns}
    for name in data:
        if name not in colnames:
            raise SqlError(f"no such column: {name}")
    prepared: dict = {}
    for cd in info.columns:
        if cd.name in data:
            v = data[cd.name]
            vals, nulls = v if isinstance(v, tuple) else (np.asarray(v), None)
            vals = np.asarray(vals)
            if nulls is None:
                nulls = (
                    np.asarray([x is None for x in vals], bool)
                    if vals.dtype == object else np.zeros(n, bool)
                )
        elif cd.auto_increment:
            vals = np.arange(
                info.table.auto_increment, info.table.auto_increment + n,
                dtype=np.int64,
            )
            info.table.auto_increment += n
            nulls = np.zeros(n, bool)
        elif cd.has_default:
            dv = eval_default(db, cd)
            if dv is None:
                vals, nulls = np.zeros(n, object), np.ones(n, bool)
            else:
                vals = np.full(n, dv) if not isinstance(dv, (list, np.ndarray)) \
                    else np.stack([np.asarray(dv)] * n)
                nulls = np.zeros(n, bool)
        else:
            vals, nulls = np.zeros(n, object), np.ones(n, bool)
        if nulls.any() and not cd.nullable:
            raise _cv(db)(
                f"NOT NULL constraint violated: {info.table.name}.{cd.name}"
            )
        if cd.max_len is not None and vals.dtype == object:
            for x, nu in zip(vals, nulls):
                if not nu and len(str(x)) > cd.max_len:
                    raise _cv(db)(f"value too long for {cd.name} (max {cd.max_len})")
        if cd.enum_values is not None and n:
            ok = set(cd.enum_values)
            for x, nu in zip(vals, nulls):
                if not nu and x not in ok:
                    raise _cv(db)(
                        f"invalid value for enum "
                        f"{cd.type_name or cd.name}: {x!r}"
                    )
        prepared[cd.name] = (vals, nulls)

    checks = [
        (cd.name, cd.check) for cd in info.columns if cd.check is not None
    ] + [(None, chk) for chk in info.checks]
    if checks and n:
        b = Batch(n)
        for cd in info.columns:
            vals, nulls = prepared[cd.name]
            b.add(info.table.name, cd.name, Col(vals, nulls))
        for cname, chk in checks:
            expr = chk
            if isinstance(expr, str):
                from turdb_tpu_torch.database.api import _parse_expr

                expr = _parse_expr(expr)
            c = eval_expr(expr, b, ctx)
            ok = c.values.astype(bool) | c.nulls  # NULL passes (SQL)
            if not ok.all():
                where = f".{cname}" if cname else ""
                raise _cv(db)(
                    f"CHECK constraint violated on {info.table.name}{where}"
                )

    _batch_unique_check(db, info, prepared, n, ctx)
    rowids = info.table.insert_columns(prepared, txn)
    db._log_bulk_insert(info, rowids, prepared, txn)
    if info.btree:
        # secondary indexes (incl. unique): one sorted rebuild beats n probes
        db._reindex(info, txn, hnsw=False)
    for h in info.hnsw.values():
        vals, nulls = prepared.get(h.column, (None, None))
        if vals is None:
            continue
        for rid, x, nu in zip(rowids.tolist(), vals, nulls):
            if not nu:
                h.insert(rid, np.asarray(x, np.float32), defer=True, txn=txn)
        h.flush_pending()
    return ExecuteResult(
        rows_affected=int(n),
        last_rowid=int(rowids[-1]) if n else None,
    )


def _batch_unique_check(db, info, prepared: dict, n: int, ctx):
    """Vectorized unique-constraint validation for the columnar fast
    load (round-2: a PK index used to force the whole batch onto the
    per-row pipeline — 3k rows/s vs the fast path's 100k+). Key bytes
    come from the batch numeric encoder when every key column is
    numeric; dup detection is one set pass; existing-key probes are set
    membership + the same MVCC re-verification as _find_conflict."""
    from turdb_tpu_torch.records.keys import encode_num_batch

    read_ts = getattr(ctx, "read_ts", db.mgr.snapshot_ts())
    own = getattr(ctx, "own_txn", 0)
    for name, idx in info.btree.items():
        if not idx.unique:
            continue
        if name in info.btree_where:
            # partial unique index: per-row predicate + probe (the
            # vectorized key path can't see the predicate)
            cols_p = info.btree_cols[name]
            seen = set()
            for r in _columns_to_rows(info, prepared, n):
                if not _index_pred_match(db, info, name, r, ctx):
                    continue
                if cols_p is not None:
                    vals = [r.get(c) for c in cols_p]
                else:
                    vals = _expr_key_vals_row(db, info, name, r)
                if any(v is None for v in vals):
                    continue
                k = idx.make_key([_norm_key(v) for v in vals])
                if k in seen or _find_conflict(db, info, r, ctx) is not None:
                    raise _cv(db)(
                        f"UNIQUE constraint violated on {info.table.name}"
                    )
                seen.add(k)
            continue
        cols = info.btree_cols[name]
        if cols is None:
            _batch_unique_check_expr(db, info, name, prepared, n, ctx)
            continue
        if any(c not in prepared for c in cols):
            continue
        null_any = np.zeros(n, bool)
        for c in cols:
            null_any |= prepared[c][1]
        live = np.flatnonzero(~null_any)     # NULLs never conflict
        if len(live) == 0:
            continue
        parts = []
        fast = all(
            prepared[c][0].dtype.kind in "iuf" for c in cols
        )
        if fast:
            for c in cols:
                parts.append(encode_num_batch(prepared[c][0]))
            keys = [
                b"".join(p[i] for p in parts) for i in live
            ]
        else:
            keys = [
                idx.make_key(
                    [_norm_key(prepared[c][0][i]) for c in cols]
                )
                for i in live
            ]
        if len(set(keys)) != len(keys):
            raise _cv(db)(
                f"UNIQUE constraint violated on {info.table.name}"
            )
        existing = idx.key_set()
        if not existing:
            continue
        for k in keys:
            if k not in existing:
                continue
            # persisted entries may be dead versions: re-verify exactly
            # as the per-row probe does
            for rid in idx.find(k):
                vidx = info.table.visible_version(db.mgr, rid, read_ts, own)
                if vidx is None:
                    continue
                cur = idx.make_key(
                    [_norm_key(_vis_cell(info.table, c, vidx)) for c in cols]
                )
                if cur == k:
                    raise _cv(db)(
                        f"UNIQUE constraint violated on {info.table.name}"
                    )


def _columns_to_rows(info, data: dict, n: int) -> list[dict]:
    cols = {}
    for name, v in data.items():
        vals, nulls = v if isinstance(v, tuple) else (np.asarray(v), None)
        vals = np.asarray(vals)
        lst = [_py(x) for x in vals] if vals.dtype == object else vals.tolist()
        if nulls is not None:
            lst = [None if nu else x for x, nu in zip(lst, nulls)]
        cols[name] = lst
    return [
        {name: lst[i] for name, lst in cols.items()} for i in range(n)
    ]


def bulk_insert_rows(db, info, rows: list[dict], txn):
    """Batched insert pipeline: per-row constraint checks (shared context),
    one columnar append, batched WAL frames, deferred index maintenance."""
    from turdb_tpu_torch.database.api import ExecuteResult

    ctx = db._ctx([], txn)
    fire = info.table.name in db._trigger_tables
    fire_statement_triggers(db, info, "INSERT", "BEFORE", ctx, txn)
    prepared = []
    for row in rows:
        p = _prepare_row(db, info, dict(row), ctx)
        if _find_conflict(db, info, p, ctx) is not None:
            raise _cv(db)(f"UNIQUE constraint violated on {info.table.name}")
        _check_fks(db, info, p, ctx)
        if fire:
            fire_triggers(db, info, "INSERT", "BEFORE", p, None, ctx, txn)
        prepared.append(p)
    rowids = info.table.insert_rows(prepared, txn)
    for rowid, p in zip(rowids, prepared):
        db._log_insert(info, rowid, p, txn)
        _index_insert(db, info, rowid, p)
        if fire:
            fire_triggers(db, info, "INSERT", "AFTER", p, None, ctx, txn)
    for h in info.hnsw.values():
        h.flush_pending()
    fire_statement_triggers(db, info, "INSERT", "AFTER", ctx, txn)
    return ExecuteResult(
        rows_affected=len(rowids),
        last_rowid=rowids[-1] if rowids else None,
    )


# ---------------------------------------------------------------------------
# MERGE (reference ast.rs:635 MergeStmt — parsed there, executed here)
# ---------------------------------------------------------------------------


def execute_merge(db, stmt, params, txn):
    """MERGE INTO target USING source ON cond: equi-join target x source,
    apply the FIRST matching WHEN MATCHED clause per matched target row
    (UPDATE/DELETE; a target row matched by MULTIPLE source rows errors,
    PostgreSQL semantics), then WHEN NOT MATCHED THEN INSERT for source
    rows with no match (values evaluate against the source row)."""
    from turdb_tpu_torch.database.api import ExecuteResult
    from turdb_tpu_torch.sql.engine import (
        ROWID,
        _cross_join,
        _hash_join,
        _split_equi,
    )
    from turdb_tpu_torch.sql.expr import Col

    info = db.resolve_table(stmt.target)
    ctx = db._ctx(params, txn)
    tgt = db._scan_batch(stmt.target, ctx)
    srcb = db.engine._from(stmt.source, ctx)
    srcb.add(None, "#mergesrc", Col(np.arange(srcb.n, dtype=np.int64)))

    equis, residual = _split_equi(stmt.on, tgt, srcb)
    if equis:
        joined = _hash_join(tgt, srcb, equis, residual, "INNER", ctx)
    else:
        joined = _cross_join(tgt, srcb, stmt.on, ctx)

    q = stmt.target.alias or stmt.target.name
    rid_col = joined.resolve(ROWID, q)
    src_col = joined.resolve("#mergesrc")
    rowids = [int(r) for r in rid_col.values]
    matched_src = {int(s) for s in src_col.values}

    has_matched = any(c[0] in ("update", "delete") for c in stmt.clauses)
    if has_matched and len(set(rowids)) != len(rowids):
        raise _cv(db)(
            "MERGE: a target row matched more than one source row"
        )

    affected = 0
    matched_clause = next(
        (c for c in stmt.clauses if c[0] in ("update", "delete")), None
    )
    if matched_clause is not None and joined.n:
        if matched_clause[0] == "update":
            assign_cols = {}
            for cn, e in matched_clause[1]:
                if not any(c.name == cn for c in info.columns):
                    raise SqlError(f"no such column: {cn}")
                assign_cols[cn] = eval_expr(e, joined, ctx)
            for i, rowid in enumerate(rowids):
                changes = {
                    cn: (None if c.nulls[i] else _py(c.values[i]))
                    for cn, c in assign_cols.items()
                }
                _do_update_row(db, info, rowid, changes, ctx, txn)
                affected += 1
        else:
            for rowid in rowids:
                vidx = info.table.latest.get(rowid)
                if vidx is None:
                    continue
                row = info.table.row_as_dict(vidx)
                _enforce_child_fks(db, info, row, ctx, txn)
                if info.table.name in db._trigger_tables:
                    fire_triggers(db, info, "DELETE", "BEFORE", None, row,
                                  ctx, txn)
                if info.table.delete_row(rowid, txn):
                    db._log_delete(info, rowid, txn)
                    _index_delete(db, info, rowid, row)
                    if info.table.name in db._trigger_tables:
                        fire_triggers(db, info, "DELETE", "AFTER", None,
                                      row, ctx, txn)
                    affected += 1

    ins_clause = next((c for c in stmt.clauses if c[0] == "insert"), None)
    if ins_clause is not None:
        _, cols, val_exprs = ins_clause
        target_cols = cols or [c.name for c in info.columns]
        if len(val_exprs) != len(target_cols):
            raise SqlError(
                f"MERGE INSERT has {len(val_exprs)} values for "
                f"{len(target_cols)} columns"
            )
        unmatched = [i for i in range(srcb.n) if i not in matched_src]
        if unmatched:
            vcols = [eval_expr(e, srcb, ctx) for e in val_exprs]
            for i in unmatched:
                row = {
                    cn: (None if c.nulls[i] else _py(c.values[i]))
                    for cn, c in zip(target_cols, vcols)
                }
                prepared = _prepare_row(db, info, row, ctx)
                if _find_conflict(db, info, prepared, ctx) is not None:
                    raise _cv(db)(
                        f"UNIQUE constraint violated on {info.table.name}"
                    )
                _check_fks(db, info, prepared, ctx)
                if info.table.name in db._trigger_tables:
                    fire_triggers(db, info, "INSERT", "BEFORE", prepared,
                                  None, ctx, txn)
                (rowid,) = info.table.insert_rows([prepared], txn)
                db._log_insert(info, rowid, prepared, txn)
                _index_insert(db, info, rowid, prepared)
                if info.table.name in db._trigger_tables:
                    fire_triggers(db, info, "INSERT", "AFTER", prepared,
                                  None, ctx, txn)
                affected += 1

    return ExecuteResult(rows_affected=affected)


# ---------------------------------------------------------------------------
# Triggers (reference ast.rs:582 CreateTriggerStmt — parsed there, fired here)
# ---------------------------------------------------------------------------


def _subst_node(node, mapping):
    """Deep-copy an AST substituting NEW.col / OLD.col references with
    literals from the firing row (values are plain literals at fire
    time, so the substituted statement runs through the normal path)."""
    import dataclasses

    if isinstance(node, A.ColumnRef):
        if node.table and node.table.lower() in ("new", "old"):
            key = (node.table.lower(), node.name)
            if key not in mapping:
                raise SqlError(
                    f"trigger references unknown column "
                    f"{node.table}.{node.name}"
                )
            return A.Literal(mapping[key])
        if node.table is None and (None, node.name) in mapping:
            # procedure parameter reference (CALL substitution)
            return A.Literal(mapping[(None, node.name)])
        return node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _subst_node(v, mapping)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, list):
        out = [_subst_node(x, mapping) for x in node]
        return out if any(a is not b for a, b in zip(out, node)) else node
    if isinstance(node, tuple):
        out = tuple(_subst_node(x, mapping) for x in node)
        return out if any(a is not b for a, b in zip(out, node)) else node
    return node


def _refs_new_old(node) -> bool:
    """True if any ColumnRef in the AST references NEW.* / OLD.*
    (statement-level triggers have no firing row to bind them to)."""
    import dataclasses

    if isinstance(node, A.ColumnRef):
        return bool(node.table) and node.table.lower() in ("new", "old")
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return any(
            _refs_new_old(getattr(node, f.name))
            for f in dataclasses.fields(node)
        )
    if isinstance(node, (list, tuple)):
        return any(_refs_new_old(x) for x in node)
    return False


def triggers_for(db, schema, table_name: str, event: str, timing: str,
                 level: str = "ROW") -> list:
    trigs = db.triggers.get(schema)
    if not trigs:
        return []
    return [
        t for t in trigs.values()
        if t["table"] == table_name and t["timing"] == timing
        and event in t["events"] and t.get("level", "ROW") == level
    ]


def _run_trigger(db, t, mapping, txn):
    """One trigger firing: WHEN condition, then the body statements, with
    NEW./OLD. references substituted from the mapping as literals."""
    from turdb_tpu_torch.database.api import _parse_expr, _parse_stmt

    depth = getattr(db, "_trigger_depth", 0)
    if depth >= 8:
        raise SqlError("trigger recursion too deep")
    if t["when"]:
        cond = _subst_node(_parse_expr(t["when"]), mapping)
        c = eval_expr(cond, Batch(1),
                      EvalContext([], db.engine._subquery_fn))
        if c.nulls[0] or not bool(c.values[0]):
            return
    for sql in t["body"]:
        ast = t.setdefault("_asts", {}).get(sql)
        if ast is None:
            ast = t["_asts"][sql] = _parse_stmt(sql)
        stmt = _subst_node(ast, mapping)
        db._trigger_depth = depth + 1
        try:
            db._execute_stmt(stmt, [], txn)
        finally:
            db._trigger_depth = depth


def fire_triggers(db, info, event: str, timing: str, new_row, old_row,
                  ctx, txn):
    """Run matching row triggers: WHEN condition then body statements,
    with NEW./OLD. references substituted from the firing row."""
    matching = triggers_for(db, info.schema, info.table.name, event, timing)
    if not matching:
        return
    mapping = {}
    for cd in info.columns:
        if new_row is not None:
            mapping[("new", cd.name)] = new_row.get(cd.name)
        if old_row is not None:
            mapping[("old", cd.name)] = old_row.get(cd.name)
    for t in matching:
        _run_trigger(db, t, mapping, txn)


def fire_statement_triggers(db, info, event: str, timing: str, ctx, txn):
    """FOR EACH STATEMENT triggers: fire ONCE per statement (even when it
    affects zero rows), with no NEW/OLD bindings available."""
    if info.table.name not in db._trigger_tables:
        return
    for t in triggers_for(db, info.schema, info.table.name, event, timing,
                          level="STATEMENT"):
        _run_trigger(db, t, {}, txn)


# ---------------------------------------------------------------------------
# INSTEAD OF triggers: DML on views (SQLite view-trigger semantics; the
# reference treats views as read-only — this is the standard escape hatch)
# ---------------------------------------------------------------------------


def _instead_of_dispatch(db, ref: A.TableRef, event: str):
    """If `ref` names a view with INSTEAD OF triggers for `event`, return
    (schema, view_def, triggers); else None (plain tables, and views
    without a redirect, take their normal paths)."""
    schema = ref.schema or "main"
    vd = db.views.get(schema, {}).get(ref.name)
    if vd is None and ref.schema is None:
        for sc, views in db.views.items():
            if ref.name in views:
                schema, vd = sc, views[ref.name]
                break
    if vd is None:
        return None
    trigs = triggers_for(db, schema, vd.name, event, "INSTEAD OF")
    return (schema, vd, trigs) if trigs else None


def _view_columns(db, schema, vd, ctx) -> list:
    """Output column names of a view, without materializing it: explicit
    column list if declared, else the LIMIT-0 projection's names."""
    if vd.columns:
        return list(vd.columns)
    import dataclasses

    sel = dataclasses.replace(vd.select_ast(), limit=A.Literal(0))
    b = db.engine.run_select(sel, ctx)
    return [nm for (_, nm) in b.names if nm != ROWID]


def _returning_from_rows(qualifier, colnames, rows, items, ctx):
    """RETURNING over in-memory row dicts (view DML has no table rowids
    to re-fetch — the NEW/OLD values ARE the result)."""
    from turdb_tpu_torch.database.api import _batch_to_rows
    from turdb_tpu_torch.sql.engine import _output_name
    from turdb_tpu_torch.sql.expr import _densify

    b = Batch(len(rows))
    for cn in colnames:
        arr = np.empty(len(rows), object)
        nulls = np.zeros(len(rows), bool)
        for i, r in enumerate(rows):
            v = r.get(cn)
            arr[i] = v
            nulls[i] = v is None
        b.add(qualifier, cn, _densify(Col(arr, nulls)))
    ob = Batch(b.n)
    for it in items:
        if isinstance(it.expr, A.Star):
            for (q, nm), c in zip(b.names, b.cols):
                ob.add(None, nm, c)
            continue
        c = eval_expr(it.expr, b, ctx)
        ob.add(None, it.alias or _output_name(it.expr), c)
    return _batch_to_rows(ob)


def _instead_of_insert(db, stmt, params, txn, schema, vd, trigs):
    from turdb_tpu_torch.database.api import ExecuteResult

    if stmt.on_conflict is not None:
        raise SqlError("cannot UPSERT a view")
    ctx = db._ctx(params, txn)
    vcols = _view_columns(db, schema, vd, ctx)
    target_cols = stmt.columns if stmt.columns is not None else vcols
    for cn in target_cols:
        if cn not in vcols:
            raise SqlError(f"no such column: {cn}")
    rows: list[dict] = []
    if stmt.values is not None:
        one = Batch(1)
        for vrow in stmt.values:
            if len(vrow) != len(target_cols):
                raise SqlError(
                    f"INSERT has {len(vrow)} values for "
                    f"{len(target_cols)} columns"
                )
            row = {}
            for cn, e in zip(target_cols, vrow):
                c = eval_expr(e, one, ctx)
                row[cn] = None if c.nulls[0] else _py(c.values[0])
            rows.append(row)
    else:
        sub = db.engine.run_select(stmt.query, ctx)
        keep = [i for i, (_, nm) in enumerate(sub.names) if nm != ROWID]
        if len(keep) != len(target_cols):
            raise SqlError("INSERT SELECT column count mismatch")
        for i in range(sub.n):
            rows.append({
                cn: None if sub.cols[j].nulls[i] else _py(sub.cols[j].values[i])
                for cn, j in zip(target_cols, keep)
            })
    for row in rows:
        mapping = {("new", cn): row.get(cn) for cn in vcols}
        for t in trigs:
            _run_trigger(db, t, mapping, txn)
    res = ExecuteResult(rows_affected=len(rows))
    if stmt.returning:
        res.columns, res.rows = _returning_from_rows(
            vd.name, vcols, rows, stmt.returning, ctx
        )
    return res


def _view_rows_matching(db, stmt, schema, vd, ctx):
    """Materialize the view and return (column names, row dicts) for the
    rows the statement's WHERE selects."""
    ref = A.TableRef(vd.name, schema, getattr(stmt.table, "alias", None))
    src = db.engine._from(ref, ctx)
    if stmt.where is not None:
        c = eval_expr(stmt.where, src, ctx)
        src = src.take(np.flatnonzero(c.values.astype(bool) & ~c.nulls))
    names = [nm for (_, nm) in src.names]
    out = []
    for i in range(src.n):
        out.append({
            nm: None if col.nulls[i] else _py(col.values[i])
            for nm, col in zip(names, src.cols)
        })
    return names, out, src


def _instead_of_update(db, stmt, params, txn, schema, vd, trigs):
    from turdb_tpu_torch.database.api import ExecuteResult

    ctx = db._ctx(params, txn)
    names, olds, src = _view_rows_matching(db, stmt, schema, vd, ctx)
    for cn, _ in stmt.assignments:
        if cn not in names:
            raise SqlError(f"no such column: {cn}")
    # assignment expressions see the view row (vectorized over matches)
    assign = {cn: eval_expr(e, src, ctx) for cn, e in stmt.assignments}
    news = []
    for i, old in enumerate(olds):
        new = dict(old)
        for cn, c in assign.items():
            new[cn] = None if c.nulls[i] else _py(c.values[i])
        news.append(new)
        mapping = {}
        for cn in names:
            mapping[("new", cn)] = new.get(cn)
            mapping[("old", cn)] = old.get(cn)
        for t in trigs:
            _run_trigger(db, t, mapping, txn)
    res = ExecuteResult(rows_affected=len(olds))
    if stmt.returning:
        res.columns, res.rows = _returning_from_rows(
            vd.name, names, news, stmt.returning, ctx
        )
    return res


def _instead_of_delete(db, stmt, params, txn, schema, vd, trigs):
    from turdb_tpu_torch.database.api import ExecuteResult

    ctx = db._ctx(params, txn)
    names, olds, _src = _view_rows_matching(db, stmt, schema, vd, ctx)
    for old in olds:
        mapping = {("old", cn): old.get(cn) for cn in names}
        for t in trigs:
            _run_trigger(db, t, mapping, txn)
    res = ExecuteResult(rows_affected=len(olds))
    if stmt.returning:
        res.columns, res.rows = _returning_from_rows(
            vd.name, names, olds, stmt.returning, ctx
        )
    return res


def execute_call(db, stmt, params, txn):
    """CALL p(args) (reference ast.rs CallStmt — parsed there, executed
    here): the procedure body is a script of statements with parameter
    names substituted as literals."""
    from turdb_tpu_torch.database.api import DatabaseError, ExecuteResult

    pdef = db.procedures.get(stmt.schema or "main", {}).get(
        stmt.name.lower()
    ) or db.procedures.get("main", {}).get(stmt.name.lower())
    if pdef is None:
        raise DatabaseError(f"no such procedure: {stmt.name}")
    if len(stmt.args) != len(pdef["params"]):
        raise SqlError(
            f"{stmt.name}() takes {len(pdef['params'])} arguments, "
            f"got {len(stmt.args)}"
        )
    ctx = db._ctx(params, txn)
    one = Batch(1)
    mapping = {}
    for pn, e in zip(pdef["params"], stmt.args):
        c = eval_expr(e, one, ctx)
        mapping[(None, pn)] = None if c.nulls[0] else _py(c.values[0])
    depth = getattr(db, "_trigger_depth", 0)
    if depth >= 8:
        raise SqlError("procedure recursion too deep")
    from turdb_tpu_torch.sql.parser import parse_script

    asts = pdef.get("_asts")
    if asts is None:
        asts = pdef["_asts"] = parse_script(pdef["body"])
    total = 0
    db._trigger_depth = depth + 1
    try:
        for ast in asts:
            res = db._execute_stmt(_subst_node(ast, mapping), [], txn)
            total += getattr(res, "rows_affected", 0) or 0
    finally:
        db._trigger_depth = depth
    return ExecuteResult(rows_affected=total)
