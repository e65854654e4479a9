"""DDL execution: CREATE/DROP/ALTER TABLE, INDEX (incl. USING HNSW),
SCHEMA (reference src/database/ddl.rs)."""

from __future__ import annotations

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.lexer import SqlError
from turdb_tpu_torch.storage.table import ColumnarTable
from turdb_tpu_torch.types.column import ColumnDef
from turdb_tpu_torch.types.datatype import DataType


# the privilege universe (reference ast.rs:763-775 Privilege enum);
# an ALL grant expands against this when single privileges are revoked
_ALL_PRIVILEGES = {
    "SELECT", "INSERT", "UPDATE", "DELETE", "TRUNCATE", "REFERENCES",
    "TRIGGER", "CREATE", "CONNECT", "TEMPORARY", "EXECUTE", "USAGE",
}


def execute_ddl(db, stmt, txn):
    from turdb_tpu_torch.database.api import (
        DatabaseError,
        ExecuteResult,
        IndexDef,
        TableInfo,
    )

    # ANY schema change invalidates the prepared DML fast lanes: the
    # update/delete lanes cache cross-table facts (e.g. "no child table
    # references this one"), which a plain TableInfo-identity check
    # cannot see change (api.py CachedUpdatePlan/CachedDeletePlan)
    db.ddl_epoch += 1

    if isinstance(stmt, A.CreateSchema):
        if stmt.name in db.catalog:
            if stmt.if_not_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"schema {stmt.name} already exists")
        db.catalog[stmt.name] = {}
        db.views[stmt.name] = {}
        db.types.setdefault(stmt.name, {})
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateType):
        schema = stmt.schema or "main"
        if schema not in db.catalog:
            raise SqlError(f"no such schema: {schema}")
        types = db.types.setdefault(schema, {})
        tname = stmt.name.lower()   # SQL type names are case-insensitive
        if tname in types:
            raise DatabaseError(f"type {stmt.name} already exists")
        if stmt.kind == "enum":
            if len(set(stmt.values)) != len(stmt.values):
                raise DatabaseError("duplicate enum label")
            types[tname] = {"kind": "enum", "values": list(stmt.values)}
        elif stmt.kind == "domain":
            base, params = stmt.values
            DataType.from_sql(base)   # base must be a real type
            types[tname] = {
                "kind": "domain", "base": base, "params": list(params),
            }
        else:
            types[tname] = {
                "kind": "composite",
                "fields": [[fn, tn, list(tp)] for fn, tn, tp in stmt.values],
            }
        return ExecuteResult(0)

    if isinstance(stmt, A.Grant):
        # reference parser.rs:3125 parses GRANT/REVOKE and never enforces
        # (single-user embedded engine, no principals); here grants are
        # recorded in the catalog and queryable via turdb_catalog.grants
        if stmt.kind == "GRANT":
            for grantee in stmt.grantees:
                db.grants.append({
                    "privileges": list(stmt.privileges),
                    "object_type": stmt.object_type,
                    "object_name": stmt.object_name,
                    "grantee": grantee,
                    "grant_option": stmt.grant_option,
                })
        else:                                   # REVOKE
            revoked = set(stmt.privileges)
            keep = []
            for g in db.grants:
                if (g["grantee"] in stmt.grantees
                        and g["object_name"] == stmt.object_name):
                    if "ALL" in revoked:
                        continue
                    privs = g["privileges"]
                    if "ALL" in privs:
                        # revoking a specific privilege out of an ALL
                        # grant leaves the rest (PostgreSQL semantics)
                        privs = sorted(_ALL_PRIVILEGES)
                    left = [p for p in privs if p not in revoked]
                    if not left:
                        continue
                    g = {**g, "privileges": left}
                keep.append(g)
            db.grants = keep
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateTrigger):
        schema = "main"
        if stmt.timing == "INSTEAD OF":
            # INSTEAD OF redirects view DML (SQLite create_trigger.html
            # semantics); it is only meaningful on a view, per row
            if stmt.level != "ROW":
                raise DatabaseError(
                    "INSTEAD OF triggers must be FOR EACH ROW"
                )
            found = None
            for sc, views in db.views.items():
                if stmt.table in views:
                    found = sc
                    break
            if found is None:
                raise DatabaseError(
                    f"INSTEAD OF trigger target {stmt.table} is not a view"
                )
            schema = found
        elif stmt.table not in db.catalog.get(schema, {}):
            found = None
            for sc, tables in db.catalog.items():
                if stmt.table in tables:
                    found = sc
                    break
            if found is None:
                raise DatabaseError(f"no such table: {stmt.table}")
            schema = found
        trigs = db.triggers.setdefault(schema, {})
        if stmt.name in trigs and not stmt.or_replace:
            raise DatabaseError(f"trigger {stmt.name} already exists")
        from turdb_tpu_torch.database.api import _parse_expr, _parse_stmt
        from turdb_tpu_torch.database.dml import _refs_new_old

        for sql in stmt.body:            # validate the body parses now
            ast = _parse_stmt(sql)
            if stmt.level == "STATEMENT" and _refs_new_old(ast):
                raise DatabaseError(
                    "statement-level triggers cannot reference NEW/OLD"
                )
        if (stmt.level == "STATEMENT" and stmt.when
                and _refs_new_old(_parse_expr(stmt.when))):
            raise DatabaseError(
                "statement-level triggers cannot reference NEW/OLD"
            )
        trigs[stmt.name] = {
            "table": stmt.table,
            "timing": stmt.timing,
            "events": list(stmt.events),
            "when": stmt.when,
            "body": list(stmt.body),
            "level": stmt.level,
        }
        db._trigger_tables.add(stmt.table)
        db.trigger_epoch += 1
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateProcedure):
        schema = stmt.schema or "main"
        if schema not in db.catalog:
            raise SqlError(f"no such schema: {schema}")
        if stmt.language not in ("sql",):
            raise DatabaseError(
                f"unsupported procedure language: {stmt.language}"
            )
        prs = db.procedures.setdefault(schema, {})
        pname = stmt.name.lower()
        if pname in prs and not stmt.or_replace:
            raise DatabaseError(f"procedure {stmt.name} already exists")
        from turdb_tpu_torch.sql.parser import parse_script

        parse_script(stmt.body)          # validate the script parses now
        prs[pname] = {
            "params": [p[0] for p in stmt.params],
            "param_types": [p[1] for p in stmt.params],
            "body": stmt.body,
        }
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateFunction):
        schema = stmt.schema or "main"
        if schema not in db.catalog:
            raise SqlError(f"no such schema: {schema}")
        if stmt.language not in ("sql",):
            raise DatabaseError(
                f"unsupported function language: {stmt.language}"
            )
        fns = db.functions.setdefault(schema, {})
        fname = stmt.name.lower()
        if fname in fns and not stmt.or_replace:
            raise DatabaseError(f"function {stmt.name} already exists")
        from turdb_tpu_torch.sql.functions import parse_function_body

        parse_function_body(stmt.body)   # validate now, cache at call time
        fns[fname] = {
            "params": [p[0] for p in stmt.params],
            "param_types": [p[1] for p in stmt.params],
            "returns": stmt.return_type,
            "body": stmt.body,
        }
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateView):
        from turdb_tpu_torch.database.api import ViewDef

        schema = stmt.schema or "main"
        if schema not in db.catalog:
            raise SqlError(f"no such schema: {schema}")
        views = db.views.setdefault(schema, {})
        if stmt.name in db.catalog[schema]:
            raise DatabaseError(f"{stmt.name} is a table")
        if stmt.name in views and not stmt.or_replace:
            if stmt.if_not_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"view {stmt.name} already exists")
        vd = ViewDef(stmt.name, stmt.sql, list(stmt.columns or []) or None)
        # validate now: the body must parse and run against the current
        # catalog (expansion recursion guard catches self-reference)
        views_backup = views.get(stmt.name)
        views[stmt.name] = vd
        try:
            db.engine.run_select(vd.select_ast(), db._ctx([], txn))
        except Exception:
            if views_backup is None:
                views.pop(stmt.name, None)
            else:
                views[stmt.name] = views_backup
            raise
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateTable):
        schema = stmt.table.schema or "main"
        if schema not in db.catalog:
            raise SqlError(f"no such schema: {schema}")
        if stmt.table.name in db.catalog[schema]:
            if stmt.if_not_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"table {stmt.table.name} already exists")
        if stmt.table.name in db.views.get(schema, {}):
            raise DatabaseError(f"{stmt.table.name} is a view")
        cols = [_column_from_spec(sp, db, schema) for sp in stmt.columns]
        if not cols:
            raise SqlError("table needs at least one column")
        table = ColumnarTable(stmt.table.name, cols, table_id=db._next_table_id)
        db._next_table_id += 1
        info = TableInfo(schema, table)
        info.temporary = stmt.temporary
        # table-level constraints
        pk_cols = [c.name for c in cols if c.primary_key]
        for tc in stmt.constraints:
            if tc.kind == "PRIMARY KEY":
                pk_cols = tc.columns
                for cn in tc.columns:
                    _col(cols, cn).nullable = False
            elif tc.kind == "UNIQUE":
                _auto_index(db, info, tc.columns, unique=True)
            elif tc.kind == "CHECK":
                info.checks.append(tc.expr)
                info.check_names.append(tc.name)
            elif tc.kind == "FOREIGN KEY":
                info.fks.append(
                    (tc.columns, tc.ref_table, tc.ref_columns or [],
                     tc.on_delete, tc.on_update)
                )
                info.fk_names.append(tc.name)
        if pk_cols:
            for cn in pk_cols:
                _col(cols, cn).nullable = False
            _auto_index(db, info, pk_cols, unique=True, pk=True)
        for c in cols:
            if c.unique and not c.primary_key:
                _auto_index(db, info, [c.name], unique=True)
            if c.references is not None:
                info.fks.append(
                    ([c.name], c.references[0],
                     [c.references[1]] if c.references[1] else [],
                     c.references[2], c.references[3])
                )
                info.fk_names.append(None)
        db.catalog[schema][stmt.table.name] = info
        return ExecuteResult(0)

    if isinstance(stmt, A.CreateIndex):
        info = db.resolve_table(stmt.table)
        if stmt.name in info.index_defs:
            if stmt.if_not_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"index {stmt.name} already exists")
        using = (stmt.using or "BTREE").upper()
        for e, _ in stmt.columns:
            if isinstance(e, A.ColumnRef):
                if not any(c.name == e.name for c in info.columns):
                    raise SqlError(f"no such column: {e.name}")
            else:
                for cn in _expr_columns([e]):
                    if not any(c.name == cn for c in info.columns):
                        raise SqlError(f"no such column: {cn}")
        if using in ("HNSW", "IVF"):
            col = stmt.columns[0][0]
            if not isinstance(col, A.ColumnRef):
                raise SqlError(f"{using} index requires a plain vector column")
            cd = next(c for c in info.columns if c.name == col.name)
            if cd.dtype is not DataType.VECTOR:
                raise SqlError(f"{using} index requires a VECTOR column")
        if stmt.where is not None:
            # partial index (reference table.rs:273, ddl.rs:452): the
            # predicate may only reference the table's columns
            if using != "BTREE":
                raise SqlError(f"{using} indexes cannot be partial")
            for cn in _expr_columns([stmt.where]):
                if not any(c.name == cn for c in info.columns):
                    raise SqlError(f"no such column: {cn}")
        idef = IndexDef(
            stmt.name, info.table.name, info.schema,
            list(stmt.columns), stmt.unique, using, dict(stmt.options),
            stmt.where_text,
        )
        info.index_defs[stmt.name] = idef
        db._instantiate_index(info, idef)
        _backfill_index(db, info, idef)
        return ExecuteResult(0)

    if isinstance(stmt, A.Drop):
        if stmt.kind == "SCHEMA":
            if stmt.name not in db.catalog:
                if stmt.if_exists:
                    return ExecuteResult(0)
                raise DatabaseError(f"no such schema: {stmt.name}")
            if stmt.name == "main":
                raise DatabaseError("cannot drop schema main")
            del db.catalog[stmt.name]
            db.views.pop(stmt.name, None)
            db.types.pop(stmt.name, None)
            return ExecuteResult(0)
        if stmt.kind == "TRIGGER":
            for trigs in db.triggers.values():
                if stmt.name in trigs:
                    del trigs[stmt.name]
                    db._trigger_tables = {
                        t["table"] for tr in db.triggers.values()
                        for t in tr.values()
                    }
                    db.trigger_epoch += 1
                    return ExecuteResult(0)
            if stmt.if_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"no such trigger: {stmt.name}")
        if stmt.kind == "PROCEDURE":
            schema = stmt.schema or "main"
            prs = db.procedures.get(schema, {})
            pname = stmt.name.lower()
            if pname not in prs:
                if stmt.if_exists:
                    return ExecuteResult(0)
                raise DatabaseError(f"no such procedure: {stmt.name}")
            del prs[pname]
            return ExecuteResult(0)
        if stmt.kind == "FUNCTION":
            schema = stmt.schema or "main"
            fns = db.functions.get(schema, {})
            fname = stmt.name.lower()
            if fname not in fns:
                if stmt.if_exists:
                    return ExecuteResult(0)
                raise DatabaseError(f"no such function: {stmt.name}")
            del fns[fname]
            return ExecuteResult(0)
        if stmt.kind == "TYPE":
            schema = stmt.schema or "main"
            types = db.types.get(schema, {})
            tname = stmt.name.lower()
            if tname not in types:
                if stmt.if_exists:
                    return ExecuteResult(0)
                raise DatabaseError(f"no such type: {stmt.name}")
            for tables in db.catalog.values():
                for info in tables.values():
                    for c in info.columns:
                        if c.type_name == tname:
                            raise DatabaseError(
                                f"type {stmt.name} is in use by "
                                f"{info.table.name}.{c.name}"
                            )
            del types[tname]
            return ExecuteResult(0)
        if stmt.kind == "VIEW":
            schema = stmt.schema or "main"
            views = db.views.get(schema, {})
            if stmt.name not in views:
                if stmt.if_exists:
                    return ExecuteResult(0)
                raise DatabaseError(f"no such view: {stmt.name}")
            del views[stmt.name]
            return ExecuteResult(0)
        if stmt.kind == "TABLE":
            schema = stmt.schema or "main"
            tables = db.catalog.get(schema, {})
            if stmt.name not in tables:
                if stmt.if_exists:
                    return ExecuteResult(0)
                if stmt.name in db.views.get(schema, {}):
                    raise DatabaseError(
                        f"{stmt.name} is a view; use DROP VIEW"
                    )
                raise DatabaseError(f"no such table: {stmt.name}")
            del tables[stmt.name]
            db.fm.drop_table_files(schema, stmt.name)
            return ExecuteResult(0)
        if stmt.kind == "INDEX":
            for tables in db.catalog.values():
                for info in tables.values():
                    if stmt.name in info.index_defs:
                        info.index_defs.pop(stmt.name)
                        info.btree.pop(stmt.name, None)
                        info.btree_cols.pop(stmt.name, None)
                        info.btree_exprs.pop(stmt.name, None)
                        info.btree_where.pop(stmt.name, None)
                        info.hnsw.pop(stmt.name, None)
                        return ExecuteResult(0)
            if stmt.if_exists:
                return ExecuteResult(0)
            raise DatabaseError(f"no such index: {stmt.name}")

    if isinstance(stmt, A.AlterTable):
        info = db.resolve_table(stmt.table)
        t = info.table
        if stmt.action == "ADD_COLUMN":
            cd = _column_from_spec(stmt.column, db,
                                   stmt.table.schema or "main")
            if any(c.name == cd.name for c in info.columns):
                raise DatabaseError(f"column {cd.name} already exists")
            t.columns.append(cd)
            t.colnames.append(cd.name)
            t.cols[cd.name] = t._alloc(cd, t.capacity)
            import numpy as np

            t.nulls[cd.name] = np.ones(t.capacity, bool)
            # existing rows: NULL or evaluated default
            if cd.has_default and cd.default is not None:
                from turdb_tpu_torch.database.dml import eval_default

                dv = eval_default(db, cd)
                if dv is not None:
                    for i in range(t.nversions):
                        t.nulls[cd.name][i] = False
                        t.cols[cd.name][i] = t._coerce(cd, dv)
            return ExecuteResult(0)
        if stmt.action == "DROP_COLUMN":
            if not any(c.name == stmt.name for c in info.columns):
                raise DatabaseError(f"no such column: {stmt.name}")
            for idx_name, cols in list(info.btree_cols.items()):
                if cols is None:
                    cols = _expr_columns(info.btree_exprs[idx_name])
                if stmt.name in cols:
                    raise DatabaseError(
                        f"column {stmt.name} is indexed by {idx_name}; drop it first"
                    )
            for h in info.hnsw.values():
                if h.column == stmt.name:
                    raise DatabaseError(
                        f"column {stmt.name} has an HNSW index; drop it first"
                    )
            t.columns = [c for c in t.columns if c.name != stmt.name]
            t.colnames = [n for n in t.colnames if n != stmt.name]
            t.cols.pop(stmt.name, None)
            t.nulls.pop(stmt.name, None)
            return ExecuteResult(0)
        if stmt.action == "RENAME_TABLE":
            tables = db.catalog[info.schema]
            if stmt.new_name in tables:
                raise DatabaseError(f"table {stmt.new_name} already exists")
            tables[stmt.new_name] = tables.pop(t.name)
            t.name = stmt.new_name
            return ExecuteResult(0)
        if stmt.action == "RENAME_COLUMN":
            if not any(c.name == stmt.name for c in info.columns):
                raise DatabaseError(f"no such column: {stmt.name}")
            for c in t.columns:
                if c.name == stmt.name:
                    c.name = stmt.new_name
            t.colnames = [stmt.new_name if n == stmt.name else n for n in t.colnames]
            t.cols[stmt.new_name] = t.cols.pop(stmt.name)
            t.nulls[stmt.new_name] = t.nulls.pop(stmt.name)
            for name, cols in info.btree_cols.items():
                if cols is None:
                    _rename_in_exprs(
                        info.btree_exprs[name], stmt.name, stmt.new_name
                    )
                    continue
                info.btree_cols[name] = [
                    stmt.new_name if cn == stmt.name else cn for cn in cols
                ]
            for h in info.hnsw.values():
                if h.column == stmt.name:
                    h.column = stmt.new_name
            return ExecuteResult(0)
        if stmt.action == "ALTER_COLUMN":
            # reference ast.rs AlterColumnAction — parsed there, executed
            # here (like CREATE TYPE / the ANN wiring)
            return _alter_column(db, info, stmt)
        if stmt.action == "ADD_CONSTRAINT":
            return _add_constraint(db, info, stmt.constraint)
        if stmt.action == "DROP_CONSTRAINT":
            return _drop_constraint(db, info, stmt)

    raise DatabaseError(f"unsupported DDL {type(stmt).__name__}")


def _visible_values(db, info, cname):
    """(values, nulls) of the latest committed versions of one column."""
    t = info.table
    vis = t.visible_indices(db.mgr, db.mgr.snapshot_ts())
    import numpy as np

    vis = np.asarray(vis, np.int64)
    return t.cols[cname][vis], t.nulls[cname][vis], vis


def _alter_column(db, info, stmt):
    from turdb_tpu_torch.database.api import DatabaseError, ExecuteResult

    import numpy as np

    t = info.table
    cd = _col(info.columns, stmt.name)
    act = stmt.col_action
    if act == "SET_DEFAULT":
        cd.default = stmt.expr
        cd.has_default = True
        return ExecuteResult(0)
    if act == "DROP_DEFAULT":
        cd.default = None
        cd.has_default = False
        return ExecuteResult(0)
    if act == "SET_NOT_NULL":
        _, nulls, _ = _visible_values(db, info, cd.name)
        if nulls.any():
            raise DatabaseError(
                f"column {cd.name} contains NULLs; cannot SET NOT NULL"
            )
        cd.nullable = False
        return ExecuteResult(0)
    if act == "DROP_NOT_NULL":
        if cd.primary_key:
            raise DatabaseError("cannot DROP NOT NULL on a primary key")
        cd.nullable = True
        return ExecuteResult(0)
    # SET DATA TYPE: convert the stored column; reject lossy failures
    new_dt = DataType.from_sql(stmt.type_name)
    old_sc = cd.dtype.storage_class
    new_sc = new_dt.storage_class
    from turdb_tpu_torch.types.datatype import StorageClass

    if new_sc is not old_sc:
        old_arr = t.cols[cd.name]
        n = t.nversions
        nulls = t.nulls[cd.name]
        new_arr = None
        if new_sc is StorageClass.TEXT or new_sc is StorageClass.OBJECT:
            new_arr = np.empty(t.capacity, object)
            for i in range(n):
                if not nulls[i]:
                    v = old_arr[i]
                    new_arr[i] = str(_pyval(v))
        elif new_sc is StorageClass.INT and old_sc in (
                StorageClass.FLOAT, StorageClass.FLOAT32, StorageClass.BOOL):
            new_arr = np.zeros(t.capacity, np.int64)
            new_arr[:n] = old_arr[:n].astype(np.int64)
        elif new_sc in (StorageClass.FLOAT, StorageClass.FLOAT32) and \
                old_sc in (StorageClass.INT, StorageClass.BOOL,
                           StorageClass.FLOAT, StorageClass.FLOAT32):
            ty = np.float64 if new_sc is StorageClass.FLOAT else np.float32
            new_arr = np.zeros(t.capacity, ty)
            new_arr[:n] = old_arr[:n].astype(ty)
        elif old_sc in (StorageClass.TEXT, StorageClass.OBJECT) and \
                new_sc in (StorageClass.INT, StorageClass.FLOAT,
                           StorageClass.FLOAT32):
            ty = (np.int64 if new_sc is StorageClass.INT else
                  np.float64 if new_sc is StorageClass.FLOAT else np.float32)
            new_arr = np.zeros(t.capacity, ty)
            for i in range(n):
                if not nulls[i]:
                    try:
                        new_arr[i] = (int(old_arr[i])
                                      if new_sc is StorageClass.INT
                                      else float(old_arr[i]))
                    except (TypeError, ValueError):
                        raise DatabaseError(
                            f"cannot convert {old_arr[i]!r} to "
                            f"{stmt.type_name}"
                        )
        if new_arr is None:
            raise DatabaseError(
                f"unsupported type conversion {cd.dtype.name} -> "
                f"{stmt.type_name}"
            )
        t.cols[cd.name] = new_arr
    cd.dtype = new_dt
    # indexes on this column hold keys encoded under the OLD type:
    # re-instantiate and backfill them against the converted column
    for iname, idef in list(info.index_defs.items()):
        cols = info.btree_cols.get(iname)
        touched = (cols is not None and cd.name in cols) or (
            cols is None and iname in info.btree_exprs and any(
                cd.name in _expr_columns([e])
                for e in info.btree_exprs[iname]
            )
        )
        if touched:
            db._instantiate_index(info, idef)
            _backfill_index(db, info, idef)
    cd.max_len = None
    if new_dt in (DataType.VARCHAR, DataType.CHAR) and stmt.type_params:
        cd.max_len = int(stmt.type_params[0])
        _, nulls, vis = _visible_values(db, info, cd.name)
        vals = t.cols[cd.name][vis]
        for v, isnull in zip(vals, nulls):
            if not isnull and len(str(v)) > cd.max_len:
                raise DatabaseError(
                    f"existing value too long for {stmt.type_name}"
                    f"({cd.max_len})"
                )
    return ExecuteResult(0)


def _pyval(v):
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    return v


def _add_constraint(db, info, tc):
    from turdb_tpu_torch.database.api import DatabaseError, ExecuteResult
    from turdb_tpu_torch.sql.expr import Batch, Col, EvalContext, eval_expr

    import numpy as np

    if tc.kind == "CHECK":
        # validate existing rows first
        vis_rows = []
        t = info.table
        vis = t.visible_indices(db.mgr, db.mgr.snapshot_ts())
        vis = np.asarray(vis, np.int64)
        b = Batch(len(vis))
        for c in info.columns:
            from turdb_tpu_torch.sql.expr import _densify

            b.add(None, c.name,
                  _densify(Col(t.cols[c.name][vis].astype(object),
                               t.nulls[c.name][vis].copy())))
        ctx = EvalContext([], db.engine._subquery_fn)
        res = eval_expr(tc.expr, b, ctx)
        bad = (~res.nulls) & ~res.values.astype(bool)
        if bad.any():
            raise DatabaseError("existing rows violate CHECK constraint")
        info.checks.append(tc.expr)
        info.check_names.append(tc.name)
        return ExecuteResult(0)
    if tc.kind in ("UNIQUE", "PRIMARY KEY"):
        name = tc.name or (
            f"__uc_{info.table.name}_{'_'.join(tc.columns)}"
        )
        if name in info.index_defs:
            raise DatabaseError(f"index {name} already exists")
        from turdb_tpu_torch.database.api import IndexDef
        from turdb_tpu_torch.sql import ast as AA

        cols = [(AA.ColumnRef(c), False) for c in tc.columns]
        idef = IndexDef(name, info.table.name, info.schema, cols, True,
                        "BTREE", {})
        info.index_defs[name] = idef
        db._instantiate_index(info, idef)
        try:
            _backfill_index(db, info, idef)
        except Exception:
            info.index_defs.pop(name, None)
            info.btree.pop(name, None)
            info.btree_cols.pop(name, None)
            info.btree_where.pop(name, None)
            raise
        if tc.kind == "PRIMARY KEY":
            for cn in tc.columns:
                _col(info.columns, cn).nullable = False
        return ExecuteResult(0)
    if tc.kind == "FOREIGN KEY":
        ref_info = db.catalog.get(info.schema, {}).get(tc.ref_table) or \
            db.catalog.get("main", {}).get(tc.ref_table)
        if ref_info is None:
            raise DatabaseError(f"no such table: {tc.ref_table}")
        fk = (tc.columns, tc.ref_table, tc.ref_columns or [],
              tc.on_delete, tc.on_update)
        info.fks.append(fk)
        info.fk_names.append(tc.name)
        # validate existing rows reference existing parents (ALTER is
        # rare: per-row revalidation through the DML FK checker)
        from turdb_tpu_torch.database.dml import _check_fks

        t = info.table
        ctx = db._ctx([], None)
        try:
            for vi in t.visible_indices(db.mgr, db.mgr.snapshot_ts()):
                _check_fks(db, info, t.row_as_dict(int(vi)), ctx)
        except Exception:
            info.fks.pop()
            info.fk_names.pop()
            raise
        return ExecuteResult(0)
    raise DatabaseError(f"unsupported constraint kind {tc.kind}")


def _drop_constraint(db, info, stmt):
    from turdb_tpu_torch.database.api import DatabaseError, ExecuteResult

    name = stmt.name
    if name in info.index_defs and info.index_defs[name].unique:
        info.index_defs.pop(name)
        info.btree.pop(name, None)
        info.btree_cols.pop(name, None)
        info.btree_exprs.pop(name, None)
        info.btree_where.pop(name, None)
        return ExecuteResult(0)
    if name in info.check_names:
        i = info.check_names.index(name)
        info.check_names.pop(i)
        info.checks.pop(i)
        return ExecuteResult(0)
    if name in info.fk_names:
        i = info.fk_names.index(name)
        info.fk_names.pop(i)
        info.fks.pop(i)
        return ExecuteResult(0)
    if stmt.col_action == "IF_EXISTS":
        return ExecuteResult(0)
    raise DatabaseError(f"no such constraint: {name}")


def _column_from_spec(sp: A.ColumnSpec, db=None, schema="main") -> ColumnDef:
    try:
        dt = DataType.from_sql(sp.type_name)
    except ValueError:
        # user-defined type (CREATE TYPE .. AS ENUM / AS (...))
        td = None
        tname = sp.type_name.lower()
        if db is not None:
            td = db.types.get(schema, {}).get(tname) or \
                db.types.get("main", {}).get(tname)
        if td is None:
            raise SqlError(f"unknown type: {sp.type_name}")
        if td["kind"] == "domain":
            # resolve through the base type, keep the domain's name
            import dataclasses as _dc

            base_sp = _dc.replace(
                sp, type_name=td["base"], type_params=list(td["params"])
            )
            cd = _column_from_spec(base_sp, db, schema)
            cd.type_name = tname
            return cd
        cd = ColumnDef(
            name=sp.name,
            dtype=(DataType.ENUM if td["kind"] == "enum"
                   else DataType.COMPOSITE),
            nullable=not (sp.not_null or sp.primary_key),
            primary_key=sp.primary_key,
            unique=sp.unique,
            default=sp.default,
            has_default=sp.default is not None,
            check=sp.check,
            references=sp.references,
        )
        cd.type_name = tname
        if td["kind"] == "enum":
            cd.enum_values = list(td["values"])
        return cd
    cd = ColumnDef(
        name=sp.name,
        dtype=dt,
        nullable=not (sp.not_null or sp.primary_key),
        primary_key=sp.primary_key,
        unique=sp.unique,
        default=sp.default,
        has_default=sp.default is not None,
        check=sp.check,
        references=sp.references,
    )
    if dt in (DataType.VARCHAR, DataType.CHAR) and sp.type_params:
        cd.max_len = int(sp.type_params[0])
    if dt is DataType.VECTOR:
        if not sp.type_params:
            raise SqlError("VECTOR requires a dimension: VECTOR(d)")
        cd.vector_dim = int(sp.type_params[0])
    if dt is DataType.DECIMAL and sp.type_params:
        cd.precision = int(sp.type_params[0])
        if len(sp.type_params) > 1:
            cd.scale = int(sp.type_params[1])
    if dt is DataType.ENUM and sp.type_params:
        cd.enum_values = [str(p) for p in sp.type_params]
    if dt in (DataType.SERIAL, DataType.BIGSERIAL):
        cd.auto_increment = True
        cd.dtype = DataType.BIGINT if dt is DataType.BIGSERIAL else DataType.INT
    if sp.auto_increment:
        if cd.dtype not in (DataType.INT, DataType.BIGINT, DataType.SMALLINT):
            raise SqlError("AUTO_INCREMENT requires an integer column")
        cd.auto_increment = True
    return cd


def _col(cols, name) -> ColumnDef:
    for c in cols:
        if c.name == name:
            return c
    raise SqlError(f"no such column: {name}")


def _auto_index(db, info, colnames, unique=False, pk=False):
    from turdb_tpu_torch.database.api import IndexDef

    base = "pk" if pk else "uq"
    name = f"__{base}_{info.table.name}_{'_'.join(colnames)}"
    if name in info.index_defs:
        return
    idef = IndexDef(
        name, info.table.name, info.schema,
        [(A.ColumnRef(c), False) for c in colnames], unique=unique,
    )
    info.index_defs[name] = idef
    db._instantiate_index(info, idef)


def _backfill_index(db, info, idef):
    """Populate a newly created index from existing visible rows."""
    read_ts = db.mgr.snapshot_ts()
    vis = info.table.visible_indices(db.mgr, read_ts)
    if idef.using in ("HNSW", "IVF"):
        h = info.hnsw[idef.name]
        for i in vis:
            if not info.table.nulls[h.column][i]:
                h.insert(
                    int(info.table.rowids[i]),
                    info.table.cols[h.column][int(i)],
                    defer=True,
                )
        h.flush_pending()
    else:
        idx = info.btree[idef.name]
        mask = db._index_pred_mask(info, idef.name, vis)
        if mask is not None:
            vis = vis[mask]   # partial index: only matching rows
        cols = info.btree_cols[idef.name]
        if cols is None:     # expression index backfill
            from turdb_tpu_torch.database.api import _expr_index_keys

            keys = _expr_index_keys(db, info, idef.name, vis)
            if idef.unique and len(set(keys)) != len(keys):
                info.btree.pop(idef.name, None)
                info.btree_cols.pop(idef.name, None)
                info.btree_exprs.pop(idef.name, None)
                info.index_defs.pop(idef.name, None)
                raise DatabaseError(
                    f"cannot create unique index {idef.name}: duplicate keys"
                )
            idx.bulk_load(keys, info.table.rowids[vis])
            return
        from turdb_tpu_torch.database.api import _cell

        for i in vis:
            key = idx.make_key([_cell(info.table, c, int(i)) for c in cols])
            idx.insert(key, int(info.table.rowids[i]))
def _expr_columns(exprs) -> set:
    """Column names referenced by expression-index exprs."""
    import dataclasses as _dc

    out: set = set()

    def walk(x):
        if isinstance(x, A.ColumnRef):
            out.add(x.name)
            return
        if _dc.is_dataclass(x):
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, (list, tuple)):
                    for i in v:
                        if _dc.is_dataclass(i):
                            walk(i)
                elif _dc.is_dataclass(v):
                    walk(v)

    for e in exprs:
        walk(e)
    return out


def _rename_in_exprs(exprs, old: str, new: str):
    import dataclasses as _dc

    def walk(x):
        if isinstance(x, A.ColumnRef):
            if x.name == old:
                x.name = new
            return
        if _dc.is_dataclass(x):
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, (list, tuple)):
                    for i in v:
                        if _dc.is_dataclass(i):
                            walk(i)
                elif _dc.is_dataclass(v):
                    walk(v)

    for e in exprs:
        walk(e)
