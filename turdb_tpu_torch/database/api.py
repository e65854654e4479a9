"""The Database: open/create, SQL pipeline, transactions, durability.

Counterpart of reference src/database/database.rs (SharedDatabase/Database,
:95-143) + dml/ + ddl.rs + transaction.rs + recovery.rs + pragma.rs
(SURVEY.md §2.7), on the columnar engine:

    execute(sql)  -> parse -> dispatch (DDL / DML / txn / pragma)
    query(sql)    -> parse -> QueryEngine columnar pipeline -> rows

Durability: logical WAL (storage/wal.py) written during DML with the
writing txn's id; COMMIT/ABORT frames decide replay; checkpoint writes
columnar snapshots + catalog then truncates the WAL (reference
checkpoint-then-truncate, database.rs:158-184). If the WAL is larger than
the recovery memory pool, the database opens in ReadOnlyDegraded mode and
`PRAGMA recover_wal` performs recovery later (reference database.rs:245-270,
recovery.rs:8-25).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from functools import partial as _partial

import numpy as np

from turdb_tpu_torch.database.indexes import HnswTableIndex, SortedKeyIndex
from turdb_tpu_torch.memory.budget import MemoryBudget
from turdb_tpu_torch.mvcc.manager import Transaction, TransactionManager, TxnConflict
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.records.jsonb import jsonb_decode, jsonb_encode
from turdb_tpu_torch.records.record import RecordSchema, pack_record, unpack_record
from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.engine import ROWID, QueryEngine
from turdb_tpu_torch.sql.expr import Batch, Col, EvalContext, eval_expr, _py
from turdb_tpu_torch.sql.lexer import SqlError
from turdb_tpu_torch.sql.parser import Parser
from turdb_tpu_torch.storage.files import FileManager
from turdb_tpu_torch.storage.table import ColumnarTable
from turdb_tpu_torch.storage.wal import FrameType, SyncMode, Wal
from turdb_tpu_torch.types.column import ColumnDef
from turdb_tpu_torch.types.datatype import DataType, StorageClass


class DatabaseError(Exception):
    pass


class ConstraintViolation(DatabaseError):
    pass


class ReadOnlyError(DatabaseError):
    pass


@dataclasses.dataclass
class ExecuteResult:
    """Reference ExecuteResult (database/mod.rs:138)."""

    rows_affected: int = 0
    last_rowid: int | None = None
    rows: list | None = None          # RETURNING / SELECT rows
    columns: list | None = None


@dataclasses.dataclass
class RecoveryInfo:
    """Reference RecoveryInfo (database/mod.rs:202)."""

    frames_recovered: int = 0
    wal_size_bytes: int = 0
    mode: str = "rw"                  # "rw" | "ro_degraded"


@dataclasses.dataclass
class CheckpointInfo:
    """Reference CheckpointInfo (database/mod.rs:208)."""

    frames_checkpointed: int = 0
    wal_truncated: bool = True


@dataclasses.dataclass
class ViewDef:
    """An executable view (reference ast.rs:544 CreateViewStmt — the
    reference only parses these; here they run). The body is stored as
    SQL text; the parsed AST is cached on first expansion."""

    name: str
    sql: str                          # the SELECT body
    columns: list | None = None       # optional output column renames
    _ast: object = None               # cached parsed Select

    def select_ast(self):
        if self._ast is None:
            from turdb_tpu_torch.sql.fold import fold_statement
            from turdb_tpu_torch.sql.parser import parse_sql

            self._ast = fold_statement(parse_sql(self.sql))
        return self._ast


@dataclasses.dataclass
class IndexDef:
    name: str
    table: str
    schema: str
    columns: list          # [(ColumnRef-or-expr, desc)]
    unique: bool = False
    using: str = "BTREE"   # BTREE | HNSW
    options: dict = dataclasses.field(default_factory=dict)
    # partial index predicate source text (reference table.rs:273
    # where_clause / is_partial); None = full index
    where_text: str | None = None


class TableInfo:
    def __init__(self, schema: str, table: ColumnarTable):
        self.schema = schema
        self.table = table
        self.btree: dict[str, SortedKeyIndex] = {}
        # plain-column indexes: list of column names; expression indexes
        # (reference ddl.rs CREATE INDEX ON t(expr)): None here, exprs in
        # btree_exprs
        self.btree_cols: dict[str, list[str] | None] = {}
        self.btree_exprs: dict[str, list] = {}
        # partial indexes: name -> parsed predicate expr (table.rs:273)
        self.btree_where: dict[str, object] = {}
        self.hnsw: dict[str, HnswTableIndex] = {}
        self.index_defs: dict[str, IndexDef] = {}
        self.checks: list = []          # table-level CHECK exprs
        self.check_names: list = []     # parallel names (ADD/DROP CONSTRAINT)
        self.fks: list = []             # (cols, ref_table, ref_cols, on_delete, on_update)
        self.fk_names: list = []        # parallel names (None = unnamed)
        self.temporary = False          # CREATE TEMP TABLE: never persisted

    @property
    def columns(self) -> list[ColumnDef]:
        return self.table.columns

    def record_schema(self) -> RecordSchema:
        # cached: rebuilt only when DDL changes the column list
        key = tuple(id(c) for c in self.columns)
        if getattr(self, "_rs_key", None) != key:
            self._rs = RecordSchema([c.dtype for c in self.columns])
            self._rs_key = key
        return self._rs


@dataclasses.dataclass
class IndexChoice:
    """Outcome of index selection (shared by _try_index_scan and the
    plan-IR builder, sql/plan.py): which index, eq-probe or range, and
    the probed candidate rowids (the probe IS the selectivity test)."""

    info: TableInfo
    index: str
    kind: str                 # "eq" | "range"
    cols: tuple
    rowids: list

    @property
    def nrows(self) -> int:
        return len(self.rowids)


class Database:
    # ------------------------------------------------------------------
    # lifecycle (reference database.rs:213-397 open/create/recovery)
    # ------------------------------------------------------------------

    def __init__(self, path: str, create: bool = False, *, device="cuda"):
        self.path = path
        # the vector indexes' device: the card unless the caller asks for
        # the CPU (models/ivf.py, models/hnsw.py)
        self.device = device
        self.fm = FileManager(path)
        self.mgr = TransactionManager()
        self.engine = QueryEngine(self)
        self.catalog: dict[str, dict[str, TableInfo]] = {"main": {}}
        self.views: dict[str, dict[str, ViewDef]] = {"main": {}}
        self._txn: Transaction | None = None
        self._next_table_id = 1
        self.mode = "rw"
        self.budget = MemoryBudget.auto_detect()
        # config (PRAGMAs; reference pragma.rs)
        self.wal_enabled = True
        self.wal_autoflush = True
        self.sync_mode = SyncMode.NORMAL
        # auto-checkpoint frame threshold (reference wal.rs:278 atomic,
        # settable via PRAGMA wal_checkpoint_threshold, pragma.rs:241-257)
        from turdb_tpu_torch.config import WAL_CHECKPOINT_FRAMES

        self.checkpoint_threshold = WAL_CHECKPOINT_FRAMES
        self.ann_enabled = True
        self.ann_overfetch = 4
        self.join_budget_override = None   # PRAGMA join_memory_budget
        self.types = {"main": {}}          # user types (CREATE TYPE)
        self.functions = {"main": {}}      # SQL functions (CREATE FUNCTION)
        self.triggers = {"main": {}}       # row triggers (CREATE TRIGGER)
        self.procedures = {"main": {}}     # CREATE PROCEDURE / CALL
        self.trigger_epoch = 0             # bumps invalidate fast lanes
        self.ddl_epoch = 0                 # any DDL bumps (ddl.execute_ddl)
        self._trigger_tables = set()       # tables with any trigger
        self.grants = []                   # GRANT records (not enforced)
        self.last_insert_id = 0            # LAST_INSERT_ID()
        self._replaying = False
        # statement-level lock shared by all handles (reference
        # SharedDatabase synchronizes with page/table locks; columnar
        # state here has no finer-grained unit — one reentrant lock per
        # statement costs ~100ns uncontended and makes concurrent
        # handles safe; MVCC still provides the isolation semantics)
        self._stmt_lock = threading.RLock()
        # group-commit hook cell: [wal.commit_durable] when (wal on AND
        # synchronous=FULL) else [None]. Entry points call it AFTER
        # releasing the statement lock so concurrent committers share
        # one fsync (reference group_commit.rs); a cell (not an attr
        # check) keeps the sync!=FULL hot path to one pointer load.
        self._durable_hook: list = [None]

        exists = os.path.exists(self.fm.meta_path())
        if not exists and not create:
            raise DatabaseError(f"database not found at {path}")
        os.makedirs(path, exist_ok=True)
        if not exists:
            self.fm.write_meta({"version": 1, "next_table_id": 1})
        self.wal = Wal(self.fm.wal_dir(), self.sync_mode)
        self._refresh_durable_hook()
        if exists:
            self._open_existing()

    @classmethod
    def create(cls, path: str, *, device="cuda") -> "Database":
        return cls(path, create=True, device=device)

    @classmethod
    def open(cls, path: str, *, device="cuda") -> "Database":
        return cls(path, create=False, device=device)

    @classmethod
    def open_with_recovery(cls, path: str, *, device="cuda"
                           ) -> "tuple[Database, RecoveryInfo]":
        """Open and report what crash recovery did (reference
        database.rs:217 open_with_recovery)."""
        db = cls(path, create=False, device=device)
        return db, RecoveryInfo(
            frames_recovered=getattr(db, "_recovered_frames", 0),
            wal_size_bytes=getattr(db, "_recovered_wal_bytes", 0),
            mode=db.mode,
        )

    def handle(self) -> "Database":
        """Second handle over the SAME shared state with its own active
        transaction (reference SharedDatabase/Database split,
        database.rs:95-143: handles are cloneable, per-handle
        active_txn). Concurrent handles see each other's committed
        writes through MVCC snapshots; row locks (FOR UPDATE / writes)
        conflict across handles via the shared TransactionManager."""
        h = object.__new__(Database)
        h.__dict__ = self.__dict__.copy()
        h._txn = None
        h.engine = QueryEngine(h)
        return h

    def _open_existing(self):
        meta = self.fm.read_meta()
        self._next_table_id = int(meta.get("next_table_id", 1))
        if os.path.exists(self.fm.catalog_path()):
            self._load_catalog()
        # recovery gate (reference recovery.rs:90 estimate + degraded mode)
        wal_bytes = self.wal.size_bytes
        self._recovered_wal_bytes = wal_bytes
        if wal_bytes > self.budget.pool("recovery"):
            self.mode = "ro_degraded"
            return
        self._replay_wal()
        self._rebuild_indexes()

    def close(self):
        """Checkpoint + close (reference lifecycle.rs)."""
        with self._stmt_lock:
            if self._txn is not None:
                self.mgr.abort(self._txn)
                self._txn = None
            if self.mode == "rw":
                self.checkpoint()
            self.wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # catalog persistence (reference schema/persistence.rs:116)
    # ------------------------------------------------------------------

    def _catalog_doc(self) -> dict:
        doc = {"schemas": []}
        for schema, tables in self.catalog.items():
            ts = []
            for name, info in tables.items():
                if info.temporary:
                    continue    # temp tables die with the process
                ts.append(
                    {
                        "name": name,
                        "table_id": info.table.table_id,
                        "columns": [c.to_dict() for c in info.columns],
                        "checks": [str(e) for e in info.checks],
                        "check_names": list(info.check_names),
                        "fks": [list(map(_jsonable_fk, fk)) for fk in info.fks],
                        "fk_names": list(info.fk_names),
                        "indexes": [
                            {
                                "name": d.name,
                                "unique": d.unique,
                                "using": d.using,
                                "options": d.options,
                                "columns": [
                                    [A.render_expr(e), desc] for e, desc in d.columns
                                ],
                                "where": d.where_text,
                            }
                            for d in info.index_defs.values()
                        ],
                    }
                )
            vs = [
                {"name": v.name, "sql": v.sql, "columns": v.columns}
                for v in self.views.get(schema, {}).values()
            ]
            tys = [
                {"name": nm, **td}
                for nm, td in self.types.get(schema, {}).items()
            ]
            fns = [
                {"name": nm,
                 **{k: v for k, v in fd.items() if not k.startswith("_")}}
                for nm, fd in self.functions.get(schema, {}).items()
            ]
            trs = [
                {"name": nm,
                 **{k: v for k, v in td.items() if not k.startswith("_")}}
                for nm, td in self.triggers.get(schema, {}).items()
            ]
            prs = [
                {"name": nm,
                 **{k: v for k, v in pd.items() if not k.startswith("_")}}
                for nm, pd in self.procedures.get(schema, {}).items()
            ]
            doc["schemas"].append(
                {"name": schema, "tables": ts, "views": vs, "types": tys,
                 "functions": fns, "triggers": trs, "procedures": prs}
            )
        if self.grants:
            doc["grants"] = list(self.grants)
        return doc

    def _load_catalog(self):
        doc = self.fm.read_catalog()
        self.grants = [dict(g) for g in doc.get("grants", [])]
        for sc in doc.get("schemas", []):
            schema = sc["name"]
            self.catalog.setdefault(schema, {})
            self.views.setdefault(schema, {})
            for vd in sc.get("views", []):
                self.views[schema][vd["name"]] = ViewDef(
                    vd["name"], vd["sql"], vd.get("columns")
                )
            self.types.setdefault(schema, {})
            for td in sc.get("types", []):
                td = dict(td)
                self.types[schema][td.pop("name")] = td
            self.functions.setdefault(schema, {})
            for fd in sc.get("functions", []):
                fd = dict(fd)
                self.functions[schema][fd.pop("name")] = fd
            self.triggers.setdefault(schema, {})
            for td2 in sc.get("triggers", []):
                td2 = dict(td2)
                self.triggers[schema][td2.pop("name")] = td2
                self._trigger_tables.add(td2["table"])
                self.trigger_epoch += 1
            self.procedures.setdefault(schema, {})
            for pd in sc.get("procedures", []):
                pd = dict(pd)
                self.procedures[schema][pd.pop("name")] = pd
            for td in sc["tables"]:
                try:
                    t = self.fm.read_table_snapshot(schema, td["name"])
                except FileNotFoundError:
                    cols = [ColumnDef.from_dict(d) for d in td["columns"]]
                    t = ColumnarTable(td["name"], cols, table_id=td["table_id"])
                info = TableInfo(schema, t)
                for e in td.get("checks", []):
                    info.checks.append(_parse_expr(e))
                for fk in td.get("fks", []):
                    info.fks.append(tuple(fk))
                info.check_names = list(
                    td.get("check_names") or [None] * len(info.checks)
                )
                info.fk_names = list(
                    td.get("fk_names") or [None] * len(info.fks)
                )
                for idx in td.get("indexes", []):
                    cols = [(_parse_expr(c), bool(d)) for c, d in idx["columns"]]
                    idef = IndexDef(
                        idx["name"], td["name"], schema, cols,
                        idx["unique"], idx["using"], idx.get("options", {}),
                        idx.get("where"),
                    )
                    info.index_defs[idx["name"]] = idef
                    if idef.using == "HNSW":
                        from turdb_tpu_torch.storage.hnsw_io import load_hnsw

                        loaded = load_hnsw(
                            self.fm.hnsw_path(schema, td["name"], idef.name),
                            self.device,
                        )
                        if loaded is not None:
                            info.hnsw[idef.name] = loaded
                            info._hnsw_loaded = True
                            continue
                    self._instantiate_index(info, idef)
                self.catalog[schema][td["name"]] = info

    def checkpoint(self):
        """Snapshot all tables + catalog, then truncate the WAL
        (reference database.rs:158-184). With transactions in flight the
        checkpoint still runs (reference wal.rs:50-60 checkpoints closed
        segments regardless — round-2 weak #11: a long-lived reader used
        to block WAL truncation indefinitely): it snapshots the
        COMMITTED-visible state and rewrites the WAL keeping only the
        in-flight transactions' frames."""
        if self.mode != "rw":
            raise ReadOnlyError("database is read-only (degraded)")
        if self.mgr.active:
            return self._checkpoint_with_active()
        frames = self.wal.frame_count
        self.wal.flush(force=True)
        for schema, tables in self.catalog.items():
            for info in tables.values():
                if info.temporary:
                    continue
                t = info.table
                # compact dead versions, then normalize surviving stamps to
                # the committed-bootstrap form (txn 0): snapshot stamps must
                # not reference this process's transient txn ids
                t.vacuum(self.mgr)
                n = t.nversions
                t.xmin[:n] = 0
                t.xmax[:n] = 0
                self.fm.write_table_snapshot(schema, t)
                from turdb_tpu_torch.storage.hnsw_io import save_hnsw

                for iname, h in info.hnsw.items():
                    if getattr(h, "using", "HNSW") == "HNSW":
                        save_hnsw(self.fm.hnsw_path(schema, t.name, iname), h)
        self.fm.write_catalog(self._catalog_doc())
        self.fm.write_meta(
            {"version": 1, "next_table_id": self._next_table_id}
        )
        self.wal.truncate()
        self.last_checkpoint_frames = frames
        return CheckpointInfo(frames_checkpointed=frames, wal_truncated=True)

    def _checkpoint_with_active(self):
        """Checkpoint while transactions are in flight: export the
        committed-visible snapshot (stamps normalized by the writer),
        then rewrite the WAL with only the active transactions' frames —
        their eventual COMMIT replays them on top of the snapshot, their
        ABORT (or a crash) discards them."""
        frames = self.wal.frame_count
        self.wal.flush(force=True)
        read_ts = self.mgr.snapshot_ts()
        for schema, tables in self.catalog.items():
            for info in tables.values():
                if info.temporary:
                    continue
                t = info.table
                vis = t.visible_indices(self.mgr, read_ts, own_txn=0)
                self.fm.write_table_snapshot(schema, t, indices=vis)
                # .hnsw snapshots would freeze uncommitted graph nodes;
                # drop them — open() rebuilds/reindexes from the table
                import os as _os

                for iname in info.hnsw:
                    p = self.fm.hnsw_path(schema, t.name, iname)
                    if _os.path.exists(p):
                        _os.remove(p)
        self.fm.write_catalog(self._catalog_doc())
        self.fm.write_meta(
            {"version": 1, "next_table_id": self._next_table_id}
        )
        active_ids = set(self.mgr.active.keys())
        keep = [
            (ftype, payload, txn_id, table_id)
            for _, ftype, txn_id, table_id, payload in self.wal.replay()
            if txn_id in active_ids
        ]
        self.wal.truncate()
        for ftype, payload, txn_id, table_id in keep:
            self.wal.append(ftype, payload, txn_id=txn_id, table_id=table_id)
        self.wal.flush(force=True)
        self.last_checkpoint_frames = frames - len(keep)
        return CheckpointInfo(
            frames_checkpointed=frames - len(keep), wal_truncated=not keep
        )

    # ------------------------------------------------------------------
    # recovery (reference recovery.rs single-pass replay)
    # ------------------------------------------------------------------

    def _replay_wal(self):
        self._replay_touched: set = set()
        self._recovered_frames = 0
        pending: dict[int, list] = {}
        for lsn, ftype, txn_id, table_id, payload in self.wal.replay():
            self._recovered_frames += 1
            if ftype is FrameType.BEGIN:
                pending[txn_id] = []
            elif ftype in (FrameType.INSERT, FrameType.DELETE, FrameType.UPDATE,
                           FrameType.DDL, FrameType.BULK_INSERT,
                           FrameType.TOAST):
                pending.setdefault(txn_id, []).append((ftype, table_id, payload))
            elif ftype is FrameType.SPABORT:
                # ROLLBACK TO savepoint: drop the undone tail
                drop = int.from_bytes(payload[:8], "little")
                lst = pending.get(txn_id)
                if lst and drop:
                    del lst[max(len(lst) - drop, 0):]
            elif ftype is FrameType.COMMIT:
                ops = pending.pop(txn_id, [])
                self._apply_replay(ops)
            elif ftype is FrameType.ABORT:
                pending.pop(txn_id, None)
        # uncommitted leftovers are dropped (crash before commit)
        # the auto-increment counter lives in snapshots only: advance it
        # past every replayed value so post-recovery inserts don't collide
        for tables in self.catalog.values():
            for info in tables.values():
                t = info.table
                for cd in info.columns:
                    if cd.auto_increment and t.nversions:
                        col = t.cols[cd.name][: t.nversions]
                        nn = ~t.nulls[cd.name][: t.nversions]
                        if nn.any():
                            t.auto_increment = max(
                                t.auto_increment, int(col[nn].max()) + 1
                            )

    def _apply_replay(self, ops):
        self._replaying = True
        try:
            txn = self.mgr.begin()
            for ftype, table_id, payload in ops:
                if ftype is FrameType.DDL:
                    doc = jsonb_decode(payload)
                    self._execute_stmt(_parse_stmt(doc["sql"]), [], txn)
                    continue
                info = self._table_by_id(table_id)
                if info is None:
                    continue
                if ftype is FrameType.TOAST:
                    # rebuild the chunk store before the row that uses it
                    from turdb_tpu_torch.config import TOAST_CHUNK_SIZE
                    from turdb_tpu_torch.storage.toast import POINTER_LEN

                    pointer = payload[:POINTER_LEN]
                    raw = payload[POINTER_LEN:]
                    import struct as _s

                    tid = _s.unpack_from("<Q", pointer, 1)[0]
                    store = info.table.toast
                    store.chunks[tid] = [
                        raw[i : i + TOAST_CHUNK_SIZE]
                        for i in range(0, len(raw), TOAST_CHUNK_SIZE)
                    ]
                    store.next_id = max(store.next_id, tid + 1)
                    continue
                if ftype is FrameType.INSERT or ftype is FrameType.UPDATE:
                    rowid = int.from_bytes(payload[:8], "little")
                    rec = payload[8:]
                    values = unpack_record(info.record_schema(), rec)
                    row = {c.name: v for c, v in zip(info.columns, values)}
                    from turdb_tpu_torch.storage.toast import Toasted

                    for c, v in row.items():
                        if isinstance(v, Toasted):
                            v.store = info.table.toast
                            info.table.toast_cols.add(c)
                    if ftype is FrameType.INSERT:
                        info.table.insert_rows([row], txn, rowids=[rowid])
                    else:
                        if not info.table.update_row(rowid, row, txn):
                            info.table.insert_rows([row], txn, rowids=[rowid])
                elif ftype is FrameType.DELETE:
                    rowid = int.from_bytes(payload[:8], "little")
                    info.table.delete_row(rowid, txn)
                elif ftype is FrameType.BULK_INSERT:
                    import io

                    with np.load(io.BytesIO(payload), allow_pickle=True) as z:
                        rids = z["rowids"]
                        data = {
                            k[2:]: (z[k], z["n_" + k[2:]])
                            for k in z.files
                            if k.startswith("v_")
                        }
                    info.table.insert_columns(data, txn, rowids=rids)
                    self._replay_touched.update(
                        (table_id, int(r)) for r in rids
                    )
                if ftype in (FrameType.INSERT, FrameType.UPDATE, FrameType.DELETE):
                    rowid = int.from_bytes(payload[:8], "little")
                    self._replay_touched.add((table_id, rowid))
            self.mgr.commit(txn)
        finally:
            self._replaying = False

    def _rebuild_indexes(self):
        for schema, tables in self.catalog.items():
            for info in tables.values():
                self._reindex(info)

    def _reindex(self, info: TableInfo, txn: Transaction | None = None,
                 hnsw: bool = True):
        """Rebuild the table's sorted-run indexes. `txn`: in-flight
        transaction whose OWN uncommitted rows must be indexed (the bulk
        loader reindexes before commit; without own-txn visibility the
        fresh rows were invisible here and index scans silently missed
        them). Phantom entries from a later rollback are harmless: every
        probe re-verifies its candidates against MVCC visibility.
        `hnsw=False` skips vector indexes (the bulk loader maintains them
        itself — reinserting here would double-insert)."""
        for name, idx in info.btree.items():
            idx.clear()
        read_ts = self.mgr.snapshot_ts()
        own = txn.txn_id if txn is not None else 0
        vis = info.table.visible_indices(self.mgr, read_ts, own)
        rowids_vis = info.table.rowids[vis]
        for name, idx in info.btree.items():
            # partial index: only rows satisfying the predicate
            mask = self._index_pred_mask(info, name, vis)
            ivis = vis if mask is None else vis[mask]
            irids = rowids_vis if mask is None else rowids_vis[mask]
            cols = info.btree_cols[name]
            if cols is None:    # expression index: vectorized expr eval
                idx.bulk_load(
                    _expr_index_keys(self, info, name, ivis), irids
                )
                continue
            keys = _batch_index_keys(info.table, cols, ivis)
            if keys is not None:
                idx.bulk_load(keys, irids)
            else:
                idx.clear()
                for i in ivis:
                    rowid = int(info.table.rowids[i])
                    key = idx.make_key(
                        [_cell(info.table, c, int(i)) for c in cols]
                    )
                    idx.insert(key, rowid)
        if not hnsw:
            return
        touched = getattr(self, "_replay_touched", set())
        snapshot_loaded = getattr(info, "_hnsw_loaded", False)
        for name, h in info.hnsw.items():
            col = h.column
            for i in vis:
                rowid = int(info.table.rowids[i])
                if info.table.nulls[col][i]:
                    continue
                # incremental: already-mapped rows stay (a mapped slot
                # always holds the rowid's CURRENT vector — insert/update
                # maintain it); re-inserting them here made every VACUUM
                # duplicate the whole live graph. After a snapshot load,
                # WAL-touched rows DO re-insert (reference rebuilds
                # row_id_map on open, mod.rs:767-859)
                if rowid in h.rowid_to_slot and (
                    not snapshot_loaded
                    or (info.table.table_id, rowid) not in touched
                ):
                    continue
                h.insert(rowid, info.table.cols[col][int(i)], defer=True)
            h.flush_pending()

    def _table_by_id(self, table_id: int) -> TableInfo | None:
        for tables in self.catalog.values():
            for info in tables.values():
                if info.table.table_id == table_id:
                    return info
        return None

    # ------------------------------------------------------------------
    # public API (reference database.rs execute/query/prepare)
    # ------------------------------------------------------------------

    def execute(self, sql: str, params=None) -> ExecuteResult:
        from turdb_tpu_torch.utils.timing import timed

        with timed("parse"):
            stmt = _parse_stmt(sql)
        with timed("execute"), self._stmt_lock:
            res = self._dispatch(stmt, list(params or []), sql)
        h = self._durable_hook[0]
        if h is not None:
            h()   # group-commit fsync OUTSIDE the statement lock
        return res

    def query(self, sql: str, params=None) -> list[tuple]:
        return self.query_with_columns(sql, params)[1]

    def query_with_columns(self, sql: str, params=None):
        from turdb_tpu_torch.utils.timing import timed

        with timed("parse"):
            stmt = _parse_stmt(sql)
        with self._stmt_lock:
            if isinstance(stmt, A.Explain):
                return self._explain(stmt, list(params or []))
            if not isinstance(stmt, A.Select):
                res = self._dispatch(stmt, list(params or []), sql)
                out = (res.columns or [], res.rows or [])
            else:
                ctx = self._ctx(list(params or []))
                with timed("query"):
                    batch = self.engine.run_select(stmt, ctx)
                if stmt.for_update and self._txn is not None:
                    batch = self._lock_batch_rows(batch, stmt.for_update)
                return _batch_to_rows(batch)
        h = self._durable_hook[0]
        if h is not None:
            h()   # group-commit fsync OUTSIDE the statement lock
        return out

    def prepare(self, sql: str) -> "PreparedStatement":
        return PreparedStatement(self, sql)

    def insert_batch(self, table: str, rows,
                     schema: str = "main") -> ExecuteResult:
        """Programmatic multi-row insert without SQL parsing (reference
        batch.rs insert_batch). Full constraint pipeline applies.
        `rows` is a list[dict] OR a columnar dict {col: array-or-
        (values, null_mask)} — the columnar form takes the vectorized
        fast-load pipeline (reference fast_load.rs)."""
        from turdb_tpu_torch.database import dml

        self._check_writable()
        with self._stmt_lock:
            txn, own = self._begin_write()
            try:
                ref = A.TableRef(table, schema if schema != "main" else None)
                info = self.resolve_table(ref)
                if isinstance(rows, dict):
                    res = dml.bulk_insert_columns(self, info, rows, txn)
                else:
                    res = dml.bulk_insert_rows(self, info, rows, txn)
                if own:
                    self._commit(txn)
            except Exception:
                if own:
                    self.mgr.abort(txn)
                raise
        h = self._durable_hook[0]
        if h is not None:
            h()   # group-commit fsync OUTSIDE the statement lock
        return res

    def bulk_insert(self, table: str, rows,
                    schema: str = "main") -> ExecuteResult:
        """Bulk loader: defers per-row WAL flushing and HNSW graph work to
        the end of the batch (reference fast_load.rs FastLoader, 4-6x)."""
        prev = self.wal_autoflush
        self.wal_autoflush = False
        try:
            res = self.insert_batch(table, rows, schema)
        finally:
            self.wal_autoflush = prev
            if prev:
                self.wal.flush()
                h = self._durable_hook[0]
                if h is not None:
                    h()   # batch frames were deferred past the hook
        return res

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _dispatch(self, stmt, params, sql: str) -> ExecuteResult:
        if isinstance(stmt, A.Select):
            cols, rows = self.query_with_columns(sql, params)
            return ExecuteResult(rows_affected=0, rows=rows, columns=cols)
        if isinstance(stmt, A.TxnStmt):
            return self._txn_stmt(stmt)
        if isinstance(stmt, A.Pragma):
            return self._pragma(stmt)
        if isinstance(stmt, A.Explain):
            cols, rows = self._explain(stmt, params)
            return ExecuteResult(rows=rows, columns=cols)
        if isinstance(stmt, A.Vacuum):
            n = 0
            for tables in self.catalog.values():
                for info in tables.values():
                    if stmt.table and info.table.name != stmt.table:
                        continue
                    n += info.table.vacuum(self.mgr)
                    # graph compaction (reference VacuumQueue): the live
                    # set comes from the TABLE (DML leaves the graph
                    # append-only); _reindex then re-inserts any rows
                    # the compacted graph is missing
                    if info.hnsw:
                        vis = info.table.visible_indices(
                            self.mgr, self.mgr.snapshot_ts(), 0
                        )
                        live = info.table.rowids[vis]
                        for iname, h in list(info.hnsw.items()):
                            if hasattr(h, "vacuum"):
                                h.vacuum(live_rowids=live)
                            elif h.dead_fraction(live) >= 0.25:
                                # IVF blocks are append-only: rebuild
                                # fresh; _reindex repopulates from the
                                # table and the engine auto-trains
                                self._instantiate_index(
                                    info, info.index_defs[iname]
                                )
                    self._reindex(info)
            return ExecuteResult(rows_affected=n)
        if isinstance(stmt, A.Analyze):
            return self._analyze(stmt.table)
        self._check_writable()
        if self._txn is not None and getattr(self._txn, "read_only", False):
            raise DatabaseError(
                "cannot execute writes in a READ ONLY transaction"
            )
        txn, own = self._begin_write()
        try:
            res = self._execute_stmt(stmt, params, txn, sql)
            if own:
                self._commit(txn)
            return res
        except Exception:
            if own:
                self.mgr.abort(txn)
            raise

    def _execute_stmt(self, stmt, params, txn, sql: str | None = None) -> ExecuteResult:
        from turdb_tpu_torch.database import ddl, dml

        if isinstance(stmt, A.Insert):
            return dml.execute_insert(self, stmt, params, txn)
        if isinstance(stmt, A.Update):
            return dml.execute_update(self, stmt, params, txn)
        if isinstance(stmt, A.Delete):
            return dml.execute_delete(self, stmt, params, txn)
        if isinstance(stmt, A.Truncate):
            return dml.execute_truncate(self, stmt, txn)
        if isinstance(stmt, A.Merge):
            return dml.execute_merge(self, stmt, params, txn)
        if isinstance(stmt, A.Call):
            return dml.execute_call(self, stmt, params, txn)
        if isinstance(stmt, (A.CreateTable, A.CreateIndex, A.CreateSchema,
                             A.CreateView, A.CreateType, A.CreateFunction,
                             A.CreateTrigger, A.CreateProcedure,
                             A.Drop, A.AlterTable, A.Grant)):
            # DDL touching TEMP tables must not reach the WAL: replay
            # after reopen would reference a table that no longer exists
            # (temp tables die with the process, reference ast.rs:330)
            temp = self._ddl_touches_temp(stmt)
            res = ddl.execute_ddl(self, stmt, txn)
            if sql is not None and not temp:
                self._log_ddl(sql, txn)
            return res
        if isinstance(stmt, A.Select):
            ctx = self._ctx(params, txn)
            batch = self.engine.run_select(stmt, ctx)
            cols, rows = _batch_to_rows(batch)
            return ExecuteResult(rows=rows, columns=cols)
        raise DatabaseError(f"cannot execute {type(stmt).__name__}")

    # ------------------------------------------------------------------
    # transactions (reference database/transaction.rs)
    # ------------------------------------------------------------------

    def _txn_stmt(self, stmt: A.TxnStmt) -> ExecuteResult:
        k = stmt.kind
        if k == "BEGIN":
            if self._txn is not None:
                raise DatabaseError("transaction already in progress")
            self._check_writable()
            self._txn = self.mgr.begin()
            # every isolation level maps to snapshot isolation; READ ONLY
            # rejects writes for the transaction's duration
            self._txn.read_only = bool(getattr(stmt, "read_only", False))
            if self.wal_enabled:
                self.wal.append(FrameType.BEGIN, txn_id=self._txn.txn_id)
            return ExecuteResult(0)
        if k == "COMMIT":
            if self._txn is None:
                raise DatabaseError("no transaction in progress")
            self._commit(self._txn)
            self._txn = None
            return ExecuteResult(0)
        if k == "ROLLBACK":
            if self._txn is None:
                raise DatabaseError("no transaction in progress")
            if self.wal_enabled:
                self.wal.append(FrameType.ABORT, txn_id=self._txn.txn_id)
                self._flush_wal()
            self.mgr.abort(self._txn)
            self._txn = None
            return ExecuteResult(0)
        if k == "SAVEPOINT":
            txn = self._require_txn()
            txn.savepoint(stmt.name)
            if self.wal_enabled:
                marks = getattr(txn, "wal_marks", None)
                if marks is None:
                    marks = txn.wal_marks = {}
                marks[stmt.name] = self.wal.txn_frames(txn.txn_id)
            return ExecuteResult(0)
        if k == "RELEASE":
            self._require_txn().release_savepoint(stmt.name)
            return ExecuteResult(0)
        if k == "ROLLBACK_TO":
            txn = self._require_txn()
            txn.rollback_to(stmt.name)
            if self.wal_enabled:
                # compensate the WAL: replay must drop this txn's frames
                # appended since the savepoint (they were just undone)
                mark = getattr(txn, "wal_marks", {}).get(stmt.name, 0)
                drop = self.wal.txn_frames(txn.txn_id) - mark
                if drop > 0:
                    self.wal.append(
                        FrameType.SPABORT, drop.to_bytes(8, "little"),
                        txn_id=txn.txn_id,
                    )
                    self.wal.set_txn_frames(txn.txn_id, mark)
            return ExecuteResult(0)
        raise DatabaseError(f"bad txn statement {k}")

    def _require_txn(self) -> Transaction:
        if self._txn is None:
            raise DatabaseError("no transaction in progress")
        return self._txn

    def _begin_write(self):
        if self._txn is not None:
            return self._txn, False
        txn = self.mgr.begin()
        if self.wal_enabled and not self._replaying:
            self.wal.append(FrameType.BEGIN, txn_id=txn.txn_id)
        return txn, True

    def _commit(self, txn: Transaction):
        if self.wal_enabled and not self._replaying:
            self.wal.append(FrameType.COMMIT, txn_id=txn.txn_id)
            self._flush_wal()
        self.mgr.commit(txn)
        # WAL size-based auto checkpoint (reference constants.rs:182;
        # threshold runtime-settable, pragma.rs:241-257)
        if self.wal_enabled and self.wal.frame_count >= self.checkpoint_threshold:
            self.checkpoint()

    def _flush_wal(self):
        if self.wal_autoflush:
            self.wal.flush()

    def _refresh_durable_hook(self):
        """Re-derive the post-statement group-commit hook; called at
        open and whenever PRAGMA wal / synchronous changes."""
        full = self.wal_enabled and self.sync_mode is SyncMode.FULL
        self._durable_hook[0] = self.wal.commit_durable if full else None

    def _check_writable(self):
        if self.mode != "rw":
            raise ReadOnlyError(
                "database is in read-only degraded mode; run PRAGMA recover_wal"
            )

    # ------------------------------------------------------------------
    # WAL logging helpers (called by dml.py)
    # ------------------------------------------------------------------

    def _analyze(self, table: str | None) -> ExecuteResult:
        """ANALYZE [table]: row counts + per-column distinct / null-frac
        estimates (sampled at 100k rows), queryable via
        turdb_catalog.statistics. The executor's greedy join order uses
        ACTUAL materialized counts, so these stats are observational —
        the reference lexes ANALYZE without implementing it at all."""
        import datetime

        if not hasattr(self, "stats"):
            self.stats = {}
        now = datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds")
        read_ts = self.mgr.snapshot_ts()
        n_analyzed = 0
        for schema, tables in self.catalog.items():
            for tname, info in tables.items():
                if table and tname != table:
                    continue
                vis = info.table.visible_indices(self.mgr, read_ts)
                if len(vis) > 100_000:
                    rng = np.random.default_rng(0)
                    sample = vis[rng.choice(len(vis), 100_000,
                                            replace=False)]
                else:
                    sample = vis
                cols = {}
                for cd in info.columns:
                    vals = info.table.cols[cd.name][sample]
                    nulls = info.table.nulls[cd.name][sample]
                    nn = vals[~nulls]
                    try:
                        nd = len(np.unique(nn))
                    except TypeError:       # unhashable/unsortable cells
                        nd = len(set(map(str, nn)))
                    frac = float(nulls.mean()) if len(sample) else 0.0
                    cols[cd.name] = {"n_distinct": int(nd),
                                     "null_frac": frac}
                self.stats[(schema, tname)] = {
                    "rows": int(len(vis)), "columns": cols,
                    "analyzed_at": now,
                }
                n_analyzed += 1
        return ExecuteResult(rows_affected=n_analyzed)

    def _ddl_touches_temp(self, stmt) -> bool:
        if isinstance(stmt, A.CreateTable):
            return stmt.temporary
        ref = getattr(stmt, "table", None)
        if isinstance(ref, A.TableRef):
            info = self.catalog.get(ref.schema or "main", {}).get(ref.name)
            return bool(info is not None
                        and getattr(info, "temporary", False))
        if isinstance(stmt, A.Drop) and stmt.kind == "TABLE":
            info = self.catalog.get(stmt.schema or "main", {}).get(stmt.name)
            return bool(info is not None
                        and getattr(info, "temporary", False))
        return False

    def _log_insert(self, info: TableInfo, rowid: int, row: dict, txn):
        if not self.wal_enabled or self._replaying or info.temporary:
            return
        rec = pack_record(
            info.record_schema(), [row.get(c.name) for c in info.columns]
        )
        self.wal.append(
            FrameType.INSERT,
            rowid.to_bytes(8, "little") + rec,
            txn_id=txn.txn_id,
            table_id=info.table.table_id,
        )

    def _log_update(self, info: TableInfo, rowid: int, row: dict, txn):
        if not self.wal_enabled or self._replaying or info.temporary:
            return
        rec = pack_record(
            info.record_schema(), [row.get(c.name) for c in info.columns]
        )
        self.wal.append(
            FrameType.UPDATE,
            rowid.to_bytes(8, "little") + rec,
            txn_id=txn.txn_id,
            table_id=info.table.table_id,
        )

    def _log_delete(self, info: TableInfo, rowid: int, txn):
        if not self.wal_enabled or self._replaying or info.temporary:
            return
        self.wal.append(
            FrameType.DELETE,
            rowid.to_bytes(8, "little"),
            txn_id=txn.txn_id,
            table_id=info.table.table_id,
        )

    def _log_bulk_insert(self, info: TableInfo, rowids, prepared: dict, txn):
        """ONE columnar frame for a whole bulk load (vs n row frames)."""
        if not self.wal_enabled or self._replaying or info.temporary:
            return
        import io

        buf = io.BytesIO()
        payload = {"rowids": np.asarray(rowids, np.int64)}
        for name, (vals, nulls) in prepared.items():
            payload[f"v_{name}"] = np.asarray(vals)
            payload[f"n_{name}"] = np.asarray(nulls, bool)
        np.savez(buf, **payload, allow_pickle=True)
        self.wal.append(
            FrameType.BULK_INSERT,
            buf.getvalue(),
            txn_id=txn.txn_id,
            table_id=info.table.table_id,
        )

    def _log_toast(self, info: TableInfo, pointer: bytes, raw: bytes, ctx):
        """Chunk bytes must reach the WAL once so replay can rebuild the
        store (reference logs hidden _toast-table inserts the same way)."""
        if not self.wal_enabled or self._replaying or info.temporary:
            return
        self.wal.append(
            FrameType.TOAST,
            pointer + raw,
            txn_id=getattr(ctx, "own_txn", 0),
            table_id=info.table.table_id,
        )

    def _log_ddl(self, sql: str, txn):
        if not self.wal_enabled or self._replaying:
            return
        if self._txn is not None and txn is self._txn:
            # DDL is non-transactional (its live effects survive ROLLBACK
            # / ROLLBACK TO): log it as its own committed unit so crash
            # recovery matches live semantics instead of dropping the DDL
            # with the enclosing txn's frames
            tid = (1 << 62) + self.wal.next_lsn
            self.wal.append(FrameType.BEGIN, txn_id=tid)
            self.wal.append(
                FrameType.DDL, jsonb_encode({"sql": sql}), txn_id=tid
            )
            self.wal.append(FrameType.COMMIT, txn_id=tid)
            return
        self.wal.append(
            FrameType.DDL, jsonb_encode({"sql": sql}), txn_id=txn.txn_id
        )

    # ------------------------------------------------------------------
    # catalog resolution
    # ------------------------------------------------------------------

    def resolve_table(self, ref: A.TableRef) -> TableInfo:
        schema = ref.schema or "main"
        tables = self.catalog.get(schema)
        if tables is None or ref.name not in tables:
            if ref.name in self.views.get(schema, {}):
                raise SqlError(
                    f"{schema}.{ref.name} is a view: views are read-only"
                )
            raise SqlError(f"no such table: {schema}.{ref.name}")
        return tables[ref.name]

    # ------------------------------------------------------------------
    # scan source for the engine
    # ------------------------------------------------------------------

    def _ctx(self, params, txn: Transaction | None = None) -> EvalContext:
        ctx = EvalContext(params, self.engine._subquery_fn)
        t = txn or self._txn
        if t is not None:
            ctx.read_ts = t.read_ts
            ctx.own_txn = t.txn_id
        else:
            ctx.read_ts = self.mgr.snapshot_ts()
            ctx.own_txn = 0
        ctx.query_budget = self.join_budget_override or self.budget.pool("query")
        ctx.budget = self.budget
        ctx.db = self  # decorrelation needs catalog scope resolution
        return ctx

    def _scan_batch(self, ref: A.TableRef, ctx) -> Batch:
        schema = ref.schema or "main"
        if schema == "turdb_catalog":
            from turdb_tpu_torch.database.meta import system_table_batch

            return system_table_batch(self, ref)
        info = self.resolve_table(ref)
        read_ts = getattr(ctx, "read_ts", None) or self.mgr.snapshot_ts()
        own = getattr(ctx, "own_txn", 0)
        vis = info.table.visible_indices(self.mgr, read_ts, own)
        q = ref.alias or ref.name
        # projection pruning (reference projection_pruning.rs): only
        # materialize columns the query references
        needed = getattr(ctx, "needed_cols", None)
        take_all = needed is None or (q, "*") in needed
        b = Batch(len(vis))
        for c in info.columns:
            if not take_all and (None, c.name) not in needed \
                    and (q, c.name) not in needed:
                continue
            vals, nulls = info.table.column_batch(c.name, vis)
            # column_batch fancy-indexing already copied; no second copy
            b.add(q, c.name, Col(_detoast_col(info.table, c.name, vals), nulls))
        b.add(q, ROWID, Col(info.table.rowids[vis].copy()))
        return b

    # ------------------------------------------------------------------
    # index point-lookup hook (wired by QueryEngine._select_core)
    # ------------------------------------------------------------------

    def _index_pred_mask(self, info: TableInfo, name: str, vis):
        """Vectorized partial-index predicate over version indices `vis`
        (reference table.rs:273 where_clause): True where the row belongs
        in the index. Returns None for full indexes."""
        expr = info.btree_where.get(name)
        if expr is None:
            return None
        arr = np.asarray(vis, np.int64)
        b = Batch(len(arr))
        for c in info.columns:
            vals, nulls = info.table.column_batch(c.name, arr)
            b.add(info.table.name, c.name,
                  Col(_detoast_col(info.table, c.name, vals), nulls))
        col = eval_expr(expr, b, self._ctx([], None))
        return np.asarray(col.values, bool) & ~col.nulls

    def _partial_pred_implied(self, info: TableInfo, name: str, where,
                              qualifier: str) -> bool:
        """A partial index may serve a scan only when the query's WHERE
        contains the index predicate as a conjunct (conservative
        structural implication — anything else risks missing rows)."""
        pred = info.btree_where.get(name)
        if pred is None:
            return True
        want = A.render_expr(_strip_quals(pred, qualifier))
        stack = [where]
        while stack:
            e = stack.pop()
            if isinstance(e, A.BinaryOp) and e.op == "AND":
                stack += [e.left, e.right]
            elif e is not None and A.render_expr(
                _strip_quals(e, qualifier)
            ) == want:
                return True
        return False

    def _index_choice(self, ref: A.TableRef, where, ctx):
        """Shared index-selection decision (executor + planner, plan.py):
        equality conjuncts covering a B-tree index, else a single-column
        range with a selectivity cutoff (reference index_selection.rs:38,
        bounds.rs:50). Probes the index (that IS the selectivity test) and
        returns an IndexChoice carrying the candidate rowids, or None."""
        if (ref.schema or "main") == "turdb_catalog":
            return None
        try:
            info = self.resolve_table(ref)
        except SqlError:
            return None
        # collect col = const conjuncts (+ expr = const for expression
        # indexes, reference ddl.rs expression indexes)
        eqs: dict[str, object] = {}
        expr_eqs: dict[str, object] = {}

        def _const_val(b):
            if isinstance(b, A.Literal):
                return b.value
            if isinstance(b, A.Param) and b.index <= len(ctx.params):
                return ctx.params[b.index - 1]
            return None

        def walk(e):
            if isinstance(e, A.BinaryOp) and e.op == "AND":
                walk(e.left)
                walk(e.right)
            elif isinstance(e, A.BinaryOp) and e.op == "=":
                a, b = e.left, e.right
                if isinstance(a, (A.Literal, A.Param)) and not isinstance(
                    b, (A.Literal, A.Param)
                ):
                    a, b = b, a          # constant on the right
                if not isinstance(b, (A.Literal, A.Param)):
                    return
                v = _const_val(b)
                if v is None:
                    return
                q = ref.alias or ref.name
                if isinstance(a, A.ColumnRef):
                    if a.table in (None, q):
                        eqs[a.name] = v
                elif not isinstance(a, (A.Literal, A.Param)):
                    expr_eqs[A.render_expr(_strip_quals(a, q))] = v
        # range conjuncts: col {<,<=,>,>=} const (reference bounds.rs:50)
        ranges: dict[str, list] = {}

        def walk_rng(e):
            if isinstance(e, A.BinaryOp) and e.op == "AND":
                walk_rng(e.left)
                walk_rng(e.right)
            elif isinstance(e, A.BinaryOp) and e.op in ("<", "<=", ">", ">="):
                a, bnd = e.left, e.right
                op = e.op
                if not isinstance(a, A.ColumnRef):
                    a, bnd = bnd, a
                    op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
                if isinstance(a, A.ColumnRef) and isinstance(
                    bnd, (A.Literal, A.Param)
                ):
                    qn = ref.alias or ref.name
                    if a.table in (None, qn):
                        v = (
                            bnd.value
                            if isinstance(bnd, A.Literal)
                            else (
                                ctx.params[bnd.index - 1]
                                if bnd.index <= len(ctx.params)
                                else None
                            )
                        )
                        if v is not None:
                            ranges.setdefault(a.name, []).append((op, v))

        walk(where)
        walk_rng(where)
        qn = ref.alias or ref.name
        if eqs or expr_eqs:
            for name, idx in info.btree.items():
                if name in info.btree_where and not self._partial_pred_implied(
                    info, name, where, qn
                ):
                    continue
                cols = info.btree_cols[name]
                if cols is None:
                    keys = [
                        A.render_expr(_strip_quals(e, info.table.name))
                        for e in info.btree_exprs[name]
                    ]
                    if all(k in expr_eqs for k in keys):
                        key = idx.make_key(
                            [_norm_probe(expr_eqs[k]) for k in keys]
                        )
                        return IndexChoice(
                            info, name, "eq", tuple(keys), idx.find(key)
                        )
                    continue
                if all(c in eqs for c in cols):
                    key = idx.make_key([_norm_probe(eqs[c]) for c in cols])
                    return IndexChoice(
                        info, name, "eq", tuple(cols), idx.find(key)
                    )
        if ranges:
            from turdb_tpu_torch.records.keys import encode_value

            for name, idx in info.btree.items():
                if name in info.btree_where and not self._partial_pred_implied(
                    info, name, where, qn
                ):
                    continue
                cols = info.btree_cols[name]
                if cols is not None and len(cols) == 1 and cols[0] in ranges:
                    lo = hi = None
                    lo_inc = hi_inc = True
                    for op, v in ranges[cols[0]]:
                        kb = encode_value(_norm_probe(v))
                        if op in (">", ">="):
                            if lo is None or kb > lo:
                                lo, lo_inc = kb, op == ">="
                        else:
                            if hi is None or kb < hi:
                                hi, hi_inc = kb, op == "<="
                    cand = idx.range(lo, hi, lo_inc, hi_inc)
                    # a huge range is slower than the vectorized scan
                    if len(cand) <= max(64, info.table.nversions // 3):
                        return IndexChoice(
                            info, name, "range", tuple(cols), cand
                        )
                    break
        return None

    def _try_index_scan(self, ref: A.TableRef, where, ctx) -> Batch | None:
        """Execute the _index_choice decision: resolve candidate rowids
        against the MVCC snapshot and materialize the candidate batch."""
        choice = self._index_choice(ref, where, ctx)
        if choice is None:
            return None
        info, rowids = choice.info, choice.rowids
        read_ts = getattr(ctx, "read_ts", None) or self.mgr.snapshot_ts()
        own = getattr(ctx, "own_txn", 0)
        vidx = []
        for rid in rowids:
            # chain walk: the snapshot may see an OLDER version than latest
            # (concurrent committed UPDATE/DELETE); the full WHERE is
            # re-evaluated on the candidate batch, so a version whose
            # indexed value changed is filtered there
            i = info.table.visible_version(self.mgr, rid, read_ts, own)
            if i is not None:
                vidx.append(i)
        q = ref.alias or ref.name
        arr = np.asarray(vidx, np.int64)
        b = Batch(len(arr))
        for c in info.columns:
            vals, nulls = info.table.column_batch(c.name, arr)
            # column_batch fancy-indexing already copied; no second copy
            b.add(q, c.name, Col(_detoast_col(info.table, c.name, vals), nulls))
        b.add(q, ROWID, Col(info.table.rowids[arr].copy()))
        return b

    # ------------------------------------------------------------------
    # ANN fast path hook (wired by QueryEngine._try_ann_path)
    # ------------------------------------------------------------------

    def _ann_choice(self, info: TableInfo, colname: str, op: str):
        """Shared ANN index resolution (executor + planner, plan.py):
        the first vector index on `colname` whose metric matches the
        operator. Returns (index_name, engine_kind) or None."""
        metric = {"<->": Metric.L2, "<#>": Metric.IP, "<=>": Metric.COSINE}[op]
        for name, h in info.hnsw.items():
            if h.column == colname and h.metric is metric:
                return name, type(h).__name__.replace("TableIndex", "").lower()
        return None

    def _ann_search(self, sel: A.Select, colref: A.ColumnRef, qvec, op, k, ctx):
        if not self.ann_enabled:
            return None
        ref = sel.from_
        try:
            info = self.resolve_table(ref)
        except SqlError:
            return None
        choice = self._ann_choice(info, colref.name, op)
        if choice is None:
            return None
        hidx = info.hnsw[choice[0]]
        read_ts = getattr(ctx, "read_ts", None) or self.mgr.snapshot_ts()
        own = getattr(ctx, "own_txn", 0)
        # everything below is whole-array ops — no per-row host work
        # (round-1 built Python sets/dicts over all N rows per query)
        vis = info.table.visible_indices(self.mgr, read_ts, own)
        visible_rowids = info.table.rowids[vis]
        fetch = min(max(k * self.ann_overfetch, k + 8), max(len(visible_rowids), 1))
        d, rowids = hidx.search(
            qvec, k=fetch, ef=max(64, 2 * fetch), allowed_rowids=visible_rowids
        )
        rowids = np.asarray(rowids, np.int64)
        rowids = rowids[rowids >= 0]
        # map result rowids -> visible version indices (sorted probe; one
        # visible version per rowid under a snapshot)
        order = np.argsort(visible_rowids, kind="stable")
        pos = np.searchsorted(visible_rowids, rowids, sorter=order)
        pos = np.clip(pos, 0, max(len(vis) - 1, 0))
        hit = (
            visible_rowids[order[pos]] == rowids
            if len(vis) else np.zeros(len(rowids), bool)
        )
        idx = vis[order[pos[hit]]]
        q = ref.alias or ref.name
        b = Batch(len(idx))
        for c in info.columns:
            vals, nulls = info.table.column_batch(c.name, idx)
            # column_batch fancy-indexing already copied; no second copy
            b.add(q, c.name, Col(_detoast_col(info.table, c.name, vals), nulls))
        b.add(q, ROWID, Col(info.table.rowids[idx].copy()))
        if sel.where is not None:
            c = eval_expr(sel.where, b, ctx)
            keep = np.flatnonzero(c.values.astype(bool) & ~c.nulls)
            if len(keep) < min(k, len(visible_rowids)):
                # over-fetch didn't survive the filter: push the
                # predicate INTO the search as an allowed mask
                # (reference search_filtered doctrine, hnsw/mod.rs:62-68 —
                # non-matching nodes stay stepping stones, results are
                # masked) before giving up to the exact fallback
                return self._ann_search_filtered(
                    sel, info, hidx, qvec, k, vis, visible_rowids, ref, ctx
                )
            b = b.take(keep)
        return b

    def _ann_search_filtered(self, sel, info, hidx, qvec, k, vis,
                             visible_rowids, ref, ctx):
        """Second-pass filtered ANN: evaluate the WHERE over the visible
        rows once (vectorized), search with the matching rowids as the
        allowed mask, and return only matches. Costs one predicate scan —
        the exact fallback it replaces costs that scan PLUS exact
        distances. Returns None (exact fallback) when too few rows match
        for the graph search to be trustworthy."""
        q = ref.alias or ref.name
        big = Batch(len(vis))
        for c in info.columns:
            vals, nulls = info.table.column_batch(c.name, vis)
            big.add(q, c.name,
                    Col(_detoast_col(info.table, c.name, vals), nulls))
        big.add(q, ROWID, Col(info.table.rowids[vis].copy()))
        m = eval_expr(sel.where, big, ctx)
        match = m.values.astype(bool) & ~m.nulls
        allowed = visible_rowids[match]
        if len(allowed) <= max(4 * k, 64):
            # tiny candidate set: exact distances on it beat a graph walk
            return None
        fetch = min(max(k * self.ann_overfetch, k + 8), len(allowed))
        d, rowids = hidx.search(
            qvec, k=fetch, ef=max(64, 2 * fetch), allowed_rowids=allowed
        )
        rowids = np.asarray(rowids, np.int64)
        rowids = rowids[rowids >= 0]
        if len(rowids) < min(k, len(allowed)):
            return None   # graph couldn't reach enough: exact fallback
        order = np.argsort(allowed, kind="stable")
        pos = np.searchsorted(allowed, rowids, sorter=order)
        pos = np.clip(pos, 0, max(len(allowed) - 1, 0))
        hit = allowed[order[pos]] == rowids
        avis = vis[match]
        idx = avis[order[pos[hit]]]
        from turdb_tpu_torch.sql.engine import STATS

        STATS["ann_filtered_searches"] = (
            STATS.get("ann_filtered_searches", 0) + 1
        )
        b = Batch(len(idx))
        for c in info.columns:
            vals, nulls = info.table.column_batch(c.name, idx)
            b.add(q, c.name,
                  Col(_detoast_col(info.table, c.name, vals), nulls))
        b.add(q, ROWID, Col(info.table.rowids[idx].copy()))
        return b

    def _lock_batch_rows(self, batch: Batch, clause) -> Batch:
        """Lock every result row per a FOR locking clause (reference
        ast.rs ForClause). All lock modes take exclusive row locks
        (single-writer MVCC has no shared locks — conservative superset).
        Policies: 'wait'/'nowait' raise TxnConflict on a held lock (a
        single-process engine cannot block on itself, so WAIT degenerates
        to NOWAIT); 'skip locked' drops conflicting rows instead. OF
        restricts which tables' rows get locked."""
        from turdb_tpu_torch.mvcc.manager import TxnConflict

        skip = clause.policy == "skip locked"
        of = set(clause.tables) if clause.tables else None
        keep = np.ones(batch.n, bool)
        locked_any = False
        for (q, nm), c in zip(batch.names, batch.cols):
            if nm != ROWID or (of is not None and q not in of):
                continue
            # table name unknown at this level; the FOR clause locks via
            # qualifier when it names a real table
            if not any(q in tables for tables in self.catalog.values()):
                continue
            locked_any = True
            for i, r in enumerate(c.values):
                try:
                    self.mgr.lock_row(q, int(r), self._txn)
                except TxnConflict:
                    if not skip:
                        raise
                    keep[i] = False
        if of is not None and not locked_any:
            raise SqlError(
                f"FOR {clause.mode.upper()} OF: no lockable table named "
                f"{', '.join(sorted(of))} in the result"
            )
        if skip and not keep.all():
            return batch.take(np.flatnonzero(keep))
        return batch

    # ------------------------------------------------------------------
    # PRAGMA / EXPLAIN (reference pragma.rs, config.rs)
    # ------------------------------------------------------------------

    def _pragma(self, p: A.Pragma) -> ExecuteResult:
        from turdb_tpu_torch.database.meta import execute_pragma

        return execute_pragma(self, p)

    def _explain(self, e: A.Explain, params):
        from turdb_tpu_torch.database.meta import explain_plan

        lines = explain_plan(self, e.stmt)
        if e.analyze:
            # EXPLAIN ANALYZE: execute and append timing + row count
            import time as _time

            t0 = _time.perf_counter()
            if isinstance(e.stmt, A.Select):
                ctx = self._ctx(params)
                batch = self.engine.run_select(e.stmt, ctx)
                nrows = batch.n
            else:
                res = self._dispatch(e.stmt, params, A.render_expr(e.stmt))
                nrows = res.rows_affected
            ms = (_time.perf_counter() - t0) * 1e3
            lines.append(f"Execution: {nrows} rows in {ms:.2f} ms")
        if getattr(e, "format", "text") == "json":
            # EXPLAIN (FORMAT JSON): nested plan doc, indentation = depth
            import json as _json

            root: list = []
            stack = [(-1, root)]
            for ln in lines:
                depth = (len(ln) - len(ln.lstrip())) // 2
                node = {"node": ln.strip(), "children": []}
                while stack and stack[-1][0] >= depth:
                    stack.pop()
                (stack[-1][1] if stack else root).append(node)
                stack.append((depth, node["children"]))
            return (["plan"], [(_json.dumps(root),)])
        return (["plan"], [(ln,) for ln in lines])

    # ------------------------------------------------------------------
    # index instantiation
    # ------------------------------------------------------------------

    def _instantiate_index(self, info: TableInfo, idef: IndexDef):
        if idef.using == "IVF":
            from turdb_tpu_torch.database.indexes import IvfTableIndex

            colname = idef.columns[0][0].name
            cd = next(c for c in info.columns if c.name == colname)
            metric = Metric.from_name(str(idef.options.get("metric", "l2")))
            nc = idef.options.get("clusters")
            iv = IvfTableIndex(
                idef.name, colname, dim=cd.vector_dim or 0, metric=metric,
                n_clusters=int(nc) if nc else None,
                nprobe=int(idef.options.get("nprobe", 8)),
                sq8=bool(idef.options.get("sq8", False)),
                # rerank omitted -> engine default; WITH (rerank = 0)
                # explicitly selects the probe-only store
                rerank=(int(idef.options["rerank"])
                        if "rerank" in idef.options else None),
                # WITH (compact = true): int8 probe + SQ16 rerank store
                compact=bool(idef.options.get("compact", False)),
                device=self.device,
            )
            info.hnsw[idef.name] = iv
            return
        if idef.using == "HNSW":
            colname = idef.columns[0][0].name
            cd = next(c for c in info.columns if c.name == colname)
            metric = Metric.from_name(str(idef.options.get("metric", "l2")))
            h = HnswTableIndex(
                idef.name, colname, dim=cd.vector_dim or 0, metric=metric,
                m=int(idef.options.get("m", 16)),
                ef_construction=int(idef.options.get("ef_construction", 100)),
                ef_search=int(idef.options.get("ef_search", 64)),
                sq8=bool(idef.options.get("sq8", False))
                or bool(idef.options.get("sq16", False)),
                qbits=16 if idef.options.get("sq16") else 8,
                device=self.device,
            )
            info.hnsw[idef.name] = h
        else:
            import turdb_tpu_torch.sql.ast as A

            if all(isinstance(c, A.ColumnRef) for c, _ in idef.columns):
                cols = [c.name for c, _ in idef.columns]
                info.btree_cols[idef.name] = cols
            else:
                # expression index (reference ddl.rs expression indexes)
                cols = [A.render_expr(c) for c, _ in idef.columns]
                info.btree_cols[idef.name] = None
                info.btree_exprs[idef.name] = [c for c, _ in idef.columns]
            if idef.where_text:
                info.btree_where[idef.name] = _parse_expr(idef.where_text)
            info.btree[idef.name] = SortedKeyIndex(idef.name, cols, idef.unique)


class CachedInsertPlan:
    """Pre-resolved INSERT plan (reference prepared.rs:106-158
    CachedInsertPlan): the table info, target column order, and per-cell
    binders (literal constant or parameter index) resolve ONCE at prepare
    time; execute() skips parsing, name resolution, and expression
    dispatch. Rebuilds itself when DDL replaces the TableInfo."""

    def __init__(self, db: Database, stmt: A.Insert):
        self.db = db
        self.stmt = stmt
        self.schema = stmt.table.schema or "main"
        self.tname = stmt.table.name
        self._bind()
        self._fast = self._build_fast()

    def _bind(self):
        db, stmt = self.db, self.stmt
        self.info = db.resolve_table(stmt.table)
        colnames = [c.name for c in self.info.columns]
        target = stmt.columns if stmt.columns is not None else colnames
        for cn in target:
            if cn not in colnames:
                raise SqlError(f"no such column: {cn}")
        binders = []
        for vrow in stmt.values:
            if len(vrow) != len(target):
                raise SqlError(
                    f"INSERT has {len(vrow)} values for {len(target)} columns"
                )
            row = []
            for cn, e in zip(target, vrow):
                if isinstance(e, A.Literal):
                    row.append((cn, False, e.value))
                elif isinstance(e, A.Param):
                    row.append((cn, True, e.index - 1))
                else:
                    raise _NotCacheable()
            binders.append(row)
        self.binders = binders

    @classmethod
    def try_build(cls, db: Database, stmt) -> "CachedInsertPlan | None":
        if not (
            isinstance(stmt, A.Insert)
            and stmt.values is not None
            and stmt.on_conflict is None
            and not stmt.returning
        ):
            return None
        try:
            return cls(db, stmt)
        except (_NotCacheable, SqlError):
            return None

    def _build_fast(self):
        """Precompute the single-row FAST LANE (reference prepared.rs
        insert_cached at 1,185 ns/row is the bar): one Python function
        per insert, all byte work (key encode, record pack, WAL frames)
        in C (native/oltp.c). Eligible when the row shape is simple —
        plain typed columns, plain-column indexes, no FKs/CHECKs/vector
        indexes/defaults; anything unusual bails to the generic path at
        runtime (returning None), so semantics are identical."""
        from turdb_tpu_torch.native.build import oltp

        info = self.info
        nat = oltp()
        if nat is None or len(self.binders) != 1:
            return None
        if info.fks or info.checks or info.hnsw or info.btree_exprs:
            return None
        if len(info.columns) > 64:
            return None   # store_row's stack scratch is 64 columns
        if info.table.toast_cols or info.temporary:
            # temp tables must not reach the C WAL-frame fast lane
            return None
        ok_sc = (
            StorageClass.INT, StorageClass.FLOAT, StorageClass.FLOAT32,
            StorageClass.BOOL, StorageClass.TEXT, StorageClass.BYTES,
        )
        for cd in info.columns:
            if cd.check is not None or cd.has_default:
                return None
            if cd.dtype.storage_class not in ok_sc:
                return None
            if cd.dtype in (
                DataType.INT4RANGE, DataType.INT8RANGE, DataType.DATERANGE,
                DataType.TSRANGE, DataType.BOX, DataType.CIRCLE,
                DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
                DataType.TIMESTAMPTZ,
            ):
                return None   # text-stored types with coercion semantics
        binder = {cn: (isp, pay) for cn, isp, pay in self.binders[0]}
        for cd in info.columns:
            if cd.auto_increment and binder.get(cd.name) is not None:
                # explicit values must advance the counter (and NULL means
                # auto-fill) — generic-path semantics, not worth inlining
                return None
        cols = []
        for cd in info.columns:
            cols.append((cd, binder.get(cd.name),
                         cd.dtype.storage_class, cd.name))
        name_pos = {cd.name: j for j, cd in enumerate(info.columns)}
        sec = []
        uniq = []
        if info.btree_where:
            # partial indexes need per-row predicate evaluation — the
            # generic path handles them
            return None
        for name, idx in info.btree.items():
            cl = info.btree_cols[name]
            if cl is None:
                return None
            pos = tuple(name_pos[c] for c in cl)
            sec.append((idx, pos))
            if idx.unique:
                uniq.append((idx, pos))
        from turdb_tpu_torch.config import TOAST_THRESHOLD

        F = {
            "nat": nat, "cols": cols, "sec": sec, "uniq": uniq,
            "blob": info.record_schema().schema_blob(),
            "toast": TOAST_THRESHOLD,
        }
        try:
            F["fn"] = self._compile_fast(F)
        except Exception:
            F["fn"] = None        # interpreted _fast_row still applies
        if hasattr(nat, "exec_insert"):
            try:
                cfn = self._compile_fast_c(F)
                if cfn is not None:
                    F["fn"] = cfn
                    # the C lane runs the mode/txn/trigger/catalog guards
                    # itself: execute() may call it without pre-checks
                    F["self_check"] = True
            except Exception:
                pass              # generated-Python lane still applies
        return F

    def _compile_fast_c(self, F):
        """Bind the whole single-row insert to ONE C call per row
        (native/oltp.c exec_insert): value binding, key encode, unique
        probe, column+MVCC writes, index delta maintenance, WAL frame
        pair, and commit all run inside the extension, driving the same
        Python-visible structures through the C API. The reference's
        insert_cached (prepared.rs:106-158) costs 1,185 ns/row in Rust;
        the generated-Python lane still spent ~70% of its time in
        bytecode dispatch around the C helpers — this removes it."""
        info = self.info
        t = info.table
        nat = F["nat"]
        db = self.db
        mgr = db.mgr
        names = [cd.name for cd, _, _, _ in F["cols"]]
        sc_code = {
            StorageClass.INT: 0, StorageClass.FLOAT: 1,
            StorageClass.FLOAT32: 2, StorageClass.BOOL: 3,
            StorageClass.TEXT: 4, StorageClass.BYTES: 5,
        }
        spec = []
        binds = []
        n_auto = 0
        for cd, src, sc, name in F["cols"]:
            if sc not in sc_code:
                return None
            if sc is StorageClass.TEXT:
                lim = F["toast"] // 4
                if cd.max_len is not None:
                    lim = min(lim, cd.max_len)
            elif sc is StorageClass.BYTES:
                lim = F["toast"] // 4
            else:
                lim = -1
            spec.append((sc_code[sc], bool(cd.nullable), lim))
            if src is None:
                if cd.auto_increment:
                    binds.append((2, n_auto, None))
                    n_auto += 1
                else:
                    binds.append((3, 0, None))
            elif src[0]:
                binds.append((1, src[1], None))
            else:
                binds.append((0, 0, src[1]))
        sec_spec = tuple(
            (idx, tuple(pos), int(idx.unique)) for idx, pos in F["sec"]
        )
        from turdb_tpu_torch.config import WAL_CHECKPOINT_FRAMES
        from turdb_tpu_torch.storage.wal import FrameType

        rs = info.record_schema()

        def pack_fb(vals):
            return pack_record(rs, list(vals))

        nn_prefix = f"NOT NULL constraint violated: {t.name}."
        box: list = [None, None]

        def _make():
            refs = [t.cols[n] for n in names]
            nrefs = [t.nulls[n] for n in names]
            cspec = tuple(
                (code, c.ctypes.data, nl.ctypes.data, int(nullable), lim)
                for (code, nullable, lim), c, nl in zip(spec, refs, nrefs)
            )
            desc = nat.make_row_desc(
                cspec, t.xmin.ctypes.data, t.xmax.ctypes.data,
                t.rowids.ctypes.data, t.prev.ctypes.data,
            )
            ct = mgr._commit_ts
            ctx = nat.make_insert_ctx((
                desc, t, mgr, db, t.cols, names[0], ct,
                ct.ctypes.data, len(ct), None, tuple(binds), F["blob"],
                pack_fb, sec_spec, t.table_id, WAL_CHECKPOINT_FRAMES,
                ConstraintViolation, nn_prefix, tuple(names), n_auto,
                int(FrameType.INSERT), int(FrameType.COMMIT),
                info, self.schema, self.tname,
            ))
            # the ctx capsule holds RAW pointers: keep the arrays alive
            box[1] = refs + nrefs + [t.xmin, t.xmax, t.rowids, t.prev, ct]
            return ctx

        box[0] = _make()
        F["box"] = box   # shared with exec_insert_stmt (same live ctx)
        EXEC = nat.exec_insert
        ER = ExecuteResult

        def _fi(params):
            r = EXEC(box[0], params)
            for _ in range(3):
                if type(r) is not int:
                    return None          # bail to the generic path
                if r >= 0:
                    return ER(rows_affected=1, last_rowid=r)
                if r == -1:
                    t._ensure(t.nversions + 1)
                elif r == -2:
                    mgr._ensure(mgr._next_txn)
                box[0] = _make()         # -3 (or after growth): re-pin
                r = EXEC(box[0], params)
            return None
        return _fi

    def _compile_fast(self, F):
        """Generate a per-statement specialized insert function (the
        reference's own trick: prepared.rs insert_cached specializes the
        row path per statement at 1,185 ns/row). The generated source
        unrolls the column loop — no per-column tuple unpacking, dict
        lookups, or storage-class dispatch at call time. Falls back to
        the interpreted _fast_row when generation fails; bail semantics
        (return None -> generic path) are identical."""
        info = self.info
        t = info.table
        nat = F["nat"]
        if not hasattr(nat, "store_row"):
            raise _NotCacheable()   # stale cached .so: interpreted lane
        consts: list = []
        L: list[str] = []
        names = [cd.name for cd, _, _, _ in F["cols"]]
        n_auto = 0
        emit = L.append
        # per-column (sc_code, nullable, len_cap) for the C row descriptor;
        # type/null validation and the column+MVCC stamp writes all happen
        # inside ONE store_row call (oltp.c) — the python version of this
        # lane spent ~1/3 of its time in numpy scalar __setitem__ dispatch
        sc_code = {
            StorageClass.INT: 0, StorageClass.FLOAT: 1,
            StorageClass.FLOAT32: 2, StorageClass.BOOL: 3,
            StorageClass.TEXT: 4, StorageClass.BYTES: 5,
        }
        spec = []
        for i, (cd, src, sc, name) in enumerate(F["cols"]):
            if sc not in sc_code:
                raise _NotCacheable()
            if sc is StorageClass.TEXT:
                lim = F["toast"] // 4
                if cd.max_len is not None:
                    lim = min(lim, cd.max_len)
            elif sc is StorageClass.BYTES:
                lim = F["toast"] // 4
            else:
                lim = -1
            spec.append((sc_code[sc], bool(cd.nullable), lim))
            if src is None:
                if cd.auto_increment:
                    emit(f"    v{i} = t.auto_increment + {n_auto}")
                    n_auto += 1
                    continue
                emit(f"    v{i} = None")
            elif src[0]:
                emit(f"    v{i} = params[{src[1]}]")
            else:
                consts.append(src[1])
                emit(f"    v{i} = CONSTS[{len(consts) - 1}]")
        # index keys + unique probes (shared bytes for probe and insert).
        # A TypeError here (unencodable param, e.g. Decimal) means the
        # generic path must handle the row — bail, don't propagate.
        emit("    try:")
        for j, (idx, pos) in enumerate(F["sec"]):
            kv = ", ".join(f"v{p}" for p in pos)
            emit(f"        k{j} = encode_key(({kv},))")
        if not F["sec"]:
            emit("        pass")
        emit("    except TypeError:")
        emit("        return None")
        for j, (idx, pos) in enumerate(F["sec"]):
            if idx.unique:
                notnull = " and ".join(f"v{p} is not None" for p in pos)
                emit(f"    if ({notnull}) and SEC[{j}].probe_hit(k{j}):")
                emit("        return None")
        vals_t = ", ".join(f"v{i}" for i in range(len(names)))
        emit("    vi = t.nversions")
        emit("    if vi + 1 > t.capacity:")
        emit("        t._ensure(vi + 1)")
        emit("    D = F.get('rd')")
        emit(f"    if D is None or F['rd_ref'][0] is not t.cols[{names[0]!r}]:")
        emit("        D = _mkdesc()")
        # single-statement autocommit: no Transaction object / undo list.
        # store_row validates BEFORE writing, so rc != 0 leaves no trace;
        # a failure after the row lands (index/WAL) aborts the stamp,
        # leaving the version invisible forever (vacuum reclaims the slot)
        # and any index entries pointing at it re-verified by probes.
        emit("    tid = mgr.autocommit_begin()")
        emit("    rid = t.next_rowid")
        emit(f"    rc = store_row(D, vi, rid, tid, ({vals_t},))")
        emit("    if rc != 0:")
        emit("        mgr.autocommit_abort(tid)")
        emit("        if rc < 0:")
        emit(f"            raise cv('NOT NULL constraint violated: "
             f"{t.name}.' + NAMES[-rc - 1])")
        emit("        return None")
        emit("    t.next_rowid = rid + 1")
        if n_auto:
            emit(f"    db.last_insert_id = t.auto_increment + {n_auto - 1}")
            emit(f"    t.auto_increment += {n_auto}")
        emit("    t.latest[rid] = vi")
        emit("    t.nversions = vi + 1")
        emit("    try:")
        for j in range(len(F["sec"])):
            emit(f"        SEC[{j}].insert(k{j}, rid)")
        emit("        if db.wal_enabled and not db._replaying:")
        emit(f"            rec = nat.pack_record(blob, ({vals_t},))")
        emit("            if rec is None:")
        emit(f"                rec = pack_record(info.record_schema(), "
             f"[{vals_t}])")
        emit("            w = db.wal")
        emit("            lsn = w.next_lsn")
        emit("            w._buffer.append(wal_frame_pair(")
        emit("                FT_I, t.table_id, lsn, tid,")
        emit("                rid.to_bytes(8, 'little') + rec, FT_C,")
        emit("            ))")
        emit("            w.next_lsn = lsn + 2")
        emit("            w.frame_count += 2")
        emit("            if db.wal_autoflush:")
        emit("                w.flush()")
        emit("    except Exception:")
        emit("        mgr.autocommit_abort(tid)")
        emit("        raise")
        emit("    mgr.autocommit_commit(tid)")
        emit("    if db.wal_enabled and db.wal.frame_count >= CKPT:")
        emit("        db.checkpoint()")
        emit("    return ER(rows_affected=1, last_rowid=rid)")
        from turdb_tpu_torch.config import WAL_CHECKPOINT_FRAMES

        def _mkdesc():
            refs = [t.cols[n] for n in names]
            nrefs = [t.nulls[n] for n in names]
            cspec = tuple(
                (code, c.ctypes.data, nl.ctypes.data, int(nullable), lim)
                for (code, nullable, lim), c, nl in zip(spec, refs, nrefs)
            )
            D = nat.make_row_desc(
                cspec, t.xmin.ctypes.data, t.xmax.ctypes.data,
                t.rowids.ctypes.data, t.prev.ctypes.data,
            )
            # the capsule holds RAW pointers: keep the arrays alive and
            # use refs[0] identity to invalidate after growth/vacuum
            F["rd"] = D
            F["rd_ref"] = refs + nrefs + [t.xmin, t.xmax, t.rowids, t.prev]
            return D

        src = "def _fi(params):\n" + "\n".join(L) + "\n"
        ns = {
            "t": t, "db": self.db, "info": info, "F": F,
            "mgr": self.db.mgr, "cv": ConstraintViolation,
            "ER": ExecuteResult, "nat": nat,
            "encode_key": nat.encode_key, "blob": F["blob"],
            "store_row": nat.store_row, "_mkdesc": _mkdesc,
            "wal_frame_pair": nat.wal_frame_pair,
            "pack_record": pack_record,
            "SEC": [idx for idx, _ in F["sec"]],
            "NAMES": names, "CONSTS": consts,
            "FT_I": int(FrameType.INSERT), "FT_C": int(FrameType.COMMIT),
            "CKPT": WAL_CHECKPOINT_FRAMES,
        }
        exec(compile(src, "<fast-insert>", "exec"), ns)
        return ns["_fi"]

    def _fast_row(self, params) -> ExecuteResult | None:
        """One prepared single-row autocommit insert; None = bail to the
        generic path (which re-validates from scratch)."""
        F = self._fast
        nat = F["nat"]
        db = self.db
        info = self.info
        t = info.table
        if t.name in db._trigger_tables:
            return None   # triggers fire on the generic path only
        cv = ConstraintViolation
        vals = []
        auto_bump = 0
        for cd, src, sc, name in F["cols"]:
            if src is None:
                if cd.auto_increment:
                    v = t.auto_increment + auto_bump
                    auto_bump += 1
                else:
                    v = None
            else:
                v = params[src[1]] if src[0] else src[1]
            if v is None:
                if not cd.nullable:
                    raise cv(
                        f"NOT NULL constraint violated: {t.name}.{name}"
                    )
            elif sc is StorageClass.INT:
                if type(v) is not int:
                    return None
            elif sc is StorageClass.FLOAT or sc is StorageClass.FLOAT32:
                if type(v) is int:
                    v = float(v)
                elif type(v) is not float:
                    return None
            elif sc is StorageClass.TEXT:
                if type(v) is not str:
                    return None
                if cd.max_len is not None and len(v) > cd.max_len:
                    return None   # generic path raises the proper error
                if len(v) > F["toast"] // 4:
                    return None   # may need TOASTing (utf-8 <= 4 B/char)
            elif sc is StorageClass.BYTES:
                if type(v) is not bytes or len(v) > F["toast"] // 4:
                    return None
            elif sc is StorageClass.BOOL:
                if type(v) is not bool:
                    return None
            vals.append(v)
        # index keys once per index (the unique probe and the insert
        # share the bytes); empty probe hit = no conflict; any hit bails
        # (the generic path re-verifies against MVCC visibility)
        keys = []
        for idx, pos in F["sec"]:
            kv = tuple(vals[p] for p in pos)
            key = nat.encode_key(kv)
            keys.append(key)
            if idx.unique and None not in kv and idx.probe_hit(key):
                return None
        mgr = db.mgr
        txn = mgr.begin()
        try:
            vi = t.nversions
            if vi + 1 > t.capacity:
                t._ensure(vi + 1)
            rid = t.next_rowid
            t.next_rowid = rid + 1
            if auto_bump:
                db.last_insert_id = t.auto_increment + auto_bump - 1
                t.auto_increment += auto_bump
            cols_d, nulls_d = t.cols, t.nulls
            for j, (cd, src, sc, name) in enumerate(F["cols"]):
                v = vals[j]
                if v is None:
                    nulls_d[name][vi] = True
                else:
                    nulls_d[name][vi] = False
                    cols_d[name][vi] = v
            t.xmin[vi] = txn.txn_id
            t.xmax[vi] = 0
            t.rowids[vi] = rid
            t.prev[vi] = -1
            t.latest[rid] = vi
            txn.undo.append((t, "insert", vi, None))
            t.nversions = vi + 1
            for (idx, _), key in zip(F["sec"], keys):
                idx.insert(key, rid)
            if db.wal_enabled and not db._replaying:
                rec = nat.pack_record(F["blob"], tuple(vals))
                if rec is None:
                    rec = pack_record(info.record_schema(), vals)
                w = db.wal
                lsn = w.next_lsn
                w._buffer.append(nat.wal_frame(
                    int(FrameType.INSERT), t.table_id, lsn, txn.txn_id,
                    rid.to_bytes(8, "little") + rec,
                ))
                w._buffer.append(nat.wal_frame(
                    int(FrameType.COMMIT), 0, lsn + 1, txn.txn_id, b"",
                ))
                w.next_lsn = lsn + 2
                w.frame_count += 2
                if db.wal_autoflush:
                    w.flush()
            mgr.commit(txn)
        except Exception:
            mgr.abort(txn)
            raise
        from turdb_tpu_torch.config import WAL_CHECKPOINT_FRAMES

        if db.wal_enabled and db.wal.frame_count >= WAL_CHECKPOINT_FRAMES:
            db.checkpoint()
        return ExecuteResult(rows_affected=1, last_rowid=rid)

    def execute(self, params) -> ExecuteResult:
        db = self.db
        F = self._fast
        if F is not None and F.get("self_check"):
            # C lane: guards run inside exec_insert; a None covers every
            # bail INCLUDING catalog staleness, re-checked below
            res = F["fn"](params)
            if res is not None:
                return res
        if db.mode != "rw":
            db._check_writable()
        live = db.catalog.get(self.schema, {}).get(self.tname)
        if live is not self.info:     # DDL since prepare: re-resolve
            self._bind()
            self._fast = self._build_fast()
        if self._fast is not None and db._txn is None and db.mode == "rw" \
                and self.tname not in db._trigger_tables:
            fn = self._fast.get("fn")
            res = fn(params) if fn is not None else self._fast_row(params)
            if res is not None:
                return res
        from turdb_tpu_torch.database import dml

        txn, own = db._begin_write()
        try:
            res = dml.insert_plan_rows(db, self.info, self.binders, params, txn)
            if own:
                db._commit(txn)
            return res
        except Exception:
            if own:
                db.mgr.abort(txn)
            raise


class _NotCacheable(Exception):
    pass


_FAST_DML_SC = (
    StorageClass.INT, StorageClass.FLOAT, StorageClass.FLOAT32,
    StorageClass.BOOL, StorageClass.TEXT, StorageClass.BYTES,
)
_FAST_DML_BAD_DTYPES = (
    DataType.INT4RANGE, DataType.INT8RANGE, DataType.DATERANGE,
    DataType.TSRANGE, DataType.BOX, DataType.CIRCLE,
    DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
    DataType.TIMESTAMPTZ,
)


def _eq_binders(where):
    """WHERE as a conjunction of `col = literal|param` -> {col: binder},
    or None when any other shape appears (the point-select rule)."""
    eqs = {}

    def walk(e):
        if isinstance(e, A.BinaryOp) and e.op == "AND":
            return walk(e.left) and walk(e.right)
        if isinstance(e, A.BinaryOp) and e.op == "=":
            a, b = e.left, e.right
            if not isinstance(a, A.ColumnRef):
                a, b = b, a
            if isinstance(a, A.ColumnRef) and isinstance(
                b, (A.Literal, A.Param)
            ):
                eqs[a.name] = b
                return True
        return False

    return eqs if where is not None and walk(where) else None


class _CachedDmlPlan:
    """Shared machinery of the prepared single-row UPDATE/DELETE fast
    lanes (VERDICT r4 item #3: the reference ships dedicated update/
    delete benches, tests/update_benchmark.rs / delete_benchmark.rs,
    while the repo's generic path ran them ~100x slower than inserts).

    Shape: `UPDATE t SET c = $k|lit, ... WHERE <unique-key eq>` /
    `DELETE FROM t WHERE <unique-key eq>` — the WHERE must be an
    equality conjunction exactly covering one plain-column unique
    index. Execution is then: O(1) index probe -> MVCC visibility walk
    + key re-verification (index entries persist until vacuum) -> stamp
    writes + WAL frame pair, skipping parse/plan/scan entirely.
    Anything unusual bails (returns None) to the generic path, which
    re-validates from scratch — semantics are identical by
    construction. tests/test_weakfixes.py::TestFastDmlLanes pins the
    bail + equivalence behavior."""

    def __init__(self, db: Database, stmt, sql: str):
        self.db = db
        self.stmt = stmt
        self.sql = sql
        self.schema = stmt.table.schema or "main"
        self.tname = stmt.table.name
        self._dead = False
        self._bind()

    # -- bind-time eligibility --------------------------------------------

    def _bind(self):
        from turdb_tpu_torch.native.build import oltp

        db, stmt = self.db, self.stmt
        self._epoch = db.ddl_epoch
        info = db.resolve_table(stmt.table)
        self.info = info
        nat = oltp()
        if nat is None:
            raise _NotCacheable()
        t = info.table
        if (info.fks or info.checks or info.hnsw or info.btree_exprs
                or info.btree_where or t.toast_cols or info.temporary):
            raise _NotCacheable()
        for cd in info.columns:
            if cd.dtype.storage_class not in _FAST_DML_SC:
                raise _NotCacheable()
            if cd.dtype in _FAST_DML_BAD_DTYPES:
                raise _NotCacheable()
        # a child table's FK referencing THIS table forces the generic
        # path (RESTRICT/CASCADE walks); re-checked via db.ddl_epoch
        for tables in db.catalog.values():
            for child in tables.values():
                for _cols, ref_table, *_rest in child.fks:
                    if ref_table == self.tname:
                        raise _NotCacheable()
        eqs = _eq_binders(stmt.where)
        if not eqs:
            raise _NotCacheable()
        probe = None
        for name, idx in info.btree.items():
            cl = info.btree_cols[name]
            if idx.unique and cl is not None and set(cl) == set(eqs):
                probe = (idx, cl)
                break
        if probe is None:
            raise _NotCacheable()
        self.probe_idx, self.keycols = probe
        self.key_binders = []
        for c in self.keycols:
            b = eqs[c]
            if isinstance(b, A.Param):
                self.key_binders.append((True, b.index - 1))
            else:
                self.key_binders.append((False, b.value))
        name_pos = {cd.name: j for j, cd in enumerate(info.columns)}
        self.sec = [
            (idx, tuple(name_pos[c] for c in info.btree_cols[name]))
            for name, idx in info.btree.items()
        ]
        self.uniq = [(idx, pos) for (idx, pos) in self.sec if idx.unique]
        self.nat = nat
        self.blob = info.record_schema().schema_blob()
        from turdb_tpu_torch.config import TOAST_THRESHOLD

        self.toast_lim = TOAST_THRESHOLD // 4
        self._bind_extra(name_pos)
        self._build_cctx(name_pos)

    def _bind_extra(self, name_pos):
        pass

    # -- consolidated C lane (native/oltp.c exec_dml) ---------------------

    def _build_cctx(self, name_pos):
        """Bind the whole single-row UPDATE/DELETE to ONE C call
        (native/oltp.c exec_dml), mirroring CachedInsertPlan's
        _compile_fast_c: probe, MVCC walk, stamp/version writes, index
        delta maintenance, WAL frame pair, and autocommit all inside
        the extension. self._cbox stays None when the extension lacks
        exec_dml — the interpreted _fast lane still applies."""
        self._cbox = None
        nat = self.nat
        if not hasattr(nat, "exec_dml") or len(self.info.columns) > 64:
            return
        info = self.info
        t = info.table
        db = self.db
        mgr = db.mgr
        sc_code = {
            StorageClass.INT: 0, StorageClass.FLOAT: 1,
            StorageClass.FLOAT32: 2, StorageClass.BOOL: 3,
            StorageClass.TEXT: 4, StorageClass.BYTES: 5,
        }
        names = [cd.name for cd in info.columns]
        spec = []
        for cd in info.columns:
            sc = cd.dtype.storage_class
            if sc not in sc_code:
                return
            if sc is StorageClass.TEXT:
                lim = self.toast_lim
                if cd.max_len is not None:
                    lim = min(lim, cd.max_len)
            elif sc is StorageClass.BYTES:
                lim = self.toast_lim
            else:
                lim = -1
            spec.append((sc_code[sc], bool(cd.nullable), lim))
        is_delete = isinstance(self.stmt, A.Delete)
        key_pos = tuple(name_pos[c] for c in self.keycols)
        key_binds = tuple(
            (1, pay, None) if isp else (0, 0, pay)
            for isp, pay in self.key_binders
        )
        if is_delete:
            set_pos, set_binds = (), ()
            set_set = frozenset()
        else:
            set_pos = tuple(j for j, *_r in self.set_specs)
            set_binds = tuple(
                (1, payload, None) if is_param else (0, 0, payload)
                for _j, is_param, payload, *_rest in self.set_specs
            )
            set_set = frozenset(set_pos)
        sec_spec = tuple(
            (idx, tuple(pos), int(idx.unique),
             int(any(p in set_set for p in pos)))
            for idx, pos in self.sec
        )
        from turdb_tpu_torch.config import WAL_CHECKPOINT_FRAMES
        from turdb_tpu_torch.storage.wal import FrameType

        rs = info.record_schema()

        def pack_fb(vals):
            return pack_record(rs, list(vals))

        nn_prefix = f"NOT NULL constraint violated: {t.name}."
        box: list = [None, None]

        def _make():
            refs = [t.cols[n] for n in names]
            nrefs = [t.nulls[n] for n in names]
            cspec = tuple(
                (code, c.ctypes.data, nl.ctypes.data, int(nullable), lim)
                for (code, nullable, lim), c, nl in zip(spec, refs, nrefs)
            )
            desc = nat.make_row_desc(
                cspec, t.xmin.ctypes.data, t.xmax.ctypes.data,
                t.rowids.ctypes.data, t.prev.ctypes.data,
            )
            ct = mgr._commit_ts
            ctx = nat.make_dml_ctx((
                desc, t, mgr, db, t.cols, names[0], ct,
                ct.ctypes.data, len(ct), self.blob, pack_fb, sec_spec,
                t.table_id, WAL_CHECKPOINT_FRAMES, ConstraintViolation,
                nn_prefix, tuple(names),
                int(FrameType.DELETE if is_delete else FrameType.UPDATE),
                int(FrameType.COMMIT), info, self.schema, self.tname,
                self.probe_idx, key_pos, key_binds, set_pos, set_binds,
                int(is_delete), db.ddl_epoch,
            ))
            # the ctx capsule holds RAW pointers: keep the arrays alive
            box[1] = refs + nrefs + [t.xmin, t.xmax, t.rowids, t.prev, ct]
            return ctx

        box[0] = _make()
        self._cmake = _make
        self._cbox = box

    def _c_exec(self, params):
        """C-lane dispatch with the insert lane's maintenance protocol:
        -1 grow table, -2 grow commit log, -3 rebuild ctx; None bails to
        the caller (which falls through to the interpreted lane)."""
        box = self._cbox
        EXEC = self.nat.exec_dml
        r = EXEC(box[0], params)
        for _ in range(3):
            if type(r) is not int:
                return None
            if r >= 0:
                return ExecuteResult(rows_affected=r)
            if r == -1:
                t = self.info.table
                t._ensure(t.nversions + 1)
                box[0] = self._cmake()
            elif r == -2:
                mgr = self.db.mgr
                mgr._ensure(mgr._next_txn)
                box[0] = self._cmake()
            else:   # -3: DDL / array growth elsewhere — full rebind
                try:
                    self._bind()
                except (_NotCacheable, SqlError):
                    self._dead = True
                    return None
                if self._cbox is None:
                    return None
                box = self._cbox
            r = EXEC(box[0], params)
        return None

    # -- execute-time shared steps ----------------------------------------

    def _guard(self):
        """None = proceed on the fast lane; False = bail to generic."""
        db = self.db
        if (db.mode != "rw" or db._txn is not None or db._replaying
                or self.tname in db._trigger_tables or self._dead):
            return False
        if db.ddl_epoch != self._epoch or db.catalog.get(
            self.schema, {}
        ).get(self.tname) is not self.info:
            try:
                self._bind()
            except (_NotCacheable, SqlError):
                self._dead = True
                return False
        return None

    def _probe_visible(self, params):
        """Key encode + unique probe + MVCC visibility/key verification.
        Returns (rid, vi) for the single visible match, 0 for no match,
        or None to bail (multi-match / version-chain edge / unencodable
        key — the generic path re-derives everything)."""
        vals = []
        for is_param, payload in self.key_binders:
            v = params[payload] if is_param else payload
            if v is None:
                return 0           # key = NULL matches nothing
            vals.append(v)
        try:
            key = self.nat.encode_key(tuple(vals))
        except TypeError:
            return None
        rids = self.probe_idx.find(key)
        if not rids:
            return 0
        db = self.db
        t = self.info.table
        read_ts = db.mgr.snapshot_ts()
        hit = None
        for rid in rids:
            vi = t.visible_version(db.mgr, rid, read_ts, 0)
            if vi is None:
                continue
            ok = True
            for c, want in zip(self.keycols, vals):
                if t.nulls[c][vi] or t.cols[c][vi] != want:
                    ok = False
                    break
            if not ok:
                continue
            if hit is not None and hit[0] != rid:
                return None        # two visible matches under a unique
            # base the write on `latest` like the generic path; if the
            # visible version is not the newest (a concurrent txn's
            # uncommitted append), the generic path's lock/conflict
            # semantics must decide — bail
            if t.latest.get(rid) != vi:
                return None
            hit = (rid, vi)
        return hit if hit is not None else 0

    def _wal_pair(self, ftype, payload, tid):
        db = self.db
        w = db.wal
        from turdb_tpu_torch.storage.wal import FrameType

        lsn = w.next_lsn
        nat = self.nat
        w._buffer.append(nat.wal_frame(
            int(ftype), self.info.table.table_id, lsn, tid, payload,
        ))
        w._buffer.append(nat.wal_frame(
            int(FrameType.COMMIT), 0, lsn + 1, tid, b"",
        ))
        w.next_lsn = lsn + 2
        w.frame_count += 2
        if db.wal_autoflush:
            w.flush()

    def execute(self, params) -> ExecuteResult:
        res = None
        if self._cbox is not None and not self._dead:
            res = self._c_exec(params)
        if res is None and self._guard() is None:
            res = self._fast(params)
        if res is None:
            res = self.db._dispatch(self.stmt, params, self.sql)
        return res


class CachedUpdatePlan(_CachedDmlPlan):
    """Prepared single-row UPDATE fast lane. MVCC update = stamp the old
    version's xmax + append a new version (storage/table.py update_row),
    inlined here without per-column _coerce/row_as_dict overhead; index
    entries for the NEW row values append to every index (entries are
    never removed at DML time — probes re-verify, dml._index_delete),
    and the WAL carries an UPDATE frame + COMMIT frame, byte-identical
    to the generic path's (_log_update)."""

    @classmethod
    def try_build(cls, db, stmt, sql):
        if not (isinstance(stmt, A.Update) and stmt.from_ is None
                and not stmt.returning and stmt.where is not None):
            return None
        try:
            return cls(db, stmt, sql)
        except (_NotCacheable, SqlError):
            return None

    def _bind_extra(self, name_pos):
        sets = []
        for cn, e in self.stmt.assignments:
            if cn not in name_pos:
                raise SqlError(f"no such column: {cn}")
            if isinstance(e, A.Literal):
                sets.append((name_pos[cn], False, e.value))
            elif isinstance(e, A.Param):
                sets.append((name_pos[cn], True, e.index - 1))
            else:
                raise _NotCacheable()
        # split the columns once at bind: SET targets carry their type
        # gate, the rest carry a numpy->python converter for the
        # old-value copy (the interpreted per-execute loop over a merged
        # colspec was ~1/3 of the lane's cost)
        cols = self.info.columns
        self.ncols = len(cols)
        self.col_names = [cd.name for cd in cols]
        set_pos = {j for j, _ip, _pl in sets}
        # indexes untouched by any SET column keep their existing
        # entries (probes re-verify at the table, and skipping same-key
        # re-inserts preserves the clean-single point-read map)
        self.sec_changed = [
            any(p in set_pos for p in pos) for _idx, pos in self.sec
        ]
        if len(set_pos) != len(sets):
            raise _NotCacheable()    # duplicate SET target: generic path
        self.set_specs = []
        for j, is_param, payload in sets:
            cd = cols[j]
            self.set_specs.append((
                j, is_param, payload, cd.dtype.storage_class,
                cd.nullable, cd.max_len, cd.name,
            ))
        self.copy_specs = []
        self.all_conv = [None] * len(cols)
        for j, cd in enumerate(cols):
            sc = cd.dtype.storage_class
            if sc is StorageClass.INT:
                conv = int
            elif sc in (StorageClass.FLOAT, StorageClass.FLOAT32):
                conv = float
            elif sc is StorageClass.BOOL:
                conv = bool
            else:
                conv = None          # object arrays hold str/bytes
            self.all_conv[j] = conv
            if j not in set_pos:
                self.copy_specs.append((j, cd.name, conv))

    def _fast(self, params):
        db = self.db
        info = self.info
        t = info.table
        hit = self._probe_visible(params)
        if hit is None:
            return None
        if hit == 0:
            return ExecuteResult(rows_affected=0)
        rid, vi = hit
        # materialize the full NEW row: old values (typed-array reads)
        # overlaid with the SET values, type-gated like the insert lane
        new_vals = [None] * self.ncols
        cols_d, nulls_d = t.cols, t.nulls
        SC = StorageClass
        for j, name, conv in self.copy_specs:
            if not nulls_d[name][vi]:
                v = cols_d[name][vi]
                new_vals[j] = conv(v) if conv is not None else v
        for j, is_param, payload, sc, nullable, max_len, _nm in \
                self.set_specs:
            v = params[payload] if is_param else payload
            if v is None:
                if not nullable:
                    return None      # generic path raises the real error
            elif sc is SC.INT:
                if type(v) is not int:
                    return None
            elif sc is SC.FLOAT or sc is SC.FLOAT32:
                if type(v) is int:
                    v = float(v)
                elif type(v) is not float:
                    return None
            elif sc is SC.TEXT:
                if type(v) is not str or len(v) > self.toast_lim:
                    return None
                if max_len is not None and len(v) > max_len:
                    return None
            elif sc is SC.BYTES:
                if type(v) is not bytes or len(v) > self.toast_lim:
                    return None
            elif sc is SC.BOOL:
                if type(v) is not bool:
                    return None
            new_vals[j] = v
        nat = self.nat
        # keys only for indexes a SET column touches; unchanged keys
        # keep their existing entries (probes re-verify at the table,
        # and skipping same-key re-inserts preserves the clean-single
        # point-read map). Unique probes run against the NEW key bytes;
        # any foreign hit bails (the generic path re-verifies under
        # MVCC and raises properly).
        keys = []   # (idx, key) for entries to add
        try:
            for (idx, pos), changed in zip(self.sec, self.sec_changed):
                if not changed:
                    continue
                key = nat.encode_key(tuple(new_vals[p] for p in pos))
                old_vals = []
                for p in pos:
                    nm = self.col_names[p]
                    if nulls_d[nm][vi]:
                        old_vals.append(None)
                        continue
                    ov = cols_d[nm][vi]
                    conv = self.all_conv[p]
                    old_vals.append(conv(ov) if conv is not None else ov)
                old_vals = tuple(old_vals)
                try:
                    old_key = nat.encode_key(old_vals)
                except TypeError:
                    old_key = None
                if old_key == key:
                    continue     # key unchanged: existing entry covers
                if idx.unique and all(
                    new_vals[p] is not None for p in pos
                ):
                    for h in idx.find(key):
                        if h != rid:
                            return None
                keys.append((idx, key))
        except TypeError:
            return None
        mgr = db.mgr
        txn = mgr.begin()
        try:
            mgr.lock_row(t.name, rid, txn)
            nv = t.nversions
            if nv + 1 > t.capacity:
                t._ensure(nv + 1)
            for name, v in zip(self.col_names, new_vals):
                if v is None:
                    nulls_d[name][nv] = True
                else:
                    nulls_d[name][nv] = False
                    cols_d[name][nv] = v
            prev_xmax = int(t.xmax[vi])
            t.xmax[vi] = txn.txn_id
            txn.undo.append((t, "delete", vi, prev_xmax))
            t.xmin[nv] = txn.txn_id
            t.xmax[nv] = 0
            t.rowids[nv] = rid
            t.prev[nv] = vi
            t.latest[rid] = nv
            txn.undo.append((t, "insert", nv, vi))
            t.nversions = nv + 1
            for idx, key in keys:
                idx.insert(key, rid)
            if db.wal_enabled:
                from turdb_tpu_torch.storage.wal import FrameType

                rec = nat.pack_record(self.blob, tuple(new_vals))
                if rec is None:
                    rec = pack_record(info.record_schema(), new_vals)
                self._wal_pair(
                    FrameType.UPDATE, rid.to_bytes(8, "little") + rec,
                    txn.txn_id,
                )
            mgr.commit(txn)
        except Exception:
            mgr.abort(txn)
            raise
        if db.wal_enabled and db.wal.frame_count >= db.checkpoint_threshold:
            db.checkpoint()
        return ExecuteResult(rows_affected=1)


class CachedDeletePlan(_CachedDmlPlan):
    """Prepared single-row DELETE fast lane: probe + delete_row (the
    xmax stamp is already one write; the win is skipping parse/plan/
    scan) + WAL DELETE/COMMIT frame pair (byte-identical to
    _log_delete's)."""

    @classmethod
    def try_build(cls, db, stmt, sql):
        if not (isinstance(stmt, A.Delete) and stmt.using is None
                and not stmt.returning and stmt.where is not None):
            return None
        try:
            return cls(db, stmt, sql)
        except (_NotCacheable, SqlError):
            return None

    def _fast(self, params):
        db = self.db
        t = self.info.table
        hit = self._probe_visible(params)
        if hit is None:
            return None
        if hit == 0:
            return ExecuteResult(rows_affected=0)
        rid, _vi = hit
        mgr = db.mgr
        txn = mgr.begin()
        try:
            count = 0
            if t.delete_row(rid, txn):
                if db.wal_enabled:
                    from turdb_tpu_torch.storage.wal import FrameType

                    self._wal_pair(
                        FrameType.DELETE, rid.to_bytes(8, "little"),
                        txn.txn_id,
                    )
                count = 1
            mgr.commit(txn)
        except Exception:
            mgr.abort(txn)
            raise
        if db.wal_enabled and db.wal.frame_count >= db.checkpoint_threshold:
            db.checkpoint()
        return ExecuteResult(rows_affected=count)


class PreparedStatement:
    """Prepared statement with a cached parse + (for plain INSERT ...
    VALUES) a CachedInsertPlan (reference prepared.rs:106-158).
    Columnar execution re-binds params per call."""

    def __init__(self, db: Database, sql: str):
        self.db = db
        self.sql = sql
        self.stmt = _parse_stmt(sql)
        self._plan: CachedInsertPlan | None | bool = None
        self._psel = self._build_point_select()

    def execute(self, params=None) -> ExecuteResult:
        params = list(params or [])
        db = self.db
        with db._stmt_lock:
            plan = self._plan
            if plan is None:
                if isinstance(self.stmt, A.Insert):
                    plan = CachedInsertPlan.try_build(self.db, self.stmt)
                elif isinstance(self.stmt, A.Update):
                    plan = CachedUpdatePlan.try_build(
                        self.db, self.stmt, self.sql
                    )
                elif isinstance(self.stmt, A.Delete):
                    plan = CachedDeletePlan.try_build(
                        self.db, self.stmt, self.sql
                    )
                self._plan = plan = plan or False
            if plan:
                res = plan.execute(params)
                if isinstance(plan, CachedInsertPlan):
                    self._attach_cstmt(plan)
                elif isinstance(plan, _CachedDmlPlan):
                    self._attach_dml_cstmt(plan)
            else:
                res = db._dispatch(self.stmt, params, self.sql)
        h = db._durable_hook[0]
        if h is not None:
            h()   # group-commit fsync OUTSIDE the statement lock
        return res

    def _attach_cstmt(self, plan):
        """SHADOW self.execute (instance attribute) with the C
        whole-statement entry point when the plan carries the C row
        path, so subsequent execute() calls enter C with zero Python
        frames (each frame costs ~1-3us on a small VM). F['box'] shares
        the live ctx with the plan's retry closure, so a ctx rebuild
        there is visible here; every bail inside C falls back to THIS
        class-bound method, which re-runs the general path and
        re-attaches a fresh shadow."""
        F = plan._fast
        if not F or not F.get("self_check"):
            self.__dict__.pop("execute", None)
            return
        box = F.get("box")
        nat = F.get("nat")
        if box is None or not hasattr(nat, "exec_insert_stmt"):
            self.__dict__.pop("execute", None)
            return
        cur = self.__dict__.get("execute")
        if cur is not None and cur.args[0][0] is box:
            return   # shadow already bound to the live ctx box
        lock = self.db._stmt_lock
        state = (box, lock.acquire, lock.release,
                 ExecuteResult.__new__, ExecuteResult,
                 PreparedStatement.execute.__get__(self),
                 self.db._durable_hook)
        self.execute = _partial(nat.exec_insert_stmt, state)

    def _attach_dml_cstmt(self, plan):
        """UPDATE/DELETE analog of _attach_cstmt: shadow execute with
        the C whole-statement entry (native/oltp.c exec_dml_stmt) when
        the plan carries a C ctx. plan._cbox is the live ctx box —
        maintenance rebuilds inside _c_exec mutate box[0] in place, so
        the shadow keeps working; a full rebind swaps the box and the
        next generic-path execute re-attaches the fresh one."""
        box = getattr(plan, "_cbox", None)
        nat = plan.nat
        if (box is None or plan._dead
                or not hasattr(nat, "exec_dml_stmt")):
            self.__dict__.pop("execute", None)
            return
        cur = self.__dict__.get("execute")
        if cur is not None and cur.args[0][0] is box:
            return   # shadow already bound to the live ctx box
        lock = self.db._stmt_lock
        state = (box, lock.acquire, lock.release,
                 ExecuteResult.__new__, ExecuteResult,
                 PreparedStatement.execute.__get__(self),
                 self.db._durable_hook)
        self.execute = _partial(nat.exec_dml_stmt, state)

    def _build_point_select(self):
        """Point-read fast lane (reference design target <50µs disk /
        <1µs cached, lib.rs:64): a prepared `SELECT cols FROM t WHERE
        unique-key = $n [AND ...]` resolves to one index probe + direct
        column reads, skipping the whole engine pipeline. Built lazily
        at first query() (the table must exist); None = generic path."""
        s = self.stmt
        if not isinstance(s, A.Select) or not isinstance(s.from_, A.TableRef):
            return None
        if (s.where is None or s.group_by or s.having or s.order_by
                or s.limit is not None or s.offset is not None or s.distinct
                or s.ctes or s.set_op or s.for_update):
            return None
        cols = []
        for it in s.items:
            if isinstance(it, A.Star):
                cols.append("*")
            elif isinstance(it, A.SelectItem) and isinstance(
                it.expr, A.ColumnRef
            ):
                cols.append(it.expr.name)
            else:
                return None
        eqs = {}

        def walk(e):
            if isinstance(e, A.BinaryOp) and e.op == "AND":
                return walk(e.left) and walk(e.right)
            if isinstance(e, A.BinaryOp) and e.op == "=":
                a, b = e.left, e.right
                if not isinstance(a, A.ColumnRef):
                    a, b = b, a
                if isinstance(a, A.ColumnRef) and isinstance(
                    b, (A.Literal, A.Param)
                ):
                    eqs[a.name] = b
                    return True
            return False

        if not walk(s.where):
            return None
        return {"cols": cols, "eqs": eqs, "ref": s.from_, "bound": None}

    def _point_select(self, params):
        """Returns rows or None (bail to generic engine)."""
        from turdb_tpu_torch.native.build import oltp
        from turdb_tpu_torch.storage.toast import detoast_value

        db = self.db
        P = self._psel
        bound = P["bound"]
        if bound is None or bound[0] is not db.catalog.get(
            P["ref"].schema or "main", {}
        ).get(P["ref"].name):
            try:
                info = db.resolve_table(P["ref"])
            except SqlError:
                return None
            nat = oltp()
            if nat is None:
                return None
            match = None
            for name, idx in info.btree.items():
                cl = info.btree_cols[name]
                if (idx.unique and cl is not None
                        and name not in info.btree_where
                        and set(cl) == set(P["eqs"])):
                    match = (idx, cl)
                    break
            if match is None:
                self._psel = None   # no unique cover: generic forever
                return None
            out_cols = []
            for c in P["cols"]:
                if c == "*":
                    out_cols.extend(cd.name for cd in info.columns)
                elif any(cd.name == c for cd in info.columns):
                    out_cols.append(c)
                else:
                    self._psel = None
                    return None
            binders = []
            for c in match[1]:
                b = P["eqs"][c]
                if isinstance(b, A.Param):
                    binders.append((True, b.index - 1))
                else:
                    binders.append((False, b.value))
            bound = (info, match[0], match[1], out_cols, nat, binders)
            P["bound"] = bound
            self._build_point_c(P, bound)
        info, idx, keycols, out_cols, nat, binders = bound
        t = info.table
        vals = []
        for is_param, payload in binders:
            v = params[payload] if is_param else payload
            if v is None:
                return []
            vals.append(v)
        try:
            key = nat.encode_key(tuple(vals))
        except TypeError:
            return None
        rids = idx.find(key)
        if not rids:
            return []
        txn = db._txn
        read_ts = txn.read_ts if txn is not None else db.mgr.snapshot_ts()
        own = txn.txn_id if txn is not None else 0
        out = []
        toast = t.toast_cols
        for rid in rids:
            vi = t.visible_version(db.mgr, rid, read_ts, own)
            if vi is None:
                continue
            # index entries persist until vacuum: re-verify key columns
            ok = True
            for c, want in zip(keycols, vals):
                if t.nulls[c][vi]:
                    ok = False
                    break
                # numpy scalar != python value compares correctly — the
                # _py normalization only matters for the output rows.
                # Toasted key columns store a pointer object: detoast
                # before comparing (review-found: the raw compare made
                # big-key point reads silently return [])
                got = t.cols[c][vi]
                if c in toast:
                    got = detoast_value(got)
                if got != want:
                    ok = False
                    break
            if not ok:
                continue
            row = []
            for c in out_cols:
                if t.nulls[c][vi]:
                    row.append(None)
                else:
                    v = _py(t.cols[c][vi])
                    row.append(detoast_value(v) if c in toast else v)
            out.append(tuple(row))
        return out

    def _build_point_c(self, P, bound):
        """Attach the all-C point-read lane (native/oltp.c exec_point:
        key encode, clean-single probe, scalar MVCC walk, direct column
        reads in ONE call — the reference's <1µs cached point-read
        design target, lib.rs:64). Bails back to the Python lane for
        anything unusual; a catalog/array change invalidates the ctx and
        the next call rebuilds from scratch."""
        info, idx, keycols, out_cols, nat, binders = bound
        if not hasattr(nat, "exec_point"):
            return
        t = info.table
        if t.toast_cols or len(info.columns) > 64:
            return
        sc_code = {
            StorageClass.INT: 0, StorageClass.FLOAT: 1,
            StorageClass.FLOAT32: 2, StorageClass.BOOL: 3,
            StorageClass.TEXT: 4, StorageClass.BYTES: 5,
        }
        cols = info.columns
        for cd in cols:
            if cd.dtype.storage_class not in sc_code:
                return
        try:
            db = self.db
            names = [cd.name for cd in cols]
            name_pos = {n: j for j, n in enumerate(names)}
            refs = [t.cols[n] for n in names]
            nrefs = [t.nulls[n] for n in names]
            cspec = tuple(
                (sc_code[cd.dtype.storage_class], c.ctypes.data,
                 nl.ctypes.data, 1, -1)
                for cd, c, nl in zip(cols, refs, nrefs)
            )
            desc = nat.make_row_desc(
                cspec, t.xmin.ctypes.data, t.xmax.ctypes.data,
                t.rowids.ctypes.data, t.prev.ctypes.data,
            )
            ct = db.mgr._commit_ts
            kb = tuple(
                (1, b[1], None) if b[0] else (0, 0, b[1]) for b in binders
            )
            ctx = nat.make_point_ctx((
                db, db.mgr, t, info,
                self.stmt.from_.schema or "main", self.stmt.from_.name,
                t.cols, names[0], ct, ct.ctypes.data, len(ct), desc, idx,
                tuple(name_pos[c] for c in keycols), kb,
                tuple(name_pos[c] for c in out_cols),
            ))
        except Exception:
            return
        # the ctx holds RAW pointers: pin the arrays it dereferences
        P["ckeep"] = refs + nrefs + [t.xmin, t.xmax, t.rowids, t.prev,
                                     ct, desc]
        EXECP = nat.exec_point

        def cfn(params):
            r = EXECP(ctx, params)
            if type(r) is int:          # catalog/arrays changed
                P["cfn"] = None
                P["bound"] = None       # python lane re-resolves + re-attaches
                return None
            return r                    # rows list, or None = bail

        P["cfn"] = cfn
        if hasattr(nat, "exec_point_stmt"):
            # SHADOW self.query (instance attribute) with the C
            # whole-statement entry: lock + point read in ONE C call,
            # zero Python frames. Staleness falls back to THIS
            # class-bound method; its cfn wrapper clears + re-resolves,
            # and the rebuilt ctx re-attaches a fresh shadow here.
            lock = db._stmt_lock
            state = ([ctx], lock.acquire, lock.release,
                     PreparedStatement.query.__get__(self))
            self.query = _partial(nat.exec_point_stmt, state)

    def query(self, params=None) -> list[tuple]:
        if isinstance(self.stmt, A.Select):
            params = list(params or [])
            with self.db._stmt_lock:
                P = self._psel
                if P is not None:
                    cfn = P.get("cfn")
                    if cfn is not None:
                        rows = cfn(params)
                        if rows is not None:
                            return rows
                    rows = self._point_select(params)
                    if rows is not None:
                        return rows
                ctx = self.db._ctx(params)
                return _batch_to_rows(
                    self.db.engine.run_select(self.stmt, ctx)
                )[1]
        return self.execute(params).rows or []


def connect(path: str, *, device="cuda") -> Database:
    """Open, creating if missing (convenience). The vector indexes run on
    `device`: the card unless the caller asks for the CPU."""
    try:
        return Database.open(path, device=device)
    except DatabaseError:
        return Database.create(path, device=device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


_PARSE_CACHE: dict[str, object] = {}


def _parse_stmt(sql: str):
    stmt = _PARSE_CACHE.get(sql)
    if stmt is None:
        from turdb_tpu_torch.sql.fold import fold_statement

        stmt = fold_statement(Parser(sql).parse_statement())
        if len(_PARSE_CACHE) > 512:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[sql] = stmt
    return stmt


def _parse_expr(text: str):
    p = Parser(text)
    return p._expr()


def _jsonable_fk(x):
    return list(x) if isinstance(x, (list, tuple)) else x


def _batch_index_keys(table: ColumnarTable, cols: list[str], vis):
    """Vectorized key bytes for a whole reindex sweep when every index
    column is a plain numeric array (the PK-on-INT common case); None
    when any column needs the per-row encoder."""
    from turdb_tpu_torch.records.keys import TAG_NULL, encode_num_batch

    parts = []
    for c in cols:
        sv = table.cols[c][vis]
        if sv.dtype.kind not in "iuf":
            return None
        p = encode_num_batch(sv)
        sn = table.nulls[c][vis]
        if sn.any():
            nullb = bytes([TAG_NULL])
            p = [nullb if nu else k for k, nu in zip(p, sn)]
        parts.append(p)
    if len(parts) == 1:
        return parts[0]
    return [b"".join(t) for t in zip(*parts)]


def _norm_probe(v):
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return _py(v)


def _strip_quals(e, q):
    """Deep-copy an expr with ColumnRef qualifiers naming `q` removed, so
    `t.lower(x)`-style WHERE exprs compare equal (via render_expr) to the
    unqualified exprs stored in an expression index definition."""
    import copy
    import dataclasses as _dc

    e = copy.deepcopy(e)

    def walk(x):
        if isinstance(x, A.ColumnRef):
            if x.table == q:
                x.table = None
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

    walk(e)
    return e


def _expr_index_keys(db, info, name, vidx):
    """Key bytes for an expression index over version rows `vidx`:
    one vectorized eval_expr per index expr + per-row key encode."""
    idx = info.btree[name]
    arr = np.asarray(vidx, np.int64)
    b = Batch(len(arr))
    for c in info.columns:
        vals, nulls = info.table.column_batch(c.name, arr)
        b.add(
            info.table.name, c.name,
            Col(_detoast_col(info.table, c.name, vals), nulls),
        )
    ctx = db._ctx([], None)
    cols_out = [eval_expr(e, b, ctx) for e in info.btree_exprs[name]]
    return [
        idx.make_key(
            [None if c.nulls[i] else _py(c.values[i]) for c in cols_out]
        )
        for i in range(len(arr))
    ]


def _cell(table: ColumnarTable, colname: str, idx: int):
    if table.nulls[colname][idx]:
        return None
    v = table.cols[colname][idx]
    return _py(v)


def _detoast_col(table, name: str, vals):
    """Resolve out-of-line values for columns known to hold pointers
    (no-op for every other column — one set lookup per column)."""
    if name in table.toast_cols and len(vals):
        from turdb_tpu_torch.storage.toast import detoast_value

        out = np.empty(len(vals), object)
        out[:] = [detoast_value(x) for x in vals]
        return out
    return vals


def _batch_to_rows(batch: Batch):
    """Columnar -> row tuples, column-at-a-time (ndarray.tolist is one C
    call; the per-cell loop was a top-3 hot spot at 1M rows)."""
    cols = [nm for (q, nm) in batch.names if nm != ROWID]
    keep = [i for i, (q, nm) in enumerate(batch.names) if nm != ROWID]
    pycols = []
    for j in keep:
        c = batch.cols[j]
        v = c.values
        if v.ndim > 1:
            vals = [np.array(x) for x in v]
        elif v.dtype == object:
            vals = [_py(x) for x in v]
        else:
            vals = v.tolist()
        if c.nulls.any():
            nn = c.nulls.tolist()
            vals = [None if nu else x for nu, x in zip(nn, vals)]
        pycols.append(vals)
    rows = list(zip(*pycols)) if pycols else [()] * batch.n
    return cols, rows
