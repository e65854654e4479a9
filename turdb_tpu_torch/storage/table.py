"""Columnar table store with MVCC version stamps.

The reference stores rows in B-tree leaf pages with a 17-byte MVCC header
and undo-page version chains (SURVEY.md §2.5); here every row VERSION is
an index into typed column arrays carrying (xmin, xmax) stamps — batch
visibility is one vectorized predicate, scans feed device operators as
contiguous columns, and "updates" append versions (PostgreSQL-style).
Aborted transactions need almost no undo: the commit log already makes
their versions invisible; undo only restores xmax stamps and the
rowid→latest map (cf. reference undo pages, mvcc/undo_page.rs).
"""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.mvcc.manager import Transaction, TransactionManager
from turdb_tpu_torch.types.column import ColumnDef
from turdb_tpu_torch.types.datatype import DataType, StorageClass

_GROW0 = 256


class ColumnarTable:
    def __init__(self, name: str, columns: list[ColumnDef], table_id: int = 0):
        self.name = name
        self.table_id = table_id
        self.columns = list(columns)
        self.colnames = [c.name for c in columns]
        self.capacity = _GROW0
        self.nversions = 0
        self.cols: dict[str, np.ndarray] = {}
        self.nulls: dict[str, np.ndarray] = {}
        for c in columns:
            self.cols[c.name] = self._alloc(c, self.capacity)
            self.nulls[c.name] = np.ones(self.capacity, bool)
        self.xmin = np.zeros(self.capacity, np.int64)
        self.xmax = np.zeros(self.capacity, np.int64)
        self.rowids = np.zeros(self.capacity, np.int64)
        # version chain: index of the previous version of the same rowid,
        # -1 at chain end (reference mvcc/version.rs VersionChainReader :124)
        self.prev = np.full(self.capacity, -1, np.int64)
        self.latest: dict[int, int] = {}   # rowid -> newest version index
        self.next_rowid = 1
        self.auto_increment = 1            # for SERIAL columns
        # TOAST: oversized TEXT/BLOB values live out-of-line (reference
        # toast.rs; wired by dml._prepare_row / read-path detoasting)
        from turdb_tpu_torch.storage.toast import ToastStore

        self.toast = ToastStore()
        self.toast_cols: set[str] = set()  # columns holding Toasted values

    # -- allocation -------------------------------------------------------

    def _alloc(self, c: ColumnDef, n: int) -> np.ndarray:
        sc = c.dtype.storage_class
        if sc is StorageClass.INT:
            return np.zeros(n, np.int64)
        if sc is StorageClass.FLOAT:
            return np.zeros(n, np.float64)
        if sc is StorageClass.FLOAT32:
            return np.zeros(n, np.float32)
        if sc is StorageClass.BOOL:
            return np.zeros(n, bool)
        if sc is StorageClass.VECTOR:
            return np.zeros((n, c.vector_dim or 0), np.float32)
        return np.empty(n, object)

    def _ensure(self, need: int):
        if need <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        for c in self.columns:
            old = self.cols[c.name]
            grown = self._alloc(c, new_cap)
            grown[: self.nversions] = old[: self.nversions]
            self.cols[c.name] = grown
            nu = np.ones(new_cap, bool)
            nu[: self.nversions] = self.nulls[c.name][: self.nversions]
            self.nulls[c.name] = nu
        for attr in ("xmin", "xmax", "rowids"):
            old = getattr(self, attr)
            grown = np.zeros(new_cap, np.int64)
            grown[: self.nversions] = old[: self.nversions]
            setattr(self, attr, grown)
        grown = np.full(new_cap, -1, np.int64)
        grown[: self.nversions] = self.prev[: self.nversions]
        self.prev = grown
        self.capacity = new_cap

    # -- DML ---------------------------------------------------------------

    def insert_rows(
        self,
        rows: list[dict],
        txn: Transaction,
        rowids: list[int] | None = None,
    ) -> list[int]:
        """Append new row versions. `rows`: list of {col: value}."""
        n = len(rows)
        self._ensure(self.nversions + n)
        base = self.nversions
        out_ids = []
        for j, row in enumerate(rows):
            idx = base + j
            rid = rowids[j] if rowids else self.next_rowid
            if rowids is None:
                self.next_rowid += 1
            else:
                self.next_rowid = max(self.next_rowid, rid + 1)
            for c in self.columns:
                v = row.get(c.name)
                if v is None:
                    self.nulls[c.name][idx] = True
                else:
                    self.nulls[c.name][idx] = False
                    self.cols[c.name][idx] = self._coerce(c, v)
            self.xmin[idx] = txn.txn_id
            self.xmax[idx] = 0
            self.rowids[idx] = rid
            prev = self.latest.get(rid)
            self.prev[idx] = -1 if prev is None else prev
            self.latest[rid] = idx
            txn.undo.append((self, "insert", idx, prev))
            out_ids.append(rid)
        self.nversions += n
        return out_ids

    def insert_columns(
        self, data: dict, txn: Transaction, rowids: np.ndarray | None = None
    ) -> np.ndarray:
        """Vectorized bulk append (reference fast_load.rs FastLoader): one
        array copy per column instead of a per-row loop. `data` maps
        column name -> array or (values, null_mask); missing columns are
        all-NULL. Returns the assigned rowids. Fresh rowids only (no
        version chains) — updates go through update_row."""
        first = next(iter(data.values()))
        n = len(first[0] if isinstance(first, tuple) else first)
        base = self.nversions
        self._ensure(base + n)
        for c in self.columns:
            if c.name not in data:
                self.nulls[c.name][base : base + n] = True
                continue
            v = data[c.name]
            vals, nulls = v if isinstance(v, tuple) else (v, None)
            vals = np.asarray(vals)
            if nulls is None:
                if vals.dtype == object:
                    nulls = np.asarray([x is None for x in vals], bool)
                else:
                    nulls = np.zeros(n, bool)
            sc = c.dtype.storage_class
            if sc is StorageClass.INT:
                safe = np.where(nulls, 0, vals) if vals.dtype == object else vals
                self.cols[c.name][base : base + n] = safe.astype(np.int64)
            elif sc is StorageClass.FLOAT:
                safe = np.where(nulls, 0.0, vals) if vals.dtype == object else vals
                self.cols[c.name][base : base + n] = safe.astype(np.float64)
            elif sc is StorageClass.FLOAT32:
                safe = np.where(nulls, 0.0, vals) if vals.dtype == object else vals
                self.cols[c.name][base : base + n] = safe.astype(np.float32)
            elif sc is StorageClass.BOOL:
                safe = np.where(nulls, False, vals) if vals.dtype == object else vals
                self.cols[c.name][base : base + n] = safe.astype(bool)
            elif sc is StorageClass.VECTOR:
                want = self.cols[c.name].shape[1]
                if not nulls.all():
                    vv = np.stack([
                        np.zeros(want, np.float32) if nu
                        else np.asarray(x, np.float32)
                        for x, nu in zip(vals, nulls)
                    ]) if vals.dtype == object else vals.astype(np.float32)
                    if vv.shape[1] != want:
                        raise ValueError(
                            f"vector dim mismatch for {c.name}: "
                            f"got {vv.shape[1]}, want {want}"
                        )
                    self.cols[c.name][base : base + n] = vv
            elif sc is StorageClass.DECIMAL:
                out = self.cols[c.name]
                for j, (x, nu) in enumerate(zip(vals, nulls)):
                    out[base + j] = None if nu else self._coerce(c, x)
            else:
                out = self.cols[c.name]
                if vals.dtype == object:
                    out[base : base + n] = vals
                else:
                    out[base : base + n] = vals.astype(object)
            self.nulls[c.name][base : base + n] = nulls
        if rowids is None:
            rids = np.arange(self.next_rowid, self.next_rowid + n, dtype=np.int64)
            self.next_rowid += n
        else:
            rids = np.asarray(rowids, np.int64)
            self.next_rowid = max(self.next_rowid, int(rids.max(initial=0)) + 1)
        self.rowids[base : base + n] = rids
        self.xmin[base : base + n] = txn.txn_id
        self.xmax[base : base + n] = 0
        self.prev[base : base + n] = -1
        self.latest.update(zip(rids.tolist(), range(base, base + n)))
        txn.undo.append((self, "insert_range", (base, n), None))
        self.nversions += n
        return rids

    def delete_row(self, rowid: int, txn: Transaction) -> bool:
        idx = self.latest.get(rowid)
        if idx is None:
            return False
        txn.mgr.lock_row(self.name, rowid, txn)
        if self.xmax[idx] != 0 and self.xmax[idx] != txn.txn_id:
            # deleted by a committed txn we can't see yet -> conflict is
            # raised by lock_row for active holders; a committed stamp
            # means the row is already gone for us
            return False
        prev_xmax = int(self.xmax[idx])
        self.xmax[idx] = txn.txn_id
        txn.undo.append((self, "delete", idx, prev_xmax))
        return True

    def update_row(self, rowid: int, changes: dict, txn: Transaction) -> bool:
        """MVCC update = stamp old version's xmax + append new version."""
        idx = self.latest.get(rowid)
        if idx is None:
            return False
        txn.mgr.lock_row(self.name, rowid, txn)
        new_row = {
            c.name: (
                None
                if self.nulls[c.name][idx]
                else self._get(c, idx)
            )
            for c in self.columns
        }
        new_row.update(changes)
        prev_xmax = int(self.xmax[idx])
        self.xmax[idx] = txn.txn_id
        txn.undo.append((self, "delete", idx, prev_xmax))
        self.insert_rows([new_row], txn, rowids=[rowid])
        return True

    def _coerce(self, c: ColumnDef, v):
        sc = c.dtype.storage_class
        if sc is StorageClass.INT:
            try:
                return int(v)
            except (ValueError, TypeError):
                # a raw ValueError would leak out of the public execute()
                # API; the reference surfaces a typed conversion error
                from turdb_tpu_torch.sql.lexer import SqlError

                raise SqlError(
                    f"invalid input for {self.name}.{c.name} "
                    f"({c.dtype.name}): {v!r}"
                )
        if sc in (StorageClass.FLOAT, StorageClass.FLOAT32):
            try:
                return float(v)
            except (ValueError, TypeError):
                from turdb_tpu_torch.sql.lexer import SqlError

                raise SqlError(
                    f"invalid input for {self.name}.{c.name} "
                    f"({c.dtype.name}): {v!r}"
                )
        if sc is StorageClass.DECIMAL:
            from decimal import Decimal, InvalidOperation

            try:
                # floats go through str(): shortest-repr keeps 0.1 exact
                d = v if isinstance(v, Decimal) else Decimal(
                    str(v) if isinstance(v, float) else v
                )
                if c.scale is not None:
                    d = d.quantize(Decimal(1).scaleb(-c.scale))
            except (InvalidOperation, ValueError, TypeError):
                from turdb_tpu_torch.sql.lexer import SqlError

                raise SqlError(
                    f"invalid input for {self.name}.{c.name} "
                    f"({c.dtype.name}): {v!r}"
                )
            return d
        if sc is StorageClass.BOOL:
            return bool(v)
        if sc is StorageClass.VECTOR:
            arr = np.asarray(v, np.float32)
            want = self.cols[c.name].shape[1]
            if arr.shape != (want,):
                raise ValueError(
                    f"vector dim mismatch for {c.name}: got {arr.shape}, want ({want},)"
                )
            return arr
        if sc is StorageClass.TEXT:
            from turdb_tpu_torch.storage.toast import Toasted

            if isinstance(v, Toasted):
                return v
            if c.dtype in (
                DataType.INT4RANGE, DataType.INT8RANGE, DataType.DATERANGE,
                DataType.TSRANGE, DataType.BOX, DataType.CIRCLE,
            ):
                from turdb_tpu_torch.types.ranges import canonical_text

                return canonical_text(str(v), c.dtype.name)
            return v if isinstance(v, str) else str(v)
        return v

    def _get(self, c: ColumnDef, idx: int):
        v = self.cols[c.name][idx]
        if c.dtype.storage_class is StorageClass.VECTOR:
            return np.array(v)
        if isinstance(v, np.generic):
            return v.item()
        return v

    # -- undo (called by TransactionManager.abort / rollback_to) ----------

    def _undo_one(self, kind: str, idx: int, prev, txn: Transaction):
        if kind == "insert_range":
            base, n = idx
            for i in range(base, base + n):
                rid = int(self.rowids[i])
                if self.latest.get(rid) == i:
                    self.latest.pop(rid, None)
            self.xmax[base : base + n] = txn.txn_id
            return
        if kind == "insert":
            rid = int(self.rowids[idx])
            if prev is None:
                self.latest.pop(rid, None)
            else:
                self.latest[rid] = prev
            # stamp self-deleted: invisible to the still-active txn (own
            # delete) and to everyone after commit; vacuum reclaims it
            self.xmax[idx] = txn.txn_id
        elif kind == "delete":
            if self.xmax[idx] == txn.txn_id:
                self.xmax[idx] = prev or 0

    # -- scan --------------------------------------------------------------

    def visible_indices(
        self, mgr: TransactionManager, read_ts: int, own_txn: int = 0
    ) -> np.ndarray:
        """Indices of visible row versions under the snapshot — one
        vectorized mask over the whole version store."""
        n = self.nversions
        if n == 0:
            return np.empty(0, np.int64)
        mask = mgr.visible_mask(self.xmin[:n], self.xmax[:n], read_ts, own_txn)
        return np.flatnonzero(mask)

    def visible_version(
        self, mgr: TransactionManager, rowid: int, read_ts: int, own_txn: int = 0
    ) -> int | None:
        """Version index of `rowid` visible under the snapshot, walking the
        version chain newest->oldest (reference VersionChainReader,
        mvcc/version.rs:124) — the snapshot may see an older version than
        `latest` when a concurrent txn committed an UPDATE/DELETE."""
        i = self.latest.get(rowid)
        while i is not None and i >= 0:
            if mgr.visible_one(
                int(self.xmin[i]), int(self.xmax[i]), read_ts, own_txn
            ):
                return i
            i = int(self.prev[i])
        return None

    def column_batch(self, name: str, indices: np.ndarray):
        """(values, null_mask) for a column over selected versions."""
        return self.cols[name][indices], self.nulls[name][indices]

    def row_as_dict(self, idx: int) -> dict:
        from turdb_tpu_torch.storage.toast import detoast_value

        out = {}
        for c in self.columns:
            out[c.name] = (
                None if self.nulls[c.name][idx]
                else detoast_value(self._get(c, idx))
            )
        return out

    # -- vacuum ------------------------------------------------------------

    def vacuum(self, mgr: TransactionManager) -> int:
        """Compact dead versions (deleted before the oldest active
        snapshot, or created by aborted txns). Returns versions removed.
        The reference's analog is the HNSW vacuum queue + undo watermark GC."""
        n = self.nversions
        if n == 0:
            return 0
        if mgr.active:
            # undo entries hold version indices; compaction would shift them
            return 0
        horizon = mgr.commit_watermark()
        from turdb_tpu_torch.mvcc.manager import ABORTED

        cmin = mgr._commit_ts[self.xmin[:n]]
        cmax = mgr._commit_ts[np.maximum(self.xmax[:n], 0)]
        dead = (cmin == ABORTED) | ((self.xmax[:n] > 0) & (cmax <= horizon))
        keep = np.flatnonzero(~dead)
        removed = n - len(keep)
        if removed == 0:
            return 0
        # remap version-chain pointers: skip over removed ancestors
        remap = np.full(n, -1, np.int64)
        remap[keep] = np.arange(len(keep))
        new_prev = np.full(len(keep), -1, np.int64)
        for new_i, old_i in enumerate(keep):
            p = int(self.prev[old_i])
            while p >= 0 and remap[p] < 0:
                p = int(self.prev[p])
            new_prev[new_i] = remap[p] if p >= 0 else -1
        for c in self.columns:
            self.cols[c.name][: len(keep)] = self.cols[c.name][keep]
            self.nulls[c.name][: len(keep)] = self.nulls[c.name][keep]
        self.xmin[: len(keep)] = self.xmin[keep]
        self.xmax[: len(keep)] = self.xmax[keep]
        self.rowids[: len(keep)] = self.rowids[keep]
        self.prev[: len(keep)] = new_prev
        self.nversions = len(keep)
        if self.toast_cols:
            # prune chunks no surviving version references (versions share
            # pointers across updates, so collect live tids first)
            from turdb_tpu_torch.storage.toast import Toasted

            live: set[int] = set()
            for cn in self.toast_cols:
                col, nulls = self.cols[cn], self.nulls[cn]
                for i in range(len(keep)):
                    v = col[i]
                    if not nulls[i] and isinstance(v, Toasted):
                        live.add(v.tid)
            for tid in list(self.toast.chunks):
                if tid not in live:
                    del self.toast.chunks[tid]
        self.latest = {}
        for new_idx in range(len(keep)):
            self.latest[int(self.rowids[new_idx])] = new_idx
        return removed
