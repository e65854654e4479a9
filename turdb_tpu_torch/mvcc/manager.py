"""Transaction manager: timestamps, commit log, vectorized visibility.

Reference mapping:
- global atomic timestamp + txn slots  -> monotonic counters (single
  process, GIL-serialized)             (reference mvcc/transaction.rs:98-104)
- commit_log HashMap<start_ts, commit_ts> -> dense numpy array indexed by
  txn id: commit_ts[txn] with sentinels (IN_PROGRESS/ABORTED), so batch
  visibility is pure array indexing    (transaction.rs:104,141-156)
- visibility predicate                 (version.rs:315-320)
- row write locks (LOCK_BIT)           -> per-rowid writer map; conflicting
  writers raise TxnConflict            (record_header.rs LOCK_BIT)
- auto-rollback on Drop                -> context-manager + explicit abort
                                         (transaction.rs:298)
- watermark GC                         -> min active read_ts for vacuum
"""

from __future__ import annotations

import numpy as np

IN_PROGRESS = np.int64(2**62)
ABORTED = np.int64(2**62 + 1)


class TxnConflict(Exception):
    """Write-write conflict: row already locked by a concurrent txn."""


class Transaction:
    def __init__(self, mgr: "TransactionManager", txn_id: int, read_ts: int):
        self.mgr = mgr
        self.txn_id = txn_id
        self.read_ts = read_ts
        self.active = True
        # write sets for conflict release + rollback: {(table, rowid)}
        self.write_set: set = set()
        # undo entries appended by the storage layer:
        # (table, kind, version_index, prev) — applied in reverse on abort
        self.undo: list = []
        self.savepoints: dict[str, int] = {}

    # -- savepoints (reference database/transaction.rs SAVEPOINT) ---------

    def savepoint(self, name: str):
        self.savepoints[name] = len(self.undo)

    def release_savepoint(self, name: str):
        if name not in self.savepoints:
            raise ValueError(f"no such savepoint: {name}")
        del self.savepoints[name]

    def rollback_to(self, name: str):
        if name not in self.savepoints:
            raise ValueError(f"no such savepoint: {name}")
        mark = self.savepoints[name]
        while len(self.undo) > mark:
            table, kind, idx, prev = self.undo.pop()
            table._undo_one(kind, idx, prev, self)
        # drop savepoints created after this one
        self.savepoints = {n: m for n, m in self.savepoints.items() if m <= mark}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_):
        if self.active:
            if exc_type is None:
                self.mgr.commit(self)
            else:
                self.mgr.abort(self)
        return False


class TransactionManager:
    def __init__(self):
        self._next_txn = 1
        self._next_ts = 1
        # commit_ts[txn_id]: IN_PROGRESS, ABORTED, or the commit timestamp
        self._commit_ts = np.full(1024, IN_PROGRESS, np.int64)
        self._commit_ts[0] = 0  # txn 0 = bootstrap/autocommit-committed
        self.active: dict[int, Transaction] = {}
        # row write locks: (table_name, rowid) -> txn_id
        self._locks: dict = {}

    # -- lifecycle ---------------------------------------------------------

    def begin(self) -> Transaction:
        txn_id = self._next_txn
        self._next_txn += 1
        read_ts = self._next_ts
        self._ensure(txn_id)
        self._commit_ts[txn_id] = IN_PROGRESS
        txn = Transaction(self, txn_id, read_ts)
        self.active[txn_id] = txn
        return txn

    def autocommit_begin(self) -> int:
        """Lightweight txn id for a single-statement autocommit write
        (the prepared-insert fast lane): fresh commit-log slots are
        already IN_PROGRESS, ids are never reused, and the statement
        lock serializes statements, so no Transaction object, undo list,
        active-set entry, or lock bookkeeping is needed. The caller
        stamps the outcome with autocommit_commit/autocommit_abort."""
        tid = self._next_txn
        self._next_txn = tid + 1
        if tid >= len(self._commit_ts):
            self._ensure(tid)
        return tid

    def autocommit_commit(self, tid: int) -> int:
        self._next_ts += 1
        self._commit_ts[tid] = self._next_ts
        return self._next_ts

    def autocommit_abort(self, tid: int):
        self._commit_ts[tid] = ABORTED

    def commit(self, txn: Transaction) -> int:
        assert txn.active
        self._next_ts += 1
        cts = self._next_ts
        self._commit_ts[txn.txn_id] = cts
        txn.active = False
        self._release(txn)
        self.active.pop(txn.txn_id, None)
        return cts

    def abort(self, txn: Transaction):
        assert txn.active
        # apply undo in reverse (reference write-entry undo application)
        while txn.undo:
            table, kind, idx, prev = txn.undo.pop()
            table._undo_one(kind, idx, prev, txn)
        self._commit_ts[txn.txn_id] = ABORTED
        txn.active = False
        self._release(txn)
        self.active.pop(txn.txn_id, None)

    def _release(self, txn: Transaction):
        for key in txn.write_set:
            if self._locks.get(key) == txn.txn_id:
                del self._locks[key]
        txn.write_set.clear()

    # -- locks (single-writer-per-row, reference mvcc/mod.rs:8-41) --------

    def lock_row(self, table_name: str, rowid: int, txn: Transaction):
        key = (table_name, rowid)
        holder = self._locks.get(key)
        if holder is not None and holder != txn.txn_id:
            if holder in self.active:
                raise TxnConflict(
                    f"row {rowid} in {table_name} locked by txn {holder}"
                )
        self._locks[key] = txn.txn_id
        txn.write_set.add(key)

    # -- visibility --------------------------------------------------------

    def visible_mask(
        self,
        xmin: np.ndarray,
        xmax: np.ndarray,
        read_ts: int,
        own_txn: int = 0,
    ) -> np.ndarray:
        """Vectorized snapshot-visibility over version stamp columns.

        A version is visible iff its creator committed before the snapshot
        (or is the reading txn) AND its deleter (if any) has not
        (reference version.rs:315-320), evaluated for the whole batch with
        two gathers into the commit-ts array.
        """
        cmin = self._commit_ts[xmin]
        cmax = self._commit_ts[np.maximum(xmax, 0)]
        created = (xmin == own_txn) | (cmin <= read_ts)
        deleted = (xmax > 0) & ((xmax == own_txn) | (cmax <= read_ts))
        return created & ~deleted

    def visible_one(self, xmin_i: int, xmax_i: int, read_ts: int,
                    own_txn: int = 0) -> bool:
        """Scalar visible_mask for single-version probes (point reads,
        version-chain walks): the 1-element numpy path costs ~13µs of
        array overhead per call; this is ~0.5µs."""
        ct = self._commit_ts
        if xmin_i != own_txn and ct[xmin_i] > read_ts:
            return False
        return not (
            xmax_i > 0 and (xmax_i == own_txn or ct[xmax_i] <= read_ts)
        )

    def snapshot_ts(self) -> int:
        """Read timestamp for a fresh snapshot (autocommit reads)."""
        return self._next_ts

    def commit_watermark(self) -> int:
        """Oldest read_ts any active txn can see — the vacuum horizon
        (reference watermark GC)."""
        if not self.active:
            return self._next_ts
        return min(t.read_ts for t in self.active.values())

    def _ensure(self, txn_id: int):
        if txn_id >= len(self._commit_ts):
            grow = np.full(len(self._commit_ts), IN_PROGRESS, np.int64)
            self._commit_ts = np.concatenate([self._commit_ts, grow])

    # -- persistence hooks -------------------------------------------------

    def state_for_checkpoint(self) -> dict:
        return {"next_txn": self._next_txn, "next_ts": self._next_ts}

    def restore(self, state: dict):
        self._next_txn = int(state["next_txn"])
        self._next_ts = int(state["next_ts"])
        n = max(1024, self._next_txn + 1)
        self._commit_ts = np.full(n, IN_PROGRESS, np.int64)
        self._commit_ts[0] = 0
        # after recovery every replayed txn is committed with its own ts=0
        # ordering; recovery rewrites stamps to committed form (txn 0)
