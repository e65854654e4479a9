"""Secondary index structures.

Replaces the reference's on-disk B-tree secondary indexes (reference
src/btree/, SURVEY.md §2.2) with host-side sorted key arrays — the
"sorted-array index amenable to vectorized search" called for by the
build plan (§2.2 TPU-native equivalent): a sorted run of
(order-preserving key bytes, rowid) plus an unsorted delta buffer merged
on threshold. Lookups binary-search the run (numpy searchsorted on object
arrays / bisect) and linear-scan the delta. MVCC note: entries may
reference invisible row versions — every probe re-verifies visibility at
the table, so no index undo is needed on rollback.

Vector (HNSW) table indexes wrap models.hnsw.HnswIndex with rowid↔slot
maps (reference PersistentHnswIndex.row_id_map, hnsw/mod.rs:767-859).
The vector indexes are the port's IvfIndex and HnswIndex on `device` (the
card unless the caller asks for the CPU); an error of theirs (a width no
kernel holds raises ValueError on the card) reaches the caller as it is.
"""

from __future__ import annotations

import bisect

import numpy as np

from turdb_tpu_torch.models.hnsw import HnswIndex
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.records.keys import encode_key

_MERGE_THRESHOLD = 2048


class SortedKeyIndex:
    """Size-tiered sorted runs (LSM-style): the delta buffer flushes into
    a fresh sorted run; adjacent runs compact when the newer one reaches
    half the elder's size. Amortized O(log n) merge work per insert —
    the round-1 single-run design re-sorted the WHOLE index every 2,048
    inserts (quadratic-ish at millions of rows). Probes bisect each of
    the O(log n) runs."""

    def __init__(self, name: str, columns: list[str], unique: bool = False):
        self.name = name
        self.columns = columns
        self.unique = unique
        self._runs: list[list[tuple[bytes, int]]] = []  # each sorted
        self._delta: list[tuple[bytes, int]] = []
        # hash over the delta: probes were a LINEAR delta scan, ~25% of
        # the per-row prepared-insert cost (unique checks probe per row)
        self._delta_by_key: dict[bytes, list[int]] = {}
        self._deleted: set[tuple[bytes, int]] = set()
        # unique indexes keep an O(1) whole-index entry count per key:
        # the prepared-insert fast lane's per-row conflict probe was ~4µs
        # of run bisects; a dict membership test is ~0.1µs. Conservative
        # by construction — any hit bails to the generic path, which
        # re-verifies against MVCC visibility.
        self._count: dict[bytes, int] | None = {} if unique else None
        # clean-single map: key -> rowid while exactly ONE live entry
        # carries the key (the common state of a PK/unique index). Point
        # reads become one dict get, independent of run count; any
        # ambiguity (dup versions, delete of a multi) drops the key and
        # find() falls back to the full probe.
        self._single: dict[bytes, int] | None = {} if unique else None

    def make_key(self, values) -> bytes:
        return encode_key(list(values))

    def clear(self):
        self._runs, self._delta, self._deleted = [], [], set()
        self._delta_by_key = {}
        if self._count is not None:
            self._count = {}
            self._single = {}

    def insert(self, key: bytes, rowid: int):
        if self._deleted:
            self._deleted.discard((key, rowid))
        delta = self._delta
        delta.append((key, rowid))
        # int-or-list delta map: the common case (fresh key) stores the
        # bare rowid — no per-key list allocation on the insert hot lane
        dbk = self._delta_by_key
        cur = dbk.get(key)
        if cur is None:
            dbk[key] = rowid
        elif type(cur) is int:
            dbk[key] = [cur, rowid]
        else:
            cur.append(rowid)
        c = self._count
        if c is not None:
            n = c.get(key, 0) + 1
            c[key] = n
            if n == 1:
                self._single[key] = rowid
            elif n == 2:
                self._single.pop(key, None)
        if len(delta) >= _MERGE_THRESHOLD:
            self._flush()

    def delete(self, key: bytes, rowid: int):
        if (key, rowid) not in self._deleted:   # idempotent decrement
            c = self._count
            if c is not None:
                left = c.get(key, 0) - 1
                if left > 0:
                    c[key] = left
                else:
                    c.pop(key, None)
                # a delete leaves the remaining rowid (if any) unknown:
                # drop the clean-single entry; find() falls back to scan
                self._single.pop(key, None)
        self._deleted.add((key, rowid))

    def probe_hit(self, key: bytes) -> bool:
        """O(1) 'any entry with this key?' for unique-conflict checks.
        May overcount transiently (duplicate (key, rowid) re-inserts);
        callers treat a hit as 'maybe' and re-verify."""
        if self._count is not None:
            return key in self._count
        return bool(self.find(key))

    def _flush(self):
        dead = self._deleted
        delta = self._delta
        if delta:
            # timsort: an already-ordered delta (serial PKs, timestamps —
            # the dominant OLTP key shape) is a single O(k) ascending-run
            # scan. Exact (key, rowid) duplicates are left in place under
            # the same contract as cross-run duplicates (probes dedup).
            delta.sort()
            if dead:
                delta = [e for e in delta if e not in dead]
            runs = self._runs
            if runs and delta and runs[-1] and runs[-1][-1] <= delta[0]:
                # in-order append: monotone keys extend the elder run in
                # place, O(k) per flush — the tiered merge cascade made
                # serial-PK inserts O(n·log n) tuple copies with ~10ms
                # stalls every threshold (profiled: 44% of a 100k-row
                # prepared-insert run was merge stalls)
                runs[-1].extend(delta)
            elif delta:
                runs.append(delta)
            self._delta = []
            self._delta_by_key = {}
        # size-tiered compaction; every merge drops tombstoned entries
        # (round-2 weak #9: purge only happened when everything compacted
        # into ONE run, so delete-heavy workloads scanned an ever-growing
        # tombstone set on every probe)
        while (
            len(self._runs) >= 2
            and 2 * len(self._runs[-1]) >= len(self._runs[-2])
        ):
            b = self._runs.pop()
            a = self._runs.pop()
            self._runs.append(self._merge_two(a, b, dead))
        self._gc_tombstones()

    @staticmethod
    def _merge_two(a, b, dead=frozenset()):
        # concat + timsort: timsort detects the two pre-sorted runs and
        # galloping-merges them (~6x faster than the per-element
        # heapq.merge generator at 100k entries, measured). Duplicate
        # (key, rowid) recurrences are left in place — find()/range()
        # dedup rowids at probe time — so the common no-tombstone merge
        # has no per-element Python pass at all.
        out = a + b
        out.sort()
        if dead:
            out = [e for e in out if e not in dead]
        return out

    def _gc_tombstones(self):
        """Drop tombstones that no longer shadow any stored entry (after
        merges purged the entries themselves). Threshold-gated: cost is
        O(T · runs · log n) bisects."""
        if len(self._deleted) < 1024:
            return
        still = set()
        for t in self._deleted:
            for run in self._runs:
                lo = bisect.bisect_left(run, t)
                if lo < len(run) and run[lo] == t:
                    still.add(t)
                    break
        self._deleted = still

    def find(self, key: bytes) -> list[int]:
        """All rowids with exactly this key (deduplicated across runs)."""
        s = self._single
        if s is not None:
            r = s.get(key)
            if r is not None:
                return [r]   # clean-single: delete/dup always evicts
        out = []
        for run in self._runs:
            lo = bisect.bisect_left(run, (key, -(2**62)))
            while lo < len(run) and run[lo][0] == key:
                e = run[lo]
                if e not in self._deleted:
                    out.append(e[1])
                lo += 1
        cur = self._delta_by_key.get(key)
        if cur is not None:
            for r in (cur,) if type(cur) is int else cur:
                if (key, r) not in self._deleted:
                    out.append(r)
        if len(out) < 2:
            return out          # point-read hot path: nothing to dedup
        return list(dict.fromkeys(out))

    def bulk_load(self, keys: list, rowids) -> None:
        """Replace the whole index with ONE sorted run (the reindex
        path): one sort beats per-row delta inserts + tiered merges."""
        self._runs = [sorted(zip(keys, (int(r) for r in rowids)))]
        self._delta = []
        self._delta_by_key = {}
        self._deleted = set()
        if self._count is not None:
            c: dict[bytes, int] = {}
            for k in keys:
                c[k] = c.get(k, 0) + 1
            self._count = c
            self._single = {
                k: r for k, r in self._runs[0] if c[k] == 1
            }

    def key_set(self) -> set:
        """All live key byte-strings (bulk unique probes: one O(K) set
        build + O(1) membership beats per-row run bisects)."""
        out: set = set()
        dead = self._deleted
        for run in self._runs:
            if dead:
                out.update(k for k, r in run if (k, r) not in dead)
            else:
                out.update(k for k, _ in run)
        out.update(k for k, r in self._delta if (k, r) not in dead)
        return out

    def range(self, lo_key: bytes | None, hi_key: bytes | None,
              lo_inc=True, hi_inc=True) -> list[int]:
        """Candidate rowids in [lo, hi] (order not guaranteed — callers
        re-apply the full WHERE on the candidate batch)."""
        self._flush()
        out: list[int] = []
        dead = self._deleted
        for run in self._runs:
            lo = 0
            if lo_key is not None:
                lo = bisect.bisect_left(run, (lo_key, -(2**62))) if lo_inc \
                    else bisect.bisect_right(run, (lo_key, 2**62))
            hi = len(run)
            if hi_key is not None:
                hi = bisect.bisect_right(run, (hi_key, 2**62)) if hi_inc \
                    else bisect.bisect_left(run, (hi_key, -(2**62)))
            if dead:
                out.extend(r for e in run[lo:hi]
                           if (r := e[1]) is not None and e not in dead)
            else:
                out.extend(r for _, r in run[lo:hi])
        return list(dict.fromkeys(out))

    def __len__(self):
        return (
            sum(len(r) for r in self._runs)
            + len(self._delta)
            - len(self._deleted)
        )


_METRIC_BY_OP = {"<->": Metric.L2, "<#>": Metric.IP, "<=>": Metric.COSINE}


class _SlotMap:
    """Incremental slot<->rowid mapping as numpy arrays, so the ANN SQL
    path builds its MVCC visibility mask with VECTORIZED ops (np.isin)
    instead of a per-rowid Python loop — the round-1 O(N)-per-query
    bottleneck. `_slot_rowids[s]` is the rowid whose vector lives in slot
    s (-1 once deleted); `_slot_current[s]` says the rowid's CURRENT
    mapping still points at s (False for stale vectors after an update —
    append-only doctrine, reference hnsw/mod.rs row_id_map :767-859)."""

    def _init_slots(self):
        self.rowid_to_slot: dict[int, int] = {}
        self._slot_rowids = np.full(256, -1, np.int64)
        self._slot_current = np.zeros(256, bool)

    def _slots_ensure(self, need: int):
        cap = len(self._slot_rowids)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        sr = np.full(cap, -1, np.int64)
        sr[: len(self._slot_rowids)] = self._slot_rowids
        sc = np.zeros(cap, bool)
        sc[: len(self._slot_current)] = self._slot_current
        self._slot_rowids, self._slot_current = sr, sc

    def _slot_assign(self, rowid: int, slot: int):
        old = self.rowid_to_slot.get(rowid)
        if old is not None and old < len(self._slot_current):
            self._slot_current[old] = False
        self._slots_ensure(slot + 1)
        self._slot_rowids[slot] = rowid
        self._slot_current[slot] = True
        self.rowid_to_slot[rowid] = slot

    def _slot_unassign(self, rowid: int) -> int | None:
        slot = self.rowid_to_slot.pop(rowid, None)
        if slot is not None and slot < len(self._slot_rowids):
            self._slot_rowids[slot] = -1
            self._slot_current[slot] = False
        return slot

    def _rebuild_slot_arrays(self):
        """After snapshot load populated rowid_to_slot directly."""
        if not self.rowid_to_slot:
            return
        self._slots_ensure(max(self.rowid_to_slot.values()) + 1)
        for r, s in self.rowid_to_slot.items():
            self._slot_rowids[s] = r
            self._slot_current[s] = True

    def _allowed_mask(self, allowed_rowids) -> np.ndarray:
        """Bool mask over slots: current mapping AND rowid visible."""
        size = max(self.index.size, 1)
        if isinstance(allowed_rowids, np.ndarray):
            ar = allowed_rowids.astype(np.int64, copy=False)
        else:
            ar = np.fromiter(allowed_rowids, np.int64, len(allowed_rowids))
        allowed = np.zeros(size, bool)
        m = min(size, len(self._slot_rowids))
        allowed[:m] = self._slot_current[:m] & np.isin(
            self._slot_rowids[:m], ar
        )
        return allowed

    def _slots_to_rowids(self, slots: np.ndarray) -> np.ndarray:
        s = np.asarray(slots, np.int64)
        safe = np.clip(s, 0, len(self._slot_rowids) - 1)
        out = self._slot_rowids[safe]
        return np.where(s >= 0, out, -1)

    # dict view kept for persistence/tests (reference row_id_map analog)
    @property
    def slot_to_rowid(self) -> dict:
        return {
            int(s): int(r)
            for s, r in enumerate(self._slot_rowids[: self.index.size])
            if r >= 0
        }


class IvfTableIndex(_SlotMap):
    """IVF-Flat index over one VECTOR column — same maintenance surface as
    HnswTableIndex (append-only; MVCC via the allowed mask) but backed by
    the clustered block-contiguous engine (models/ivf.py), which is the
    throughput path."""

    using = "IVF"

    def __init__(self, name: str, column: str, dim: int,
                 metric: Metric = Metric.L2, n_clusters: int | None = None,
                 nprobe: int = 8, sq8: bool = False, rerank: int | None = None,
                 compact: bool = False, *, device="cuda"):
        self.name = name
        self.column = column
        self.metric = metric
        self.index = IvfIndex(
            dim=dim, metric=metric, n_clusters=n_clusters,
            nprobe=nprobe, sq8=sq8 or compact, rerank=rerank,
            keep_f32=not compact, device=device,
        )
        self._init_slots()
        self._pending_vecs: list = []
        self._pending_rowids: list = []

    def insert(self, rowid: int, vec: np.ndarray, defer: bool = False,
               txn=None):
        old = self.rowid_to_slot.get(rowid)
        if txn is not None and old is not None:
            txn.undo.append((self, "hnsw_remap", rowid, old))
        self._pending_vecs.append(np.asarray(vec, np.float32))
        self._pending_rowids.append(rowid)
        if not defer:
            self.flush_pending()

    def flush_pending(self):
        if not self._pending_vecs:
            return
        vecs = np.stack(self._pending_vecs)
        rids = list(self._pending_rowids)
        self._pending_vecs = []
        self._pending_rowids = []
        slots = self.index.add(vecs)
        for r, s in zip(rids, slots):
            self._slot_assign(r, int(s))

    _undo_one = None  # assigned below (shared with HnswTableIndex)

    def delete(self, rowid: int):
        slot = self._slot_unassign(rowid)
        if slot is not None:
            self.index.delete([slot])

    def dead_fraction(self, live_rowids) -> float:
        """Fraction of occupied slots whose rowid is not live (DELETE
        tombstones + UPDATE remap leftovers) — the VACUUM rebuild gate."""
        self.flush_pending()
        n = self.index.size
        if n == 0:
            return 0.0
        self._slots_ensure(n)
        cur = self._slot_current[:n] & np.isin(
            self._slot_rowids[:n], np.asarray(live_rowids, np.int64)
        )
        return 1.0 - int(cur.sum()) / n

    def search(self, query: np.ndarray, k: int, ef: int | None = None,
               allowed_rowids=None):
        """(dists, rowids); `ef` maps to nprobe scaling for API parity."""
        self.flush_pending()
        allowed = (
            self._allowed_mask(allowed_rowids)
            if allowed_rowids is not None else None
        )
        nprobe = None
        if ef is not None:
            nprobe = max(self.index.nprobe, ef // 8)
        d, slots = self.index.search(
            np.asarray(query, np.float32)[None], k=k, nprobe=nprobe,
            allowed=allowed,
        )
        return d[0], self._slots_to_rowids(np.asarray(slots[0]))


class HnswTableIndex(_SlotMap):
    """HNSW index over one VECTOR column of a table."""

    def __init__(self, name: str, column: str, dim: int,
                 metric: Metric = Metric.L2, m: int = 16,
                 ef_construction: int = 100, ef_search: int = 64,
                 sq8: bool = False, qbits: int = 8, *, device="cuda"):
        self.name = name
        self.column = column
        self.metric = metric
        self.sq8 = sq8
        self.qbits = qbits
        self.index = HnswIndex(
            dim=dim, metric=metric, m=m,
            ef_construction=ef_construction, ef_search=ef_search,
            device=device,
        )
        self._init_slots()
        self._pending_vecs: list = []
        self._pending_rowids: list = []

    def insert(self, rowid: int, vec: np.ndarray, defer: bool = False,
               txn=None):
        """Append-only graph insertion. A previous vector for the same
        rowid stays in the graph but becomes unreachable once the mapping
        moves (search masks by CURRENT mapping). With `txn`, the mapping
        swap registers an undo hook so rollback restores the old vector."""
        old = self.rowid_to_slot.get(rowid)
        if txn is not None and old is not None:
            txn.undo.append((self, "hnsw_remap", rowid, old))
        if defer:
            self._pending_vecs.append(np.asarray(vec, np.float32))
            self._pending_rowids.append(rowid)
            return
        (slot,) = self.index.add(
            np.asarray(vec, np.float32)[None], row_ids=np.asarray([rowid], np.uint64)
        )
        self._slot_assign(rowid, int(slot))

    def _undo_one(self, kind: str, rowid: int, prev_slot, txn):
        """Transaction-undo hook (same protocol as ColumnarTable._undo_one):
        restore the rowid→slot mapping and drop any pending re-insert."""
        if kind != "hnsw_remap":
            return
        for j in range(len(self._pending_rowids) - 1, -1, -1):
            if self._pending_rowids[j] == rowid:
                self._pending_rowids.pop(j)
                self._pending_vecs.pop(j)
        cur = self.rowid_to_slot.get(rowid)
        if cur is not None and cur != prev_slot and cur < len(self._slot_rowids):
            self._slot_rowids[cur] = -1
            self._slot_current[cur] = False
        self._slot_assign(rowid, prev_slot)

    def flush_pending(self):
        if not self._pending_vecs:
            if self.sq8:
                self.index._quantize(self.qbits)
            return
        vecs = np.stack(self._pending_vecs)
        rids = np.asarray(self._pending_rowids, np.uint64)
        slots = self.index.add(vecs, row_ids=rids)
        for r, s in zip(self._pending_rowids, slots):
            self._slot_assign(r, int(s))
        self._pending_vecs = []
        self._pending_rowids = []
        if self.sq8:
            # serving-time quantization (reference quantization.rs): adds
            # above transparently dequantized; re-quantize after the flush
            self.index._quantize(self.qbits)

    def delete(self, rowid: int):
        slot = self._slot_unassign(rowid)
        if slot is not None:
            self.index.delete([slot])

    def vacuum(self, live_rowids=None, min_dead_frac: float = 0.25) -> bool:
        """Compact the graph to live rows (reference VacuumQueue,
        hnsw/mod.rs:726-765). DML keeps the graph APPEND-ONLY (deleted
        rowids are masked by visibility at search time, dml.py
        _index_delete); compaction happens here: slots whose rowid is
        not in `live_rowids` (the table's visible set) — plus UPDATE
        remap leftovers — stop acting as stepping stones and their slots
        are reclaimed. No-op until the dead fraction clears
        `min_dead_frac` (a rebuild is the columnar analog of the
        reference's deferred batch unlink — don't pay it for a few
        tombstones). Returns True when a compaction ran."""
        self.flush_pending()
        n = self.index.size
        if n == 0:
            return False
        self._slots_ensure(n)
        cur = self._slot_current[:n].copy()
        if live_rowids is not None:
            cur &= np.isin(self._slot_rowids[:n],
                           np.asarray(live_rowids, np.int64))
        dead = n - int(cur.sum())
        if dead / n < min_dead_frac:
            return False
        self.index._alive[:n] = cur
        old_rowids = self._slot_rowids[:n].copy()
        mapping = self.index.vacuum(
            row_ids=np.where(old_rowids >= 0, old_rowids, 0).astype(np.uint64)
        )
        self._init_slots()
        for old_slot in np.flatnonzero(mapping >= 0):
            self._slot_assign(int(old_rowids[old_slot]),
                              int(mapping[old_slot]))
        if self.sq8:
            self.index._quantize(self.qbits)
        return True

    def pack(self) -> None:
        """Build the serving pack (PRAGMA ann_pack; models/hnsw_serve.py).
        Queries then take the packed two-stage fast path until the next
        graph mutation invalidates it."""
        self.flush_pending()
        self.index.pack_serving()

    def search(self, query: np.ndarray, k: int, ef: int | None = None,
               allowed_rowids=None):
        """Returns (dists, rowids). `allowed_rowids` (array or set):
        restrict results (MVCC visibility — search_filtered semantics,
        reference hnsw/mod.rs:1176: invisible nodes traversed, excluded).
        Uses the serving pack when one is valid (PRAGMA ann_pack)."""
        self.flush_pending()
        allowed = (
            self._allowed_mask(allowed_rowids)
            if allowed_rowids is not None else None
        )
        q = np.asarray(query, np.float32)[None]
        if self.index.serve is not None:
            d, slots = self.index.search_serve(q, k=k, ef=ef, allowed=allowed)
        else:
            d, slots = self.index.search(q, k=k, ef=ef, allowed=allowed)
        return d[0], self._slots_to_rowids(np.asarray(slots[0]))


# IVF shares the remap-undo protocol with HNSW (append-only doctrine)
IvfTableIndex._undo_one = HnswTableIndex._undo_one
