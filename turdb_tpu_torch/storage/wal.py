"""Segmented write-ahead log with CRC64-framed logical records.

Keeps the reference WAL's durability contracts (reference
src/storage/wal.rs: 64MB segments `wal/wal.000001`…, 32-byte frame
headers, CRC64-ECMA per frame :148, torn-write detection :239-266,
checkpoint-then-truncate :50-60, SyncMode Off/Normal/Full :109) while
changing WHAT is logged: the reference logs 16KB page images; a columnar
engine logs LOGICAL mutations (txn begin/commit/abort, row images, DDL),
which replay deterministically into column arrays and keep frames small.

Frame header (32 bytes, little-endian):
    u32 payload_len | u8 type | u8 flags | u16 table_id
    u64 lsn | u64 txn_id | u64 crc64(header[0:24] + payload)

Group commit (reference database/group_commit.rs): appends buffer in
memory; `flush()` writes + fsyncs the whole batch once.
"""

from __future__ import annotations

import enum
import os
import struct
import threading

from turdb_tpu_torch.config import (
    FILE_HEADER_SIZE,
    MAGIC_WAL,
    WAL_FRAME_HEADER_SIZE,
    WAL_SEGMENT_SIZE,
)
from turdb_tpu_torch.native.build import crc64

# synchronous=OFF write coalescing: statements buffer frames in-process
# up to this many bytes before one write() hands them to the OS
_OFF_FLUSH_BYTES = 256 * 1024


class SyncMode(enum.Enum):
    OFF = "off"        # no fsync (fastest, crash may lose recent commits)
    NORMAL = "normal"  # fsync on checkpoint
    FULL = "full"      # fsync on every flush


class FrameType(enum.IntEnum):
    BEGIN = 1
    COMMIT = 2
    ABORT = 3
    INSERT = 4
    DELETE = 5
    UPDATE = 6
    DDL = 7
    CHECKPOINT = 8
    BULK_INSERT = 9  # columnar payload: npz of arrays + null masks + rowids
    TOAST = 10       # out-of-line chunks: 17B pointer + raw value bytes
    SPABORT = 11     # ROLLBACK TO savepoint: payload = u64 count of this
                     # txn's preceding logical frames to drop at replay


class WalCorruption(Exception):
    pass


_NOLTP = None


def _native_oltp():
    global _NOLTP
    if _NOLTP is None:
        from turdb_tpu_torch.native.build import oltp

        _NOLTP = oltp() or False
    return _NOLTP if _NOLTP else None


class Wal:
    def __init__(self, wal_dir: str, sync_mode: SyncMode = SyncMode.NORMAL):
        self.dir = wal_dir
        self.sync_mode = sync_mode
        os.makedirs(wal_dir, exist_ok=True)
        self._buffer: list[bytes] = []
        self._buffered = 0   # bytes pending in _buffer
        # group commit (reference group_commit.rs:8-30): concurrent
        # committers at synchronous=FULL share one fsync. written_upto /
        # durable_upto are LSN watermarks: frames below written_upto are
        # in the OS (write() issued), below durable_upto are fsynced.
        self.written_upto = 0
        self.durable_upto = 0
        self._gc_cond = threading.Condition()
        self._gc_leaders = 0
        self._gc_maxreq = 0   # highest watermark any committer asked for
        self._fh = None
        self._segment_no = 0
        self._segment_size = 0
        self.next_lsn = 1
        self.frame_count = 0
        # logical frames appended per open txn (savepoint SPABORT marks)
        self._txn_counts: dict[int, int] = {}
        self._torn: tuple[int, int] | None = None  # (segment_no, valid_end)
        segs = self._segments()
        if segs:
            # scan existing frames to restore next_lsn/frame_count
            for _ in self.replay():
                pass
            if self._torn is not None:
                # Torn tail: truncate the segment at the last valid frame
                # boundary and drop any later (unreachable) segments, so
                # new frames are appended where replay WILL reach them
                # (reference wal.rs torn-write handling :239-266).
                torn_no, valid_end = self._torn
                if valid_end < FILE_HEADER_SIZE:
                    # header itself torn: drop the whole segment (leaving a
                    # headerless stub would hide frames appended later)
                    os.remove(self._seg_path(torn_no))
                else:
                    with open(self._seg_path(torn_no), "r+b") as f:
                        f.truncate(valid_end)
                for no, path in self._segments():
                    if no > torn_no:
                        os.remove(path)
                self._torn = None
            remaining = self._segments()
            self._open_segment(remaining[-1][0] if remaining else 1)
        else:
            self._open_segment(1)

    # -- segments ---------------------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("wal."):
                try:
                    out.append((int(name.split(".")[1]), os.path.join(self.dir, name)))
                except ValueError:
                    continue
        return sorted(out)

    def _seg_path(self, no: int) -> str:
        return os.path.join(self.dir, f"wal.{no:06d}")

    def _open_segment(self, no: int):
        if self._fh:
            if self.sync_mode is SyncMode.FULL:
                # a group-commit leader may hold this fd: make the old
                # segment durable before closing so its fsync-retry on
                # the fresh fd can't leave old frames un-synced
                os.fsync(self._fh.fileno())
            self._fh.close()
        self._segment_no = no
        path = self._seg_path(no)
        fresh = not os.path.exists(path)
        self._fh = open(path, "ab")
        if fresh:
            hdr = bytearray(FILE_HEADER_SIZE)
            hdr[:16] = MAGIC_WAL
            struct.pack_into("<IQ", hdr, 16, 1, no)  # version, segment no
            self._fh.write(bytes(hdr))
            self._fh.flush()
        self._segment_size = self._fh.tell()

    # -- append / flush ----------------------------------------------------

    def append(
        self,
        ftype: FrameType,
        payload: bytes = b"",
        txn_id: int = 0,
        table_id: int = 0,
    ) -> int:
        lsn = self.next_lsn
        self.next_lsn += 1
        if ftype in (FrameType.INSERT, FrameType.DELETE, FrameType.UPDATE,
                     FrameType.DDL, FrameType.BULK_INSERT, FrameType.TOAST):
            self._txn_counts[txn_id] = self._txn_counts.get(txn_id, 0) + 1
        elif ftype in (FrameType.COMMIT, FrameType.ABORT):
            self._txn_counts.pop(txn_id, None)
        n = _native_oltp()
        if n is not None:
            frame = n.wal_frame(int(ftype), table_id, lsn, txn_id,
                                bytes(payload))
        else:
            head = bytearray(WAL_FRAME_HEADER_SIZE)
            struct.pack_into(
                "<IBBHQQ", head, 0, len(payload), int(ftype), 0, table_id,
                lsn, txn_id,
            )
            crc = crc64(bytes(head[:24]) + payload)
            struct.pack_into("<Q", head, 24, crc)
            frame = bytes(head) + payload
        self._buffer.append(frame)
        self._buffered += len(frame)
        self.frame_count += 1
        return lsn

    def txn_frames(self, txn_id: int) -> int:
        return self._txn_counts.get(txn_id, 0)

    def set_txn_frames(self, txn_id: int, n: int):
        self._txn_counts[txn_id] = n

    def flush(self, force: bool = False):
        """Group-commit flush: one write + (per sync mode) one fsync for
        everything buffered since the last flush.

        At synchronous=OFF the per-statement flush is size-gated: frames
        accumulate in-process until ~256KB, then one write() hands them
        to the OS (sync OFF promises no crash durability, so deferring
        the syscall loses nothing — it was ~40% of the prepared-insert
        hot path). force=True (checkpoint/close — anything that reads
        segments back or ends the process) always writes.

        At synchronous=FULL the statement-path flush (force=False) is
        WRITE-ONLY: the fsync is deferred to commit_durable(), which the
        statement entry points call AFTER releasing the statement lock,
        so concurrent committers share one fsync (group commit,
        reference group_commit.rs:8-30). force=True keeps the inline
        fsync — checkpoint/close must be durable before returning."""
        if not self._buffer:
            return
        if (not force and self.sync_mode is SyncMode.OFF
                and self._buffered < _OFF_FLUSH_BYTES):
            return
        blob = b"".join(self._buffer)
        self._buffer.clear()
        self._buffered = 0
        if self._segment_size + len(blob) > WAL_SEGMENT_SIZE:
            self._open_segment(self._segment_no + 1)
        self._fh.write(blob)
        self._fh.flush()
        self._segment_size += len(blob)
        self.written_upto = self.next_lsn - 1
        if force and self.sync_mode is SyncMode.FULL:
            os.fsync(self._fh.fileno())
            self.durable_upto = self.written_upto

    def commit_durable(self, upto: int | None = None):
        """Group commit (reference group_commit.rs): block until every
        frame written so far (default) or up to `upto` is fsync-durable.
        Called OUTSIDE the statement lock after flush() wrote the
        caller's frames; one leader fsyncs for every waiter that arrived
        while the fsync was in flight."""
        if upto is None:
            upto = self.written_upto
        cv = self._gc_cond
        cv.acquire()
        try:
            while self.durable_upto < upto:
                if self._gc_leaders:
                    cv.wait(1.0)
                    continue
                self._gc_leaders = 1
                target = self.written_upto
                fh = self._fh
                cv.release()
                err = None
                try:
                    try:
                        if fh is not None:
                            os.fsync(fh.fileno())
                    except (OSError, ValueError):
                        # segment rotated/closed under us: rotation
                        # fsyncs the old segment at FULL before closing;
                        # sync the live fd for anything newer
                        fh2 = self._fh
                        if fh2 is not None and fh2 is not fh:
                            os.fsync(fh2.fileno())
                        elif fh2 is not None:
                            raise
                except BaseException as e:
                    err = e
                cv.acquire()
                self._gc_leaders = 0
                if err is None and target > self.durable_upto:
                    self.durable_upto = target
                cv.notify_all()
                if err is not None:
                    raise err
        finally:
            cv.release()

    # -- replay ------------------------------------------------------------

    def replay(self):
        """Yield (lsn, FrameType, txn_id, table_id, payload) for every
        valid frame across segments, in order. Stops cleanly at the first
        torn/corrupt frame (per-frame CRC, reference wal.rs:239-266).

        next_lsn/frame_count are restored even when replay stops early —
        otherwise a post-recovery commit would reuse LSNs of frames that
        were already replayed. A torn tail is recorded in self._torn as
        (segment_no, last_valid_frame_boundary) for truncation."""
        max_lsn = self.next_lsn - 1
        count = 0
        try:
            for no, path in self._segments():
                with open(path, "rb") as f:
                    data = f.read()
                off = FILE_HEADER_SIZE
                if len(data) < FILE_HEADER_SIZE or data[:16] != MAGIC_WAL:
                    # torn/overwritten segment header: recovery stops at
                    # the previous segment's frames — a clean PREFIX, not
                    # a refused open (found by tests/test_crash_fuzz.py:
                    # raising here made the whole database unopenable)
                    self._torn = (no, 0)
                    return
                while off + WAL_FRAME_HEADER_SIZE <= len(data):
                    plen, ftype, _flags, table_id, lsn, txn_id = struct.unpack_from(
                        "<IBBHQQ", data, off
                    )
                    crc_stored = struct.unpack_from("<Q", data, off + 24)[0]
                    end = off + WAL_FRAME_HEADER_SIZE + plen
                    if end > len(data):
                        self._torn = (no, off)  # torn tail
                        return
                    payload = data[off + WAL_FRAME_HEADER_SIZE : end]
                    crc_calc = crc64(data[off : off + 24] + payload)
                    if crc_calc != crc_stored:
                        self._torn = (no, off)  # torn/corrupt frame
                        return
                    try:
                        ft = FrameType(ftype)
                    except ValueError:
                        self._torn = (no, off)
                        return
                    max_lsn = max(max_lsn, lsn)
                    count += 1
                    yield lsn, ft, txn_id, table_id, payload
                    off = end
                if off != len(data):
                    self._torn = (no, off)  # partial frame header at tail
                    return
        finally:
            self.next_lsn = max(self.next_lsn, max_lsn + 1)
            self.frame_count = max(self.frame_count, count)

    # -- checkpoint --------------------------------------------------------

    def truncate(self):
        """Checkpoint completion: all data is in snapshot files; drop every
        segment and start fresh (reference checkpoint replay-then-truncate,
        wal.rs:50-60)."""
        if self._fh:
            self._fh.close()
            self._fh = None
        # the checkpoint rewrite re-appends surviving active-txn frames,
        # which rebuilds these counts; without the reset they'd double
        self._txn_counts.clear()
        for _, path in self._segments():
            os.remove(path)
        self._buffer.clear()
        self._buffered = 0
        self.frame_count = 0
        self._open_segment(1)
        if self.sync_mode is not SyncMode.OFF:
            os.fsync(self._fh.fileno())

    def close(self):
        self.flush(force=True)
        if self._fh:
            if self.sync_mode is not SyncMode.OFF:
                os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None

    @property
    def size_bytes(self) -> int:
        return sum(os.path.getsize(p) for _, p in self._segments())
