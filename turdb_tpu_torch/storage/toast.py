"""TOAST: out-of-line storage for oversized values.

Counterpart of reference src/storage/toast.rs (:70-80: threshold 1000B,
4000B chunks, tagged pointer) + src/database/toast.rs (chunks in hidden
tables). In the columnar engine, oversized TEXT/BLOB values live happily
in object arrays, so TOAST applies at the SERIALIZATION boundary: WAL row
images and snapshot buffers swap values above the threshold for pointers
into a chunk store, keeping frames small and checksums cheap.

Pointer format (17 bytes, 0xFE marker first — same shape as the
reference's ToastPointer): marker u8 | toast_id u64 | total_len u32 |
n_chunks u32.
"""

from __future__ import annotations

import struct

from turdb_tpu_torch.config import TOAST_CHUNK_SIZE, TOAST_THRESHOLD

MARKER = 0xFE
POINTER_LEN = 17


class ToastStore:
    """Chunk store: toast_id -> ordered chunks. The Database hosts one per
    table (the hidden `_toast` table analog); snapshots persist it via the
    object-column path."""

    def __init__(self):
        self.chunks: dict[int, list[bytes]] = {}
        self.next_id = 1

    def toast(self, value: bytes) -> bytes:
        """Store an oversized value; returns the 17-byte pointer."""
        tid = self.next_id
        self.next_id += 1
        parts = [
            value[i : i + TOAST_CHUNK_SIZE]
            for i in range(0, len(value), TOAST_CHUNK_SIZE)
        ]
        self.chunks[tid] = parts
        return struct.pack("<BQII", MARKER, tid, len(value), len(parts))

    def detoast(self, pointer: bytes) -> bytes:
        marker, tid, total, n = struct.unpack("<BQII", pointer)
        if marker != MARKER:
            raise ValueError("not a toast pointer")
        parts = self.chunks.get(tid)
        if parts is None or len(parts) != n:
            raise KeyError(f"missing toast chunks for id {tid}")
        out = b"".join(parts)
        if len(out) != total:
            raise ValueError("toast length mismatch")
        return out

    def delete(self, pointer: bytes):
        _, tid, _, _ = struct.unpack("<BQII", pointer)
        self.chunks.pop(tid, None)


class Toasted:
    """In-column stand-in for a toasted value: the 17-byte pointer plus
    the owning store (reference Detoaster trait, toast.rs:75). `text`
    marks utf-8 payloads (TEXT columns) vs raw bytes (BLOB)."""

    __slots__ = ("pointer", "store", "text")

    def __init__(self, pointer: bytes, store: "ToastStore | None",
                 text: bool):
        self.pointer = pointer
        self.store = store
        self.text = text

    @property
    def tid(self) -> int:
        return struct.unpack_from("<Q", self.pointer, 1)[0]

    def resolve(self):
        raw = self.store.detoast(self.pointer)
        return raw.decode("utf-8") if self.text else raw

    def __repr__(self):
        _, tid, total, n = struct.unpack("<BQII", self.pointer)
        return f"<Toasted id={tid} {total}B/{n} chunks>"


def detoast_value(v):
    return v.resolve() if isinstance(v, Toasted) else v


def serialize_store(store: ToastStore) -> bytes:
    """Binary store image for table snapshots: u32 count, then per entry
    u64 tid | u32 total | u32 nparts | parts (u32 len + bytes each)."""
    out = [struct.pack("<IQ", len(store.chunks), store.next_id)]
    for tid, parts in store.chunks.items():
        total = sum(len(p) for p in parts)
        out.append(struct.pack("<QII", tid, total, len(parts)))
        for p in parts:
            out.append(struct.pack("<I", len(p)))
            out.append(p)
    return b"".join(out)


def deserialize_store(blob: bytes) -> ToastStore:
    store = ToastStore()
    count, next_id = struct.unpack_from("<IQ", blob, 0)
    off = 12
    for _ in range(count):
        tid, _total, nparts = struct.unpack_from("<QII", blob, off)
        off += 16
        parts = []
        for _ in range(nparts):
            (ln,) = struct.unpack_from("<I", blob, off)
            off += 4
            parts.append(blob[off : off + ln])
            off += ln
        store.chunks[tid] = parts
    store.next_id = max(next_id, 1)
    return store


def is_pointer(raw: bytes) -> bool:
    return len(raw) == POINTER_LEN and raw[0] == MARKER


def maybe_toast(store: ToastStore, value: bytes) -> bytes:
    """Swap values above the threshold for pointers (no-op below it)."""
    if len(value) > TOAST_THRESHOLD:
        return store.toast(value)
    return value


def maybe_detoast(store: ToastStore, raw: bytes) -> bytes:
    if is_pointer(raw):
        return store.detoast(raw)
    return raw
