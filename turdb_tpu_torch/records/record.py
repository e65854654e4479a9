"""Binary row format with O(1) column access.

Same access contract as reference src/records/mod.rs:8-22 (vs SQLite's
O(N) sequential parse): header + null bitmap + offset table for
variable-width columns + payload; fixed-width columns live at offsets
precomputed per schema (records/schema.rs:16). Layout is ours:

    [u16 ncols][null bitmap ceil(n/8)]
    [fixed region: 8B per fixed slot, schema order]
    [u32 offset table: one per var-width column + u32 end]
    [var payload]

Used for WAL row images, spill files and TOAST chunks; live table data is
columnar (numpy), see turdb_tpu_torch.storage.table.
"""

from __future__ import annotations

import struct

from turdb_tpu_torch.types.datatype import DataType, StorageClass

_FIXED = {
    StorageClass.INT: ("<q", 8),
    StorageClass.FLOAT: ("<d", 8),
    StorageClass.FLOAT32: ("<f", 4),
    StorageClass.BOOL: ("<b", 1),
}


class RecordSchema:
    """Precomputed layout for one table's row format."""

    def __init__(self, dtypes: list[DataType]):
        self.dtypes = list(dtypes)
        self.n = len(dtypes)
        self.bitmap_len = (self.n + 7) // 8
        self.fixed_off: list[int | None] = []
        self.var_index: list[int | None] = []
        off = 0
        nvar = 0
        for dt in self.dtypes:
            sc = dt.storage_class
            if sc in _FIXED:
                fmt, size = _FIXED[sc]
                self.fixed_off.append(off)
                self.var_index.append(None)
                off += size
            else:
                self.fixed_off.append(None)
                self.var_index.append(nvar)
                nvar += 1
        self.fixed_len = off
        self.nvar = nvar
        self.header_len = 2 + self.bitmap_len
        self.offtab_at = self.header_len + self.fixed_len
        self.payload_at = self.offtab_at + 4 * (nvar + 1)
        self._blob = None   # native/oltp.c pack_record schema (lazy)

    def schema_blob(self) -> bytes:
        """Native pack_record schema descriptor (see native/oltp.c)."""
        if self._blob is None:
            sc_code = {
                StorageClass.INT: 0, StorageClass.FLOAT: 1,
                StorageClass.FLOAT32: 2, StorageClass.BOOL: 3,
                StorageClass.TEXT: 4, StorageClass.BYTES: 5,
            }
            parts = [struct.pack(
                "<HHIH", self.n, self.bitmap_len, self.fixed_len, self.nvar
            )]
            for i, dt in enumerate(self.dtypes):
                parts.append(struct.pack(
                    "<BHh",
                    sc_code.get(dt.storage_class, 255),
                    self.fixed_off[i] or 0,
                    -1 if self.var_index[i] is None else self.var_index[i],
                ))
            self._blob = b"".join(parts)
        return self._blob


def _var_bytes(dt: DataType, v) -> bytes:
    sc = dt.storage_class
    if sc in (StorageClass.TEXT, StorageClass.BYTES):
        from turdb_tpu_torch.storage.toast import Toasted

        if isinstance(v, Toasted):
            # toasted values serialize as their 17-byte pointer
            # (reference toast.rs:70-80; chunks are logged separately)
            return v.pointer
    if sc is StorageClass.TEXT:
        return str(v).encode("utf-8")
    if sc is StorageClass.BYTES:
        return bytes(v)
    if sc is StorageClass.VECTOR:
        import numpy as np

        return np.asarray(v, np.float32).tobytes()
    if sc is StorageClass.OBJECT:
        from turdb_tpu_torch.records.jsonb import jsonb_encode

        return jsonb_encode(v)
    if sc is StorageClass.DECIMAL:
        return str(v).encode("ascii")   # Decimal str round-trips exactly
    raise TypeError(f"not a var-width class: {sc}")


def _var_value(dt: DataType, raw: bytes):
    sc = dt.storage_class
    if sc in (StorageClass.TEXT, StorageClass.BYTES):
        from turdb_tpu_torch.storage.toast import Toasted, is_pointer

        # 0xFE is never a valid utf-8 lead byte; BLOBs that would collide
        # are force-toasted at write time, so the marker is unambiguous
        if is_pointer(raw):
            return Toasted(bytes(raw), None, text=sc is StorageClass.TEXT)
    if sc is StorageClass.TEXT:
        return raw.decode("utf-8")
    if sc is StorageClass.BYTES:
        return raw
    if sc is StorageClass.VECTOR:
        import numpy as np

        return np.frombuffer(raw, np.float32).copy()
    if sc is StorageClass.OBJECT:
        from turdb_tpu_torch.records.jsonb import jsonb_decode

        return jsonb_decode(raw)
    if sc is StorageClass.DECIMAL:
        from decimal import Decimal

        return Decimal(raw.decode("ascii"))
    raise TypeError(f"not a var-width class: {sc}")


_NATIVE = None


def _native():
    global _NATIVE
    if _NATIVE is None:
        from turdb_tpu_torch.native.build import oltp

        _NATIVE = oltp() or False
    return _NATIVE


def pack_record(schema: RecordSchema, values) -> bytes:
    assert len(values) == schema.n
    n = _native()
    if n is not None and n is not False:
        out = n.pack_record(schema.schema_blob(), tuple(values))
        if out is not None:
            return out
    bitmap = bytearray(schema.bitmap_len)
    fixed = bytearray(schema.fixed_len)
    var_chunks: list[bytes] = [b""] * schema.nvar
    for i, (dt, v) in enumerate(zip(schema.dtypes, values)):
        if v is None:
            bitmap[i // 8] |= 1 << (i % 8)
            continue
        sc = dt.storage_class
        if sc in _FIXED:
            fmt, size = _FIXED[sc]
            off = schema.fixed_off[i]
            if sc is StorageClass.BOOL:
                struct.pack_into(fmt, fixed, off, 1 if v else 0)
            elif sc is StorageClass.INT:
                struct.pack_into(fmt, fixed, off, int(v))
            else:
                struct.pack_into(fmt, fixed, off, float(v))
        else:
            var_chunks[schema.var_index[i]] = _var_bytes(dt, v)

    offtab = bytearray(4 * (schema.nvar + 1))
    pos = 0
    for j, chunk in enumerate(var_chunks):
        struct.pack_into("<I", offtab, 4 * j, pos)
        pos += len(chunk)
    struct.pack_into("<I", offtab, 4 * schema.nvar, pos)
    return (
        struct.pack("<H", schema.n)
        + bytes(bitmap)
        + bytes(fixed)
        + bytes(offtab)
        + b"".join(var_chunks)
    )


def get_column(schema: RecordSchema, buf: bytes, i: int):
    """O(1) single-column access — the format's defining property."""
    if buf[2 + i // 8] & (1 << (i % 8)):
        return None
    dt = schema.dtypes[i]
    sc = dt.storage_class
    if sc in _FIXED:
        fmt, size = _FIXED[sc]
        v = struct.unpack_from(fmt, buf, schema.header_len + schema.fixed_off[i])[0]
        if sc is StorageClass.BOOL:
            return bool(v)
        return v
    j = schema.var_index[i]
    base = schema.offtab_at
    start = struct.unpack_from("<I", buf, base + 4 * j)[0]
    end = struct.unpack_from("<I", buf, base + 4 * (j + 1))[0]
    raw = buf[schema.payload_at + start : schema.payload_at + end]
    return _var_value(dt, raw)


def unpack_record(schema: RecordSchema, buf: bytes) -> list:
    return [get_column(schema, buf, i) for i in range(schema.n)]
