"""Composite (row-valued) type format with O(1) field access.

Counterpart of reference src/records/composite.rs:85 (CompositeView):
composites reuse the record format's exact binary layout — header +
null bitmap + fixed region + offset table + payload — so nested
structures parse with the same O(1) machinery. Field names live in the
catalog, not the data (index-based access); nesting is depth-limited to
16 (composite.rs MAX_NESTING_DEPTH) so adversarial bytes can't recurse
unboundedly.
"""

from __future__ import annotations

import struct

from turdb_tpu_torch.records.record import RecordSchema, _FIXED, _var_bytes, _var_value
from turdb_tpu_torch.types.datatype import DataType, StorageClass

MAX_NESTING_DEPTH = 16


class CompositeSchema:
    """Field layout for one composite type. Fields are DataTypes or
    nested CompositeSchemas (stored var-width)."""

    def __init__(self, fields: list):
        self.fields = list(fields)
        if self._depth() > MAX_NESTING_DEPTH:
            raise ValueError(
                f"composite nesting exceeds {MAX_NESTING_DEPTH} levels"
            )
        # the wire layout is computed by the record machinery: nested
        # composites ride as var-width pseudo-BLOB fields
        self._rec = RecordSchema([
            DataType.BLOB if isinstance(f, CompositeSchema) else f
            for f in self.fields
        ])

    def _depth(self) -> int:
        d = 1
        for f in self.fields:
            if isinstance(f, CompositeSchema):
                d = max(d, 1 + f._depth())
        return d

    @property
    def n(self) -> int:
        return len(self.fields)


def pack_composite(schema: CompositeSchema, values) -> bytes:
    """Serialize one composite value (a sequence of fields; nested
    composites are nested sequences)."""
    if len(values) != schema.n:
        raise ValueError(f"want {schema.n} fields, got {len(values)}")
    flat = []
    for f, v in zip(schema.fields, values):
        if v is not None and isinstance(f, CompositeSchema):
            v = pack_composite(f, v)
        flat.append(v)
    return _pack(schema._rec, flat)


def _pack(rec: RecordSchema, values) -> bytes:
    # record.pack_record, minus the Toasted special-casing
    bitmap = bytearray(rec.bitmap_len)
    fixed = bytearray(rec.fixed_len)
    var_chunks: list[bytes] = [b""] * rec.nvar
    for i, (dt, v) in enumerate(zip(rec.dtypes, values)):
        if v is None:
            bitmap[i // 8] |= 1 << (i % 8)
            continue
        sc = dt.storage_class
        if sc in _FIXED:
            fmt, _ = _FIXED[sc]
            off = rec.fixed_off[i]
            if sc is StorageClass.BOOL:
                struct.pack_into(fmt, fixed, off, 1 if v else 0)
            elif sc is StorageClass.INT:
                struct.pack_into(fmt, fixed, off, int(v))
            else:
                struct.pack_into(fmt, fixed, off, float(v))
        else:
            var_chunks[rec.var_index[i]] = (
                bytes(v) if isinstance(v, (bytes, bytearray))
                else _var_bytes(dt, v)
            )
    offtab = bytearray(4 * (rec.nvar + 1))
    pos = 0
    for j, chunk in enumerate(var_chunks):
        struct.pack_into("<I", offtab, 4 * j, pos)
        pos += len(chunk)
    struct.pack_into("<I", offtab, 4 * rec.nvar, pos)
    return (
        struct.pack("<H", rec.n)
        + bytes(bitmap) + bytes(fixed) + bytes(offtab)
        + b"".join(var_chunks)
    )


class CompositeView:
    """O(1) index-based field reader over composite bytes.

    get(i) returns the decoded field; get_nested(i) returns a child
    CompositeView (depth-checked, composite.rs new_with_depth)."""

    def __init__(self, buf: bytes, schema: CompositeSchema, depth: int = 0):
        if depth >= MAX_NESTING_DEPTH:
            raise ValueError("composite nesting depth exceeded")
        if len(buf) < 2:
            raise ValueError("composite data too small")
        (n,) = struct.unpack_from("<H", buf, 0)
        if n != schema.n:
            raise ValueError(f"field count mismatch: data {n}, schema {schema.n}")
        self.buf = buf
        self.schema = schema
        self.depth = depth

    @property
    def field_count(self) -> int:
        return self.schema.n

    def is_null(self, i: int) -> bool:
        return bool(self.buf[2 + i // 8] & (1 << (i % 8)))

    def _raw_var(self, i: int) -> bytes:
        rec = self.schema._rec
        j = rec.var_index[i]
        base = rec.offtab_at
        start = struct.unpack_from("<I", self.buf, base + 4 * j)[0]
        end = struct.unpack_from("<I", self.buf, base + 4 * (j + 1))[0]
        return self.buf[rec.payload_at + start : rec.payload_at + end]

    def get(self, i: int):
        if self.is_null(i):
            return None
        f = self.schema.fields[i]
        if isinstance(f, CompositeSchema):
            return self.get_nested(i).to_tuple()
        rec = self.schema._rec
        dt = rec.dtypes[i]
        sc = dt.storage_class
        if sc in _FIXED:
            fmt, _ = _FIXED[sc]
            v = struct.unpack_from(fmt, self.buf, rec.header_len + rec.fixed_off[i])[0]
            return bool(v) if sc is StorageClass.BOOL else v
        return _var_value(dt, self._raw_var(i))

    def get_nested(self, i: int) -> "CompositeView":
        f = self.schema.fields[i]
        if not isinstance(f, CompositeSchema):
            raise TypeError(f"field {i} is not a composite")
        return CompositeView(self._raw_var(i), f, self.depth + 1)

    def to_tuple(self) -> tuple:
        return tuple(self.get(i) for i in range(self.field_count))


def unpack_composite(schema: CompositeSchema, buf: bytes) -> tuple:
    return CompositeView(buf, schema).to_tuple()
