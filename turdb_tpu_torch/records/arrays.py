"""PostgreSQL-style 1-D array binary format with O(1) element access.

Counterpart of reference src/records/array.rs:5-99 (ArrayView: element
type tag, count, null bitmap, offset table for var-width elements,
payload — O(1) element access without parsing). Layout:

    [u8 elem_tag][varint n][null bitmap ceil(n/8)]
    fixed-width tag: payload = n * elem_size, element i at i*size
    var-width   tag: u32 offsets[n+1] + payload
"""

from __future__ import annotations

import struct

import numpy as np

from turdb_tpu_torch.records.varint import decode_varint, encode_varint

T_INT = 1      # <q 8B
T_FLOAT = 2    # <d 8B
T_BOOL = 3     # 1B
T_TEXT = 4     # var utf-8
T_BLOB = 5     # var bytes

_FIXED_SIZE = {T_INT: 8, T_FLOAT: 8, T_BOOL: 1}
_FMT = {T_INT: "<q", T_FLOAT: "<d", T_BOOL: "<b"}


def _infer_tag(values) -> int:
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return T_BOOL
        if isinstance(v, (int, np.integer)):
            return T_INT
        if isinstance(v, (float, np.floating)):
            return T_FLOAT
        if isinstance(v, str):
            return T_TEXT
        if isinstance(v, (bytes, bytearray)):
            return T_BLOB
        raise TypeError(f"unsupported array element {type(v)}")
    return T_INT


def array_encode(values, tag: int | None = None) -> bytes:
    values = list(values)
    n = len(values)
    if tag is None:
        tag = _infer_tag(values)
    bitmap = bytearray((n + 7) // 8)
    for i, v in enumerate(values):
        if v is None:
            bitmap[i // 8] |= 1 << (i % 8)
    head = bytes([tag]) + encode_varint(n) + bytes(bitmap)
    if tag in _FIXED_SIZE:
        fmt, size = _FMT[tag], _FIXED_SIZE[tag]
        payload = bytearray(n * size)
        for i, v in enumerate(values):
            if v is None:
                continue
            if tag == T_BOOL:
                struct.pack_into(fmt, payload, i * size, 1 if v else 0)
            elif tag == T_INT:
                struct.pack_into(fmt, payload, i * size, int(v))
            else:
                struct.pack_into(fmt, payload, i * size, float(v))
        return head + bytes(payload)
    chunks = []
    offs = [0]
    for v in values:
        raw = b"" if v is None else (
            v.encode("utf-8") if isinstance(v, str) else bytes(v)
        )
        chunks.append(raw)
        offs.append(offs[-1] + len(raw))
    tab = b"".join(struct.pack("<I", o) for o in offs)
    return head + tab + b"".join(chunks)


class ArrayView:
    """Zero-parse reader: length/null checks and element access are O(1)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.tag = buf[0]
        self.n, c = decode_varint(buf, 1)
        self._bitmap_at = 1 + c
        self._bitmap_len = (self.n + 7) // 8
        self._data_at = self._bitmap_at + self._bitmap_len
        if self.tag in _FIXED_SIZE:
            self._tab_at = None
        else:
            self._tab_at = self._data_at
            self._payload_at = self._tab_at + 4 * (self.n + 1)

    def __len__(self):
        return self.n

    def is_null(self, i: int) -> bool:
        return bool(self.buf[self._bitmap_at + i // 8] & (1 << (i % 8)))

    def __getitem__(self, i: int):
        if not (0 <= i < self.n):
            raise IndexError(i)
        if self.is_null(i):
            return None
        if self.tag in _FIXED_SIZE:
            size = _FIXED_SIZE[self.tag]
            v = struct.unpack_from(_FMT[self.tag], self.buf, self._data_at + i * size)[0]
            return bool(v) if self.tag == T_BOOL else v
        o0 = struct.unpack_from("<I", self.buf, self._tab_at + 4 * i)[0]
        o1 = struct.unpack_from("<I", self.buf, self._tab_at + 4 * (i + 1))[0]
        raw = self.buf[self._payload_at + o0 : self._payload_at + o1]
        return raw.decode("utf-8") if self.tag == T_TEXT else raw

    def to_list(self) -> list:
        return [self[i] for i in range(self.n)]
