"""Order-preserving (memcmp-comparable) key encoding.

Same contract as reference src/encoding/key.rs:17-46: one type-prefix
byte per value (NULL sorts first, MAX last), sign-split big-endian
integers, IEEE-754 bit-flip floats, escaped/terminated text — so that
encoded composite keys compare bytewise in SQL ORDER.

Tag values are ours (not copied); ordering relationships are the contract:
NULL < BOOL < numerics (one shared tag family so 1 == 1.0 in index order)
< TEXT < BLOB < UUID < VECTOR < MAX.
"""

from __future__ import annotations

import math
import struct
from decimal import Decimal, localcontext

TAG_NULL = 0x01
TAG_FALSE = 0x08
TAG_TRUE = 0x09
# ONE numeric tag: f64 bit-flip + 8-byte residue tiebreaker. A second
# exact-int tag would break the memcmp total order (ints not
# representable as f64 would sort after ALL floats). The residue is the
# signed fraction (v - nearest_f64(v)) / ulp scaled to 62 bits: it keeps
# 1 == 1.0 == Decimal(1) in index order while exactly ordering i64s that
# share an f64 bucket and ordering DECIMALs to ~34 significant digits
# (16 from the f64 + 18.6 from the residue).
TAG_NUM = 0x10
TAG_TEXT = 0x20
TAG_BLOB = 0x30
TAG_UUID = 0x40
TAG_MAX = 0xFF

_ESC = 0x00
_TERM = b"\x00\x00"


def _safe_float(v) -> float:
    try:
        return float(v)
    except OverflowError:
        return math.inf if v > 0 else -math.inf


def _clamp63(q: int) -> int:
    lim = (1 << 63) - 1
    return max(-lim, min(lim, q))


def _residue(v, f: float) -> int:
    """Signed 62-bit-scaled fraction (v - f)/ulp(f); 0 for plain floats."""
    if isinstance(v, float) or math.isinf(f) or math.isnan(f):
        return 0
    if isinstance(v, int):
        if -(2**53) < v < 2**53:
            return 0
        delta = v - int(f)
        if delta == 0:
            return 0
        ulp = int(math.ulp(f))       # power of two >= 2 here: exact shift
        return _clamp63((delta << 62) // ulp)
    # Decimal
    df = Decimal(f)
    if v == df:
        return 0
    ulp = math.ulp(f) or 5e-324
    with localcontext() as ctx:
        ctx.prec = 60
        q = (Decimal(v) - df) / Decimal(ulp) * (1 << 62)
    return _clamp63(int(q))


def _flip_float(v: float) -> int:
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & 0x8000000000000000:
        return (~bits) & 0xFFFFFFFFFFFFFFFF  # negative: flip all
    return bits | 0x8000000000000000         # positive: flip sign bit


def _unflip_float(bits: int) -> float:
    if bits & 0x8000000000000000:
        bits &= 0x7FFFFFFFFFFFFFFF
    else:
        bits = (~bits) & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _escape_bytes(b: bytes) -> bytes:
    # 0x00 -> 0x00 0xFF so the 0x00 0x00 terminator sorts before any
    # continuation; preserves order and allows embedded NULs
    return b.replace(b"\x00", b"\x00\xff") + _TERM


def _unescape_bytes(buf: bytes, offset: int) -> tuple[bytes, int]:
    out = bytearray()
    i = offset
    while True:
        b = buf[i]
        if b == _ESC:
            nxt = buf[i + 1]
            if nxt == 0x00:
                return bytes(out), i + 2
            out.append(0x00)
            i += 2
        else:
            out.append(b)
            i += 1


def encode_value(v, desc: bool = False) -> bytes:
    """Encode one value. `desc` inverts all bytes for DESC ordering."""
    if v is None:
        out = bytes([TAG_NULL])
    elif isinstance(v, bool):
        out = bytes([TAG_TRUE if v else TAG_FALSE])
    elif isinstance(v, (int, float, Decimal)):
        f = _safe_float(v)
        out = (
            bytes([TAG_NUM])
            + struct.pack(">Q", _flip_float(f))
            + struct.pack(">Q", _residue(v, f) + (1 << 63))
        )
    elif isinstance(v, str):
        out = bytes([TAG_TEXT]) + _escape_bytes(v.encode("utf-8"))
    elif isinstance(v, (bytes, bytearray)):
        out = bytes([TAG_BLOB]) + _escape_bytes(bytes(v))
    else:
        raise TypeError(f"unencodable key value: {type(v)}")
    if desc:
        out = bytes(255 - b for b in out)
    return out


def encode_num_batch(vals) -> list[bytes]:
    """Vectorized encode_value for a whole numeric numpy column (the
    bulk-load unique-check path): int/uint within +/-2^53 and float64
    rows encode with residue 0 as one [n, 17] byte matrix; the rare
    big-int rows (nonzero residue) fall back per element. Byte-identical
    to encode_value."""
    import numpy as np

    vals = np.asarray(vals)
    n = len(vals)
    if vals.dtype.kind == "f":
        f = vals.astype(np.float64)
        slow = np.zeros(n, bool)
    else:
        slow = (vals >= 2**53) | (vals <= -(2**53))
        f = vals.astype(np.float64)
    bits = f.view(np.uint64)
    neg = (bits >> np.uint64(63)).astype(bool)
    flipped = np.where(
        neg, ~bits, bits | np.uint64(0x8000000000000000)
    )
    out = np.zeros((n, 17), np.uint8)
    out[:, 0] = TAG_NUM
    out[:, 1:9] = flipped.astype(">u8").view(np.uint8).reshape(n, 8)
    out[:, 9] = 0x80        # residue 0 biased by 1<<63, big-endian
    keys = [r.tobytes() for r in out]
    for i in np.flatnonzero(slow):
        keys[i] = encode_value(int(vals[i]))
    return keys


def decode_value(buf: bytes, offset: int = 0, desc: bool = False):
    """Returns (value, next_offset)."""
    if desc:
        # operate on an inverted copy of the remainder
        inv = bytes(255 - b for b in buf[offset:])
        v, n = decode_value(inv, 0, desc=False)
        return v, offset + n
    tag = buf[offset]
    if tag == TAG_NULL:
        return None, offset + 1
    if tag == TAG_FALSE:
        return False, offset + 1
    if tag == TAG_TRUE:
        return True, offset + 1
    if tag == TAG_NUM:
        if len(buf) < offset + 17:
            raise ValueError("truncated numeric key")
        bits = struct.unpack(">Q", buf[offset + 1 : offset + 9])[0]
        f = _unflip_float(bits)
        resid = struct.unpack(">Q", buf[offset + 9 : offset + 17])[0] - (1 << 63)
        nxt = offset + 17
        if resid == 0:
            return int(f) if f.is_integer() and abs(f) < 2**53 else f, nxt
        if f.is_integer() and math.isfinite(f) and math.ulp(f) >= 1:
            num = resid * int(math.ulp(f))
            if num % (1 << 62) == 0:     # exact integer residue
                return int(f) + (num >> 62), nxt
        with localcontext() as ctx:      # decimal: ~34-digit round-trip
            ctx.prec = 60
            d = Decimal(f) + Decimal(resid) * Decimal(
                math.ulp(f) or 5e-324
            ) / (1 << 62)
        return d, nxt
    if tag == TAG_TEXT:
        raw, nxt = _unescape_bytes(buf, offset + 1)
        return raw.decode("utf-8"), nxt
    if tag == TAG_BLOB:
        raw, nxt = _unescape_bytes(buf, offset + 1)
        return raw, nxt
    raise ValueError(f"bad key tag 0x{tag:02x}")


_NATIVE = None


def _native():
    global _NATIVE
    if _NATIVE is None:
        from turdb_tpu_torch.native.build import oltp

        _NATIVE = oltp() or False
    return _NATIVE


def encode_key(values, desc_flags=None) -> bytes:
    """Composite key: concatenation of per-value encodings
    (reference key.rs composite keys; DESC via byte inversion).
    Hot path runs in C (native/oltp.c, byte-identical — fuzz-compared
    in tests/test_native_oltp.py); Decimal and big ints fall back."""
    n = _native()
    if n is not None and n is not False:
        try:
            return n.encode_key(tuple(values), None if desc_flags is None
                                else tuple(desc_flags))
        except TypeError:
            pass
    if desc_flags is None:
        desc_flags = [False] * len(values)
    return b"".join(encode_value(v, d) for v, d in zip(values, desc_flags))


def decode_key(buf: bytes, n: int, desc_flags=None) -> list:
    if desc_flags is None:
        desc_flags = [False] * n
    out, off = [], 0
    for i in range(n):
        v, off = decode_value(buf, off, desc_flags[i])
        out.append(v)
    return out
