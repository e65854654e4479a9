"""SQLite4-style variable-length integers (reference
src/encoding/varint.rs:9-20,118,153): 1 byte for values <= 240, up to 9
bytes for the full u64 range; encoded form is memcmp-orderable for
unsigned values."""

from __future__ import annotations


def encode_varint(v: int) -> bytes:
    if v < 0:
        raise ValueError("varint encodes unsigned values")
    if v <= 240:
        return bytes([v])
    if v <= 2287:
        v -= 240
        return bytes([241 + v // 256, v % 256])
    if v <= 67823:
        v -= 2288
        return bytes([249, v // 256, v % 256])
    out = v.to_bytes((v.bit_length() + 7) // 8, "big")
    n = len(out)
    if n > 8:
        raise ValueError("varint overflow")
    return bytes([249 + n - 2]) + out


def decode_varint(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, bytes_consumed)."""
    a0 = buf[offset]
    if a0 <= 240:
        return a0, 1
    if a0 <= 248:
        return 240 + 256 * (a0 - 241) + buf[offset + 1], 2
    if a0 == 249:
        return 2288 + 256 * buf[offset + 1] + buf[offset + 2], 3
    n = a0 - 249 + 2
    return int.from_bytes(buf[offset + 1 : offset + 1 + n], "big"), n + 1
