"""Binary JSON (JSONB) with O(log n) key lookup.

Same contract as reference src/records/jsonb.rs:5-58: a self-describing
binary tree with type-tagged nodes, object keys stored SORTED so key
lookup binary-searches without parsing the whole document. Layout is ours:

  node := [u8 tag][payload]
    NULL/TRUE/FALSE: no payload
    INT:    <q 8B               FLOAT: <d 8B
    STR:    varint len + utf8   ARRAY: varint n + u32 offsets[n+1] + nodes
    OBJECT: varint n + u32 key_offsets[n+1] + u32 val_offsets[n+1]
            + sorted utf8 keys + value nodes
"""

from __future__ import annotations

import struct

from turdb_tpu_torch.records.varint import decode_varint, encode_varint

T_NULL, T_TRUE, T_FALSE, T_INT, T_FLOAT, T_STR, T_ARR, T_OBJ = range(8)


def jsonb_encode(v) -> bytes:
    if v is None:
        return bytes([T_NULL])
    if v is True:
        return bytes([T_TRUE])
    if v is False:
        return bytes([T_FALSE])
    if isinstance(v, int):
        return bytes([T_INT]) + struct.pack("<q", v)
    if isinstance(v, float):
        return bytes([T_FLOAT]) + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return bytes([T_STR]) + encode_varint(len(raw)) + raw
    if isinstance(v, (list, tuple)):
        nodes = [jsonb_encode(x) for x in v]
        offs = [0]
        for nd in nodes:
            offs.append(offs[-1] + len(nd))
        head = bytes([T_ARR]) + encode_varint(len(nodes))
        tab = b"".join(struct.pack("<I", o) for o in offs)
        return head + tab + b"".join(nodes)
    if isinstance(v, dict):
        items = sorted((str(k), x) for k, x in v.items())
        keys = [k.encode("utf-8") for k, _ in items]
        nodes = [jsonb_encode(x) for _, x in items]
        koffs = [0]
        for k in keys:
            koffs.append(koffs[-1] + len(k))
        voffs = [0]
        for nd in nodes:
            voffs.append(voffs[-1] + len(nd))
        head = bytes([T_OBJ]) + encode_varint(len(items))
        ktab = b"".join(struct.pack("<I", o) for o in koffs)
        vtab = b"".join(struct.pack("<I", o) for o in voffs)
        return head + ktab + vtab + b"".join(keys) + b"".join(nodes)
    # numpy scalars etc.
    import numpy as np

    if isinstance(v, np.integer):
        return jsonb_encode(int(v))
    if isinstance(v, np.floating):
        return jsonb_encode(float(v))
    if isinstance(v, np.ndarray):
        return jsonb_encode(v.tolist())
    raise TypeError(f"cannot jsonb-encode {type(v)}")


def _obj_header(buf: bytes, off: int):
    n, c = decode_varint(buf, off + 1)
    ktab = off + 1 + c
    vtab = ktab + 4 * (n + 1)
    kbase = vtab + 4 * (n + 1)
    kend = struct.unpack_from("<I", buf, ktab + 4 * n)[0]
    vbase = kbase + kend
    return n, ktab, vtab, kbase, vbase


def jsonb_decode(buf: bytes, off: int = 0):
    tag = buf[off]
    if tag == T_NULL:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return struct.unpack_from("<q", buf, off + 1)[0]
    if tag == T_FLOAT:
        return struct.unpack_from("<d", buf, off + 1)[0]
    if tag == T_STR:
        ln, c = decode_varint(buf, off + 1)
        s = off + 1 + c
        return buf[s : s + ln].decode("utf-8")
    if tag == T_ARR:
        n, c = decode_varint(buf, off + 1)
        tab = off + 1 + c
        base = tab + 4 * (n + 1)
        out = []
        for j in range(n):
            o = struct.unpack_from("<I", buf, tab + 4 * j)[0]
            out.append(jsonb_decode(buf, base + o))
        return out
    if tag == T_OBJ:
        n, ktab, vtab, kbase, vbase = _obj_header(buf, off)
        out = {}
        for j in range(n):
            k0 = struct.unpack_from("<I", buf, ktab + 4 * j)[0]
            k1 = struct.unpack_from("<I", buf, ktab + 4 * (j + 1))[0]
            key = buf[kbase + k0 : kbase + k1].decode("utf-8")
            v0 = struct.unpack_from("<I", buf, vtab + 4 * j)[0]
            out[key] = jsonb_decode(buf, vbase + v0)
        return out
    raise ValueError(f"bad jsonb tag {tag}")


def jsonb_get(buf: bytes, key: str, off: int = 0):
    """O(log n) object key lookup without full decode (the reference's
    binary-search-on-sorted-keys contract, jsonb.rs:5-30). Returns the
    decoded value or None."""
    if buf[off] != T_OBJ:
        return None
    n, ktab, vtab, kbase, vbase = _obj_header(buf, off)
    want = key.encode("utf-8")
    lo, hi = 0, n - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        k0 = struct.unpack_from("<I", buf, ktab + 4 * mid)[0]
        k1 = struct.unpack_from("<I", buf, ktab + 4 * (mid + 1))[0]
        k = buf[kbase + k0 : kbase + k1]
        if k == want:
            v0 = struct.unpack_from("<I", buf, vtab + 4 * mid)[0]
            return jsonb_decode(buf, vbase + v0)
        if k < want:
            lo = mid + 1
        else:
            hi = mid - 1
    return None


def jsonb_get_path(buf: bytes, path: list):
    """Navigate a path of object keys / array indexes (SQL -> / ->> ops)."""
    node = jsonb_decode(buf)
    for p in path:
        if isinstance(node, dict):
            node = node.get(str(p))
        elif isinstance(node, list):
            try:
                node = node[int(p)]
            except (IndexError, ValueError, TypeError):
                return None
        else:
            return None
    return node


def jsonb_contains(outer, inner) -> bool:
    """Containment (@> operator), PostgreSQL semantics."""
    if isinstance(outer, dict) and isinstance(inner, dict):
        return all(
            k in outer and jsonb_contains(outer[k], v) for k, v in inner.items()
        )
    if isinstance(outer, list) and isinstance(inner, list):
        return all(any(jsonb_contains(o, i) for o in outer) for i in inner)
    if isinstance(outer, list):
        return any(jsonb_contains(o, inner) for o in outer)
    return outer == inner
