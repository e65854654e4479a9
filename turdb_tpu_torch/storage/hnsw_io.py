"""HNSW index snapshot files (.hnsw).

Counterpart of reference src/hnsw/storage.rs (magic'd 128-byte header with
graph parameters + entry point + counts, :21-44,100-119) — but where the
reference persists slotted node pages, the graph IS dense arrays, so a
snapshot is a straight dump of the adjacency/vector/level arrays plus the
rowid↔slot map.

The format is the JAX package's (turdb_tpu/storage/hnsw_io.py), byte for
byte in the arrays, so a snapshot written by either package opens in the
other. Two points of the port's state meet it:

- SQ16 codes are int16 tensors holding the uint16 bits (ops/quantize.py
  `Sq8Rows`); the file holds uint16, so they are written as
  `.view(np.uint16)` and read back as int16 bits, and `qbits` comes from
  `Sq8Rows.bits`.
- `entry` and `max_level` are Python ints in the port's `HnswState`.

The meta also records `descent_ef`, the upper-level descent of a
bulk-built graph (models/hnsw.py `HnswIndex.add`), so that a reopened
graph searches as it did before the close. The reference's loader ignores
the key; a file without it (the reference's) descends greedily, as the
reference does after a reopen.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from turdb_tpu_torch.config import FILE_HEADER_SIZE, FORMAT_VERSION, MAGIC_HNSW
from turdb_tpu_torch.ops.quantize import Sq8Rows
from turdb_tpu_torch.records.jsonb import jsonb_decode, jsonb_encode
from turdb_tpu_torch.storage.files import CorruptFile, _read_buf, _write_buf


def _host(t: torch.Tensor, n: int) -> np.ndarray:
    return t[:n].cpu().numpy()


def save_hnsw(path: str, tindex) -> None:
    """Persist a database.indexes.HnswTableIndex."""
    tindex.flush_pending()
    idx = tindex.index
    s = idx.state
    sq = isinstance(s.vectors, Sq8Rows)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {
        "name": tindex.name,
        "column": tindex.column,
        "metric": idx.cfg.metric.value,
        "dim": idx.cfg.dim,
        "m": idx.cfg.m,
        "m0": idx.cfg.m0,
        "max_levels": idx.cfg.max_levels,
        "ef_construction": idx.cfg.ef_construction,
        "ef_search": idx.cfg.ef_search,
        "size": idx.size,
        "capacity": idx.capacity,
        "entry": int(s.entry),
        "max_level": int(s.max_level),
        "sq8": sq,
        "qbits": s.vectors.bits if sq else 8,
        "rowid_to_slot": [
            [int(r), int(sl)] for r, sl in tindex.rowid_to_slot.items()
        ],
        "descent_ef": idx._descent_ef,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        hdr = bytearray(FILE_HEADER_SIZE)
        hdr[:16] = MAGIC_HNSW
        struct.pack_into("<I", hdr, 16, FORMAT_VERSION)
        fh.write(bytes(hdr))
        _write_buf(fh, jsonb_encode(meta))
        n = idx.size
        if sq:
            # SQ serving stores persist as codes; the exact norms are
            # re-derivable only from f32, so they ride too
            codes = _host(s.vectors.codes, n)
            if s.vectors.bits == 16:
                codes = codes.view(np.uint16)
            _write_buf(fh, codes.tobytes())
            _write_buf(fh, _host(s.vectors.mins, n).tobytes())
            _write_buf(fh, _host(s.vectors.scales, n).tobytes())
            _write_buf(fh, _host(s.norms, n).tobytes())
        else:
            _write_buf(fh, _host(s.vectors, n).tobytes())
        _write_buf(fh, _host(s.adj0, n).tobytes())
        for a in s.adj_hi:
            _write_buf(fh, _host(a, n).tobytes())
        _write_buf(fh, _host(s.levels, n).tobytes())
        _write_buf(fh, idx._alive[:n].tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_hnsw(path: str, device="cuda"):
    """Load into a fresh HnswTableIndex on `device`; returns it or None if
    absent."""
    if not os.path.exists(path):
        return None
    from turdb_tpu_torch.database.indexes import HnswTableIndex
    from turdb_tpu_torch.ops.distance import Metric, prep_norms

    with open(path, "rb") as fh:
        hdr = fh.read(FILE_HEADER_SIZE)
        if len(hdr) != FILE_HEADER_SIZE or hdr[:16] != MAGIC_HNSW:
            raise CorruptFile("bad hnsw magic")
        meta = jsonb_decode(_read_buf(fh))
        n = int(meta["size"])
        dim = int(meta["dim"])
        sq8 = bool(meta.get("sq8", False))
        qbits = int(meta.get("qbits", 8))
        tindex = HnswTableIndex(
            meta["name"], meta["column"], dim=dim,
            metric=Metric(meta["metric"]), m=int(meta["m"]),
            ef_construction=int(meta["ef_construction"]),
            ef_search=int(meta["ef_search"]),
            sq8=sq8, qbits=qbits, device=device,
        )
        idx = tindex.index
        idx._ensure(max(n + 1, 1))
        cfg = idx.cfg
        if sq8:
            cdt = np.uint16 if qbits == 16 else np.uint8
            codes = np.frombuffer(_read_buf(fh), cdt).reshape(n, dim)
            mins = np.frombuffer(_read_buf(fh), np.float32)[:n]
            scales = np.frombuffer(_read_buf(fh), np.float32)[:n]
            norms = np.frombuffer(_read_buf(fh), np.float32)[:n]
        else:
            vectors = np.frombuffer(_read_buf(fh), np.float32).reshape(n, dim)
        adj0 = np.frombuffer(_read_buf(fh), np.int32).reshape(n, cfg.m0)
        adj_hi = [
            np.frombuffer(_read_buf(fh), np.int32).reshape(n, cfg.m)
            for _ in range(cfg.max_levels - 1)
        ]
        levels = np.frombuffer(_read_buf(fh), np.int32)[:n]
        alive = np.frombuffer(_read_buf(fh), bool)[:n]

    def dev(a):
        return torch.as_tensor(np.array(a), device=idx.device)

    s = idx.state
    if sq8:
        cap = idx.capacity
        if qbits == 16:
            codes = codes.view(np.int16)
        cfull = torch.zeros((cap, dim), dtype=torch.int16 if qbits == 16 else torch.uint8,
                            device=idx.device)
        cfull[:n] = dev(codes)
        mfull = torch.zeros(cap, device=idx.device)
        mfull[:n] = dev(mins)
        sfull = torch.zeros(cap, device=idx.device)
        sfull[:n] = dev(scales)
        vec_store = Sq8Rows(cfull, mfull, sfull)
        s.norms[:n] = dev(norms)
    else:
        vec_store = s.vectors
        vec_store[:n] = dev(vectors)
        s.norms[:n] = prep_norms(vec_store[:n])
    s.adj0[:n] = dev(adj0)
    for a, h in zip(s.adj_hi, adj_hi):
        a[:n] = dev(h)
    s.levels[:n] = dev(levels)
    idx.state = s._replace(vectors=vec_store, entry=int(meta["entry"]),
                           max_level=int(meta["max_level"]))
    idx.size = n
    idx._alive[:n] = alive
    idx._descent_ef = int(meta.get("descent_ef", 1))
    for r, slot in meta["rowid_to_slot"]:
        tindex.rowid_to_slot[int(r)] = int(slot)
    tindex._rebuild_slot_arrays()
    return tindex
