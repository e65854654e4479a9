"""Database directory layout and snapshot (.tbd) files.

Layout keeps the reference's MySQL-style file-per-table spirit
(reference src/storage/file_manager.rs:8-20):

    dbdir/turdb.meta          128B header + db metadata (JSONB)
    dbdir/turdb.catalog       catalog document (JSONB + CRC64)
    dbdir/wal/wal.NNNNNN      WAL segments
    dbdir/<schema>/<table>.tbd    columnar snapshot
    dbdir/<schema>/<table>.hnsw   vector index snapshot

Snapshot (.tbd) format: 128-byte magic'd header (reference
headers.rs:74-79 contract) + JSONB metadata block + raw little-endian
column buffers. Object columns (text/json/arrays) serialize via JSONB;
typed columns are raw numpy bytes — a checkpoint is one sequential write.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from turdb_tpu_torch.config import (
    FILE_HEADER_SIZE,
    FORMAT_VERSION,
    MAGIC_CATALOG,
    MAGIC_META,
    MAGIC_TABLE,
)
from turdb_tpu_torch.native.build import crc64
from turdb_tpu_torch.records.jsonb import jsonb_decode, jsonb_encode
from turdb_tpu_torch.storage.table import ColumnarTable
from turdb_tpu_torch.types.column import ColumnDef
from turdb_tpu_torch.types.datatype import StorageClass


class CorruptFile(Exception):
    pass


def _write_header(fh, magic: bytes, meta: dict):
    hdr = bytearray(FILE_HEADER_SIZE)
    hdr[:16] = magic
    struct.pack_into("<I", hdr, 16, FORMAT_VERSION)
    fh.write(bytes(hdr))
    blob = jsonb_encode(meta)
    fh.write(struct.pack("<IQ", len(blob), crc64(blob)))
    fh.write(blob)


def _read_header(fh, magic: bytes) -> dict:
    hdr = fh.read(FILE_HEADER_SIZE)
    if len(hdr) != FILE_HEADER_SIZE or hdr[:16] != magic:
        raise CorruptFile("bad magic")
    (version,) = struct.unpack_from("<I", hdr, 16)
    if version != FORMAT_VERSION:
        raise CorruptFile(f"unsupported format version {version}")
    ln, crc = struct.unpack("<IQ", fh.read(12))
    blob = fh.read(ln)
    if crc64(blob) != crc:
        raise CorruptFile("metadata checksum mismatch")
    return jsonb_decode(blob)


class FileManager:
    def __init__(self, root: str):
        self.root = root

    # -- paths -------------------------------------------------------------

    def meta_path(self) -> str:
        return os.path.join(self.root, "turdb.meta")

    def catalog_path(self) -> str:
        return os.path.join(self.root, "turdb.catalog")

    def wal_dir(self) -> str:
        return os.path.join(self.root, "wal")

    def table_path(self, schema: str, table: str) -> str:
        return os.path.join(self.root, schema, f"{table}.tbd")

    def hnsw_path(self, schema: str, table: str, index: str) -> str:
        return os.path.join(self.root, schema, f"{table}.{index}.hnsw")

    # -- meta --------------------------------------------------------------

    def write_meta(self, meta: dict):
        tmp = self.meta_path() + ".tmp"
        with open(tmp, "wb") as fh:
            _write_header(fh, MAGIC_META, meta)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.meta_path())

    def read_meta(self) -> dict:
        with open(self.meta_path(), "rb") as fh:
            return _read_header(fh, MAGIC_META)

    # -- catalog -----------------------------------------------------------

    def write_catalog(self, doc: dict):
        tmp = self.catalog_path() + ".tmp"
        with open(tmp, "wb") as fh:
            _write_header(fh, MAGIC_CATALOG, doc)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.catalog_path())

    def read_catalog(self) -> dict:
        with open(self.catalog_path(), "rb") as fh:
            return _read_header(fh, MAGIC_CATALOG)

    # -- table snapshots ---------------------------------------------------

    def write_table_snapshot(self, schema: str, table: ColumnarTable,
                             indices=None):
        """Write a table snapshot. With `indices` (an int array of version
        rows), only those versions are exported and their stamps are
        normalized to the committed-bootstrap form (xmin=xmax=0) — the
        filtered form checkpoint() uses while transactions are active."""
        import numpy as _np

        path = self.table_path(schema, table.name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if indices is None:
            sel = slice(0, table.nversions)
            n = table.nversions
        else:
            sel = _np.asarray(indices, _np.int64)
            n = len(sel)
        meta = {
            "name": table.name,
            "table_id": table.table_id,
            "nversions": n,
            "next_rowid": table.next_rowid,
            "auto_increment": table.auto_increment,
            "columns": [c.to_dict() for c in table.columns],
            "toast_cols": sorted(table.toast_cols),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            _write_header(fh, MAGIC_TABLE, meta)
            if indices is None:
                stamp_arrs = (table.xmin[sel], table.xmax[sel])
            else:
                zero = _np.zeros(n, table.xmin.dtype)
                stamp_arrs = (zero, zero)
            for arr in (*stamp_arrs, table.rowids[sel]):
                _write_buf(fh, arr.tobytes())
            for c in table.columns:
                nulls = table.nulls[c.name][sel]
                _write_buf(fh, nulls.tobytes())
                col = table.cols[c.name]
                sc = c.dtype.storage_class
                if sc is StorageClass.DECIMAL:
                    sub = col[sel]
                    vals = [
                        None if nulls[i] else str(sub[i]) for i in range(n)
                    ]
                    _write_buf(fh, jsonb_encode(vals))
                elif sc is StorageClass.OBJECT or col.dtype == object:
                    sub = col[sel]
                    vals = [
                        None if nulls[i] else _jsonable(sub[i]) for i in range(n)
                    ]
                    _write_buf(fh, jsonb_encode(vals))
                else:
                    _write_buf(fh, col[sel].tobytes())
            from turdb_tpu_torch.storage.toast import serialize_store

            _write_buf(fh, serialize_store(table.toast))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def read_table_snapshot(self, schema: str, name: str) -> ColumnarTable:
        path = self.table_path(schema, name)
        with open(path, "rb") as fh:
            meta = _read_header(fh, MAGIC_TABLE)
            cols = [ColumnDef.from_dict(d) for d in meta["columns"]]
            t = ColumnarTable(meta["name"], cols, table_id=meta["table_id"])
            n = meta["nversions"]
            t._ensure(max(n, 1))
            t.nversions = n
            t.next_rowid = meta["next_rowid"]
            t.auto_increment = meta["auto_increment"]
            t.xmin[:n] = np.frombuffer(_read_buf(fh), np.int64)
            t.xmax[:n] = np.frombuffer(_read_buf(fh), np.int64)
            t.rowids[:n] = np.frombuffer(_read_buf(fh), np.int64)
            for c in cols:
                t.nulls[c.name][:n] = np.frombuffer(_read_buf(fh), bool)
                col = t.cols[c.name]
                sc = c.dtype.storage_class
                if sc is StorageClass.DECIMAL:
                    from decimal import Decimal

                    vals = jsonb_decode(_read_buf(fh))
                    for i, v in enumerate(vals):
                        col[i] = None if v is None else Decimal(v)
                elif sc is StorageClass.OBJECT or col.dtype == object:
                    vals = jsonb_decode(_read_buf(fh))
                    for i, v in enumerate(vals):
                        if isinstance(v, dict) and "__bytes__" in v and len(v) == 1:
                            v = v["__bytes__"].encode("latin-1")
                        elif isinstance(v, dict) and "__toast__" in v:
                            from turdb_tpu_torch.storage.toast import Toasted

                            v = Toasted(
                                v["__toast__"].encode("latin-1"),
                                None,  # patched to t.toast below
                                bool(v.get("text")),
                            )
                        col[i] = v
                else:
                    raw = np.frombuffer(_read_buf(fh), col.dtype)
                    if col.ndim == 2:
                        col[:n] = raw.reshape(n, col.shape[1])
                    else:
                        col[:n] = raw
            from turdb_tpu_torch.storage.toast import Toasted, deserialize_store

            t.toast = deserialize_store(_read_buf(fh))
            t.toast_cols = set(meta.get("toast_cols", []))
            for cn in t.toast_cols:
                col = t.cols[cn]
                for i in range(n):
                    if isinstance(col[i], Toasted):
                        col[i].store = t.toast
            # rebuild latest map + version chains: ascending order, newest wins
            t.latest = {}
            t.prev[:n] = -1
            for i in range(n):
                rid = int(t.rowids[i])
                old = t.latest.get(rid)
                if old is not None:
                    t.prev[i] = old
                t.latest[rid] = i
            return t

    def drop_table_files(self, schema: str, name: str):
        for suffix in (".tbd",):
            p = os.path.join(self.root, schema, f"{name}{suffix}")
            if os.path.exists(p):
                os.remove(p)
        # index snapshots
        d = os.path.join(self.root, schema)
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.startswith(f"{name}.") and f.endswith(".hnsw"):
                    os.remove(os.path.join(d, f))


def _jsonable(v):
    from turdb_tpu_torch.storage.toast import Toasted

    if isinstance(v, Toasted):
        return {
            "__toast__": v.pointer.decode("latin-1"),
            "text": bool(v.text),
        }
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (bytes, bytearray)):
        # bytes in object columns ride as latin-1 strings tagged by a pair
        return {"__bytes__": bytes(v).decode("latin-1")}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _write_buf(fh, blob: bytes):
    fh.write(struct.pack("<IQ", len(blob), crc64(blob)))
    fh.write(blob)


def _read_buf(fh) -> bytes:
    ln, crc = struct.unpack("<IQ", fh.read(12))
    blob = fh.read(ln)
    if crc64(blob) != crc:
        raise CorruptFile("buffer checksum mismatch")
    return blob
