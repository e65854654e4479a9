"""Storage: columnar tables, WAL durability, snapshots, file layout.

Counterpart of reference src/storage/ (SURVEY.md §2.1) with the
architecture inverted per the build plan (SURVEY.md §7): no mmap pager,
no page cache, no page locks — live data is columnar arrays (host numpy
feeding device ops); durability is a logical WAL with CRC64-framed
records plus columnar snapshot files. The durability CONTRACTS are kept:
128-byte magic'd file headers, segmented WAL with per-frame checksums,
checkpoint-then-truncate, crash recovery by replay.
"""

from turdb_tpu_torch.storage.table import ColumnarTable  # noqa: F401
from turdb_tpu_torch.storage.wal import Wal, SyncMode  # noqa: F401
from turdb_tpu_torch.storage.files import FileManager  # noqa: F401
