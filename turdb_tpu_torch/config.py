"""Centralized constants with dependency assertions.

Mirrors the role of reference src/config/constants.rs:95-182 (compile-time
constants + interdependency asserts), re-derived for a TPU-native engine:
where the reference's constants describe 16KB mmap pages and WAL framing,
ours additionally describe HBM tiling (MXU/VPU lane widths) and mesh axes.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# TPU hardware shape constants (the minimum Pallas tile per dtype)
# ---------------------------------------------------------------------------
LANE = 128          # last-dim tile width (VPU lane / MXU edge)
SUBLANE_F32 = 8     # second-to-last min tile for f32
SUBLANE_BF16 = 16
SUBLANE_I8 = 32

# ---------------------------------------------------------------------------
# Vector index defaults — same graph shape as the reference
# (reference src/hnsw/mod.rs:125-127,643: MAX_LEVELS=4, M0=32, M=16,
#  ef_construction=100, ef_search=32)
# ---------------------------------------------------------------------------
HNSW_MAX_LEVELS = 4
HNSW_M0 = 32                # level-0 out-degree
HNSW_M = 16                 # upper-level out-degree
HNSW_DEFAULT_EF_CONSTRUCTION = 100
HNSW_DEFAULT_EF_SEARCH = 64
HNSW_LEVEL_CAP = 15         # reference src/hnsw/operations.rs:76-83

# Batched-build wave size: new nodes inserted per device round.
HNSW_BUILD_BATCH = 512

# ---------------------------------------------------------------------------
# Storage / durability (host side)
# Keeps the durability contracts of reference src/storage/ without the
# mmap-pager architecture (SURVEY.md §7 "what NOT to carry over").
# ---------------------------------------------------------------------------
FILE_HEADER_SIZE = 128               # reference src/storage/headers.rs:74-79
WAL_FRAME_HEADER_SIZE = 32           # reference src/storage/wal.rs:152
WAL_SEGMENT_SIZE = 64 * 1024 * 1024  # reference src/config/constants.rs:178
WAL_CHECKPOINT_FRAMES = 100_000      # reference src/config/constants.rs:182

MAGIC_META = b"TTPU META\x00\x00\x00\x00\x00\x00\x00"
MAGIC_TABLE = b"TTPU TABLE\x00\x00\x00\x00\x00\x00"
MAGIC_INDEX = b"TTPU INDEX\x00\x00\x00\x00\x00\x00"
MAGIC_HNSW = b"TTPU HNSW\x00\x00\x00\x00\x00\x00\x00"
MAGIC_WAL = b"TTPU WAL\x00\x00\x00\x00\x00\x00\x00\x00"
MAGIC_CATALOG = b"TTPU CATLG\x00\x00\x00\x00\x00\x00"

FORMAT_VERSION = 1

# TOAST: out-of-line storage for oversized values
# (reference src/storage/toast.rs:70-73: threshold 1000B, 4000B chunks)
TOAST_THRESHOLD = 1000
TOAST_CHUNK_SIZE = 4000

# ---------------------------------------------------------------------------
# MVCC (reference src/mvcc/transaction.rs:98: 64 txn slots)
# ---------------------------------------------------------------------------
MAX_CONCURRENT_TXNS = 64

# ---------------------------------------------------------------------------
# Memory budget (reference src/memory/budget.rs: 25% RAM, min 4MB)
# ---------------------------------------------------------------------------
MEMORY_BUDGET_FRACTION = 0.25
MEMORY_BUDGET_MIN = 4 * 1024 * 1024

# ---------------------------------------------------------------------------
# Mesh axis names for the parallel layer (SURVEY.md §2.9)
# ---------------------------------------------------------------------------
MESH_AXIS_DB = "db"      # vector-store shard axis (the "tensor" axis)
MESH_AXIS_DATA = "data"  # query-batch data-parallel axis
MESH_AXIS_HOST = "host"  # cross-host (DCN) shard axis; outermost so the
#                          db-axis merge rides ICI and only [B,k] buffers
#                          cross DCN (two-level merge, SURVEY §2.9)

# Dependency assertions (spirit of reference constants.rs `const _: ()`).
assert HNSW_M0 == 2 * HNSW_M, "level-0 degree must be 2*M (graph invariant)"
assert HNSW_M0 % SUBLANE_F32 == 0, "adjacency width must tile on sublanes"
assert FILE_HEADER_SIZE % 8 == 0
assert WAL_SEGMENT_SIZE % WAL_FRAME_HEADER_SIZE == 0
assert len(MAGIC_META) == 16 and len(MAGIC_HNSW) == 16
assert len(MAGIC_TABLE) == 16 and len(MAGIC_WAL) == 16
assert TOAST_CHUNK_SIZE > TOAST_THRESHOLD
