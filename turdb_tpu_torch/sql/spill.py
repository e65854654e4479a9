"""Memory-budgeted spilling for large joins.

Counterpart of reference src/sql/subquery/spill.rs (SpillableBuffer:416 —
memory-budgeted materialization spilling to temp files) and
partition_spiller.rs (Grace hash join partitions:116). Columnar version:
a Batch partition serializes to an .npz temp file (object columns via
pickle) and reloads on demand; the Grace join partitions both sides by
key hash so only one partition pair is resident at a time.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from turdb_tpu_torch.sql.expr import Batch, Col


class SpilledBatch:
    """A Batch on disk. Load() materializes; the file deletes on close."""

    def __init__(self, batch: Batch, tmpdir: str):
        fd, self.path = tempfile.mkstemp(suffix=".npz", dir=tmpdir)
        os.close(fd)
        payload = {"__n": np.asarray([batch.n])}
        names = []
        for j, ((q, nm), c) in enumerate(zip(batch.names, batch.cols)):
            names.append((q or "", nm))
            payload[f"v{j}"] = c.values
            payload[f"n{j}"] = c.nulls
        self._names = names
        np.savez(self.path, **payload, allow_pickle=True)
        self.n = batch.n

    def load(self) -> Batch:
        with np.load(self.path, allow_pickle=True) as z:
            n = int(z["__n"][0])
            b = Batch(n)
            for j, (q, nm) in enumerate(self._names):
                b.add(q or None, nm, Col(z[f"v{j}"], z[f"n{j}"]))
            return b

    def close(self):
        try:
            os.remove(self.path)
        except OSError:
            pass


def estimate_batch_bytes(b: Batch) -> int:
    total = 0
    for c in b.cols:
        v = c.values
        if v.dtype == object:
            total += v.size * 64  # rough per-object estimate
        else:
            total += v.nbytes
        total += c.nulls.nbytes
    return total


# Grace partitioning lives in engine._grace_join: partitions are selected
# by the FACTORIZED key code (value-based), never a raw-byte hash — an
# INT 1 and a FLOAT 1.0 always land in the same partition.
