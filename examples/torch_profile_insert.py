"""Insert-path profiler on the PyTorch / CUDA port (the reference's
examples/profile_insert.py).

Profiles the prepared single-row insert path with the phase timing
counters (turdb_tpu_torch/utils/timing.py) plus a wall-clock rate, and
prints the per-phase breakdown that `PRAGMA timing_stats` exposes in SQL.
The database runs on the card by default (`--device cpu`: the CPU); the
rows are host work either way.

Usage:  python examples/torch_profile_insert.py [--device cpu] [N_ROWS]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turdb_tpu_torch.database.api import Database
from turdb_tpu_torch.utils import timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=int, default=30_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.rows
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.create(tmp + "/profile", device=args.device)
        db.execute("PRAGMA wal = off")
        db.execute(
            "CREATE TABLE t (id INT PRIMARY KEY, a INT, b TEXT, c DOUBLE)"
        )
        stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3, $4)")
        for i in range(2000):                      # warm the fast lane
            stmt.execute([i, i * 2, f"name{i}", i * 0.5])
        timing.reset()

        t0 = time.perf_counter()
        for i in range(2000, 2000 + n):
            stmt.execute([i, i * 2, f"name{i}", i * 0.5])
        wall = time.perf_counter() - t0

        print(f"{n} prepared inserts in {wall:.3f}s = {n / wall:,.0f} rows/s "
              f"({wall / n * 1e9:,.0f} ns/row)")
        rows = timing.timing_stats()
        if rows:
            print(f"{'phase':<28}{'total_ms':>10}{'count':>10}{'avg_us':>9}")
            for phase, total_ms, count, avg_us in rows:
                print(f"{phase:<28}{total_ms:>10.2f}{count:>10}{avg_us:>9.2f}")
        else:
            print("(phase counters idle: the generated fast lane handles the "
                  "whole row — see PRAGMA timing_stats for the generic path)")
        count = db.query("SELECT COUNT(*) FROM t")[0][0]
        db.close()
    return count, rows


if __name__ == "__main__":
    main()
