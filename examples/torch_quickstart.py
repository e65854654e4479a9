"""End-to-end quickstart on the PyTorch / CUDA port: SQL + vector search
through the public API.

The database's vector indexes run on the card by default; `--device cpu`
runs them on the CPU, and `--rows` sets the number of documents.

Usage:  python examples/torch_quickstart.py [--device cpu] [--rows 2000]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from turdb_tpu_torch import Database


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=2000)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.create(tmp + "/quickstart", device=args.device)

        db.execute("""
            CREATE TABLE docs (
                id BIGINT PRIMARY KEY AUTO_INCREMENT,
                body TEXT NOT NULL,
                emb VECTOR(64)
            )
        """)

        rng = np.random.default_rng(0)
        ins = db.prepare("INSERT INTO docs (body, emb) VALUES ($1, $2)")
        for i in range(args.rows):
            vec = rng.standard_normal(64).astype(np.float32)
            ins.execute([f"document {i}", "[" + ",".join(f"{x:.4f}" for x in vec) + "]"])

        db.execute("CREATE INDEX docs_ann ON docs USING IVF (emb)")

        q = rng.standard_normal(64).astype(np.float32)
        qtxt = "[" + ",".join(f"{x:.4f}" for x in q) + "]"
        rows = db.query(
            f"SELECT id, body, emb <-> '{qtxt}' AS dist FROM docs "
            f"ORDER BY dist LIMIT 5"
        )
        print("nearest 5:")
        for r in rows:
            print(f"  id={r[0]:<6} {r[1]:<16} dist={r[2]:.3f}")

        print("\nEXPLAIN shows the ANN path:")
        plan = [line for (line,) in db.execute(
            f"EXPLAIN SELECT id FROM docs ORDER BY emb <-> '{qtxt}' LIMIT 5"
        ).rows]
        for line in plan:
            print(" ", line)

        db.close()
    return rows, plan


if __name__ == "__main__":
    main()
