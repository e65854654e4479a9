"""The port's copies of the reference's host layers (SQL engine, records,
types, MVCC, memory budget, storage, native host code, database, CLI):
they import without jax or `turdb_tpu`, each copy equals the reference's
file after the `turdb_tpu` -> `turdb_tpu_torch` rewrite but for the files
changed on purpose, the C reverse-edge lists equal the numpy branch, and
the CLI answers on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "turdb_tpu"
PORT = ROOT / "turdb_tpu_torch"
HOST_DIRS = ("types", "records", "mvcc", "memory", "sql", "storage", "native", "database",
             "cli")
# the copies changed on purpose: the device, the port's indexes, the .hnsw
# format on torch tensors, the native build directory, the CLI's --device,
# and a CLI entry module that runs only as `python -m` (importing it, as a
# walk over the package does, runs nothing)
CHANGED = {"database/api.py", "database/indexes.py", "storage/hnsw_io.py", "native/build.py",
           "cli/repl.py", "cli/__main__.py"}
_REWRITE = re.compile(r"\bturdb_tpu\b(?!_)")


def _vendored() -> list[str]:
    out = ["config.py"]
    for d in HOST_DIRS:
        out += sorted(str(p.relative_to(REF)) for p in (REF / d).iterdir()
                      if p.suffix in (".py", ".c", ".cpp"))
    return out


VENDORED = _vendored()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    return env


@pytest.mark.parametrize("rel", VENDORED)
def test_copy_matches_reference(rel):
    port = PORT / rel
    assert port.exists(), f"{rel} is not vendored"
    want = _REWRITE.sub("turdb_tpu_torch", (REF / rel).read_text())
    if rel in CHANGED:
        assert port.read_text() != want, f"{rel} is listed as changed but equals the copy"
    else:
        assert port.read_text() == want, f"{rel} drifted from the reference"


def test_no_host_file_imports_jax_or_the_reference():
    for p in PORT.rglob("*.py"):
        text = p.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|turdb_tpu)\b(?!_)", text, re.M), p


_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["turdb_tpu"] = None
import numpy as np
import turdb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(turdb_tpu_torch.__path__, "turdb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from turdb_tpu_torch import connect
db = connect(sys.argv[1], device="cpu")
db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, emb VECTOR(4), tag TEXT)")
db.execute("INSERT INTO t VALUES (1, '[0, 0, 0, 1]', 'a'), (2, '[1, 0, 0, 0]', 'b')")
db.execute("CREATE INDEX ih ON t USING HNSW (emb)")
print(len(names), db.query("SELECT id, tag FROM t ORDER BY emb <-> '[1, 0, 0, 0.1]' LIMIT 1"))
db.close()
"""


def test_imports_and_sql_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", _BLOCKED, str(tmp_path / "db")], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, rows = r.stdout.strip().split(" ", 1)
    assert int(n) > 60 and rows == "[(2, 'b')]"


def test_cli_on_the_cpu(tmp_path):
    r = subprocess.run([sys.executable, "-m", "turdb_tpu_torch.cli", str(tmp_path / "db"),
                        "--device", "cpu", "-c", "SELECT 1 + 1"], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "| 2 |" in r.stdout


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_topk_equals_numpy(seed, monkeypatch):
    from turdb_tpu_torch.models import hnsw
    from turdb_tpu_torch.native import build

    if not build.crc64_available_native():
        pytest.skip("g++ did not build the native library")
    rng = np.random.default_rng(seed)
    ns, deg, rcap = 3000, 12, 16
    slots = np.sort(rng.choice(5000, ns, replace=False)).astype(np.int64)
    adj = slots[rng.integers(0, ns, (ns, deg))].astype(np.int32)
    adj[rng.random((ns, deg)) < 0.1] = -1
    # coarse distances: many ties, which the C pass must break as the
    # stable argsort does (edge enumeration order)
    dist = (rng.integers(0, 50, (ns, deg)) / 7.0).astype(np.float32)
    dist[rng.random((ns, deg)) < 0.01] = -0.0
    native = hnsw._bulk_reverse_lists(slots, adj, dist, rcap)
    monkeypatch.setattr(build, "reverse_topk", lambda *a: None)
    plain = hnsw._bulk_reverse_lists(slots, adj, dist, rcap)
    assert native.dtype == plain.dtype and np.array_equal(native, plain)
    assert (native >= 0).sum() > ns
