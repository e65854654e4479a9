"""Compile-on-first-use loader for the native components.

g++ builds crc64.cpp, hnsw_host.cpp and hnsw_cpu_baseline.cpp into one
shared object and oltp.c into a CPython extension, under
`build/turdb_native/` at the repository root. Each library is named by a
hash of its sources and flags, so that this package and the reference
never share a file, and is written through a temporary file of its own
process and `os.replace`, so that processes building at once never
interleave one file. If no compiler is available the numpy table-driven
CRC and the pure-Python OLTP paths serve (same results).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(_HERE))),
                         "build", "turdb_native")
_LIB = None
_FALLBACK_TABLE = None

POLY = 0xC96C5795D7870F42


def _compile(srcs: list[str], name: str, cmd: list[str], timeout: int) -> str | None:
    """g++ `cmd` + `-o <so>` + `srcs` into BUILD_DIR/<name>_<hash>.so (the
    hash of the sources and the command), unless it is there already."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([*cmd, "-o", tmp, *srcs], check=True, capture_output=True,
                       timeout=timeout)
        os.replace(tmp, so)
        return so
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _build_lib() -> str | None:
    srcs = [os.path.join(_HERE, "crc64.cpp"),
            os.path.join(_HERE, "hnsw_host.cpp"),
            os.path.join(_HERE, "hnsw_cpu_baseline.cpp")]
    # -march=native: the library never leaves the host that built it, and
    # the CPU-baseline distance loop needs the host's widest vector ISA to
    # be an honest (fast) baseline
    return _compile(srcs, "libturdb_torch_native",
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC"], timeout=120)


def _get_lib():
    global _LIB
    if _LIB is None:
        path = _build_lib()
        if path is None:
            _LIB = False
        else:
            try:
                lib = ctypes.CDLL(path)
                lib.turdb_crc64.restype = ctypes.c_uint64
                lib.turdb_crc64.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_size_t,
                    ctypes.c_uint64,
                ]
                lib.turdb_reverse_topk.restype = None
                lib.turdb_reverse_topk.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int32,
                ]
                lib.turdb_hnsw_cpu_build_search.restype = ctypes.c_double
                lib.turdb_hnsw_cpu_build_search.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_void_p,
                ]
                _LIB = lib
            except OSError:
                _LIB = False
    return _LIB


def _fallback_table():
    global _FALLBACK_TABLE
    if _FALLBACK_TABLE is None:
        t = np.zeros(256, np.uint64)
        for i in range(256):
            crc = np.uint64(i)
            for _ in range(8):
                low = crc & np.uint64(1)
                crc = crc >> np.uint64(1)
                if low:
                    crc ^= np.uint64(POLY)
            t[i] = crc
        _FALLBACK_TABLE = t
    return _FALLBACK_TABLE


def _crc64_py(data: bytes, seed: int = 0) -> int:
    table = _fallback_table()
    crc = np.uint64(~seed & 0xFFFFFFFFFFFFFFFF)
    eight = np.uint64(8)
    mask = np.uint64(0xFF)
    arr = np.frombuffer(data, np.uint8)
    for b in arr:
        crc = (crc >> eight) ^ table[int((crc ^ np.uint64(b)) & mask)]
    return int(~crc & np.uint64(0xFFFFFFFFFFFFFFFF))


def crc64(data: bytes, seed: int = 0) -> int:
    """CRC64-ECMA over bytes (WAL frame checksums, reference wal.rs:148)."""
    lib = _get_lib()
    if lib:
        return lib.turdb_crc64(bytes(data), len(data), seed)
    return _crc64_py(bytes(data), seed)


def crc64_available_native() -> bool:
    return bool(_get_lib())


def reverse_topk(slots, adj, dist, pos_arr, rcap: int):
    """C reverse-edge lists (hnsw_host.cpp): per target, the up-to-rcap
    nearest sources by (order-flipped f32 bits, edge enumeration order) —
    the exact order the numpy packed-key stable argsort produces. Returns
    the filled rev [ns, rcap] array, or None when no native lib."""
    lib = _get_lib()
    if not lib:
        return None
    ns, deg = adj.shape
    slots = np.ascontiguousarray(slots, np.int64)
    adj = np.ascontiguousarray(adj, np.int32)
    dist = np.ascontiguousarray(dist, np.float32)
    pos_arr = np.ascontiguousarray(pos_arr, np.int64)
    rev = np.full((ns, rcap), -1, np.int32)
    lib.turdb_reverse_topk(
        slots.ctypes.data, adj.ctypes.data, dist.ctypes.data,
        ns, deg, pos_arr.ctypes.data, len(pos_arr),
        rev.ctypes.data, rcap,
    )
    return rev


def hnsw_cpu_build(x, m: int = 16, ef_construction: int = 100,
                   queries=None, k: int = 10, ef_search: int = 64,
                   seed: int = 1):
    """Single-threaded CPU HNSW build (hnsw_cpu_baseline.cpp) — the
    measured baseline for BASELINE.json's ">=10x the CPU reference's
    vectors/sec" gate. Returns {"seconds", "vps", "recall"} (recall@k of
    the built graph vs numpy brute force over `queries`, proving the
    baseline is a real index), or None when no native lib."""
    lib = _get_lib()
    if not lib:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, dim = x.shape
    if queries is None:
        queries = x[: min(256, n)]
    q = np.ascontiguousarray(queries, np.float32)
    nq = len(q)
    out = np.full((nq, k), -1, np.int32)
    secs = lib.turdb_hnsw_cpu_build_search(
        x.ctypes.data, n, dim, m, ef_construction, seed,
        q.ctypes.data, nq, k, ef_search, out.ctypes.data,
    )
    if secs < 0:
        return None
    # brute-force truth in chunks (one matmul per chunk keeps the
    # [nq, n] distance matrix bounded)
    xn = (x * x).sum(1)
    recalls = []
    for s in range(0, nq, 64):
        qc = q[s : s + 64]
        d = xn[None, :] - 2.0 * (qc @ x.T)
        truth = np.argpartition(d, k, axis=1)[:, :k]
        for row_p, row_t in zip(out[s : s + 64], truth):
            recalls.append(len(set(row_p.tolist()) & set(row_t.tolist())) / k)
    return {
        "seconds": float(secs),
        "vps": n / float(secs) if secs > 0 else float("inf"),
        "recall": float(np.mean(recalls)),
    }


# ---------------------------------------------------------------------------
# OLTP hot-path extension (oltp.c — CPython API module)
# ---------------------------------------------------------------------------

_OLTP = None


def _build_oltp() -> str | None:
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    return _compile([os.path.join(_HERE, "oltp.c")], "_turdb_torch_oltp",
                    ["g++", "-x", "c", "-O3", "-shared", "-fPIC", f"-I{inc}"], timeout=180)


def oltp():
    """The _turdb_oltp extension module, or None (Python fallbacks)."""
    global _OLTP
    if _OLTP is None:
        path = _build_oltp()
        if path is None:
            _OLTP = False
        else:
            try:
                import importlib.machinery
                import importlib.util

                loader = importlib.machinery.ExtensionFileLoader(
                    "_turdb_oltp", path
                )
                spec = importlib.util.spec_from_loader("_turdb_oltp", loader)
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
                _OLTP = mod
            except Exception:
                _OLTP = False
    return _OLTP if _OLTP else None
