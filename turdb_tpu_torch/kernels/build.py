"""Build the hand-written CUDA kernels and load them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles each `csrc/*.cu`
into an object, one nvcc process per source, all started together, and
links the objects into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds). The library lands in
`build/turdb_kernels/` under the repository root, named by a hash of the
sources and flags, and is built at first use. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "turdb_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
GREEDY_LEVELS_MAX = 8   # levels one K9 launch walks (csrc/hnsw_greedy.cu)


class GreedyLevels(ctypes.Structure):
    """K9's levels, passed by value: the adjacencies walked, top first."""

    _fields_ = [("adj", _P * GREEDY_LEVELS_MAX), ("n", _I)]


# argtypes of each C entry point, in the order of its declaration
SIGNATURES = {
    # vals, B, N, rown, coln, colvalid, epilogue, clamp, k, out_d, out_i,
    # cand_key, cand_pos, counters, cell_block, u, out_blocks, stream
    "topk_rows": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                  _P],
    # vals, B, N, rown, coln, colvalid, epilogue, clamp, k, ctas, out_d, out_i,
    # cell_block, u, out_blocks, stream
    "topk_rows_wide": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    # q, qn, cells, B, P, pvecs, pnorms, members, alive, allowed, L, d,
    # metric, k, m, replicated, mode, chunk, sc_key, sc_pos, sc_id,
    # out_d, out_i, out_pos, stream
    "ivf_probe_f32": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # qc, qs, qsum, qn, cells, B, P, codes, mins, scales, pnorms, members,
    # alive, allowed, L, d, metric, k, m, replicated, mode, chunk, sc_key,
    # sc_pos, sc_id, out_d, out_i, out_pos, stream
    "ivf_probe_sq8": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P],
    # qc, qs, qsum, qn, cells, B, P, codes, mins, scales, pnorms, members,
    # alive, allowed, NB, L, d, metric, work, dist, stream
    "ivf_probe_sq8_cells": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # L, d, device, ok (no stream: a query of the cell-major pass's rule)
    "ivf_probe_sq8_cell_ok": [_I, _I, _I, _P],
    # cells, B, P, members, L, sel_d, sel_pos, k, m, replicated, mode, out_d,
    # out_i, out_pos, stream
    "ivf_probe_cells_finish": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P,
                               _P, _P, _P],
    # codes, meta, vectors, norms, q, qn, qc, qs, qsum, seed_i, seed_d, B,
    # S, allowed, d, deg, ef, iters, expand, rerank, k, metric, out_d,
    # out_i, out_stats, stream
    "hnsw_serve_beam": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                        _P, _P, _P],
    # B, S, d, deg, ef, iters, expand, rerank, out (no stream: a query of
    # K6's stage rule)
    "hnsw_serve_beam_stage": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # adj, vectors, norms, q, qn, seed_i, seed_d, B, S, allowed, d, deg,
    # ef, iters, expand, k_res, metric, out_cand_d, out_cand_i, out_res_d,
    # out_res_i, out_exp, out_stats, stream
    "hnsw_graph_beam": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I,
                        _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P, _P, _P],
    # B, S, d, deg, ef, iters, expand, k_res, bits, out (no stream: a query
    # of K8-SQ's stage rule)
    "hnsw_graph_beam_sq_stage": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # adj, codes, bits, mins, scales, norms, q, qn, seed_i, seed_d, B, S,
    # allowed, d, deg, ef, iters, expand, k_res, metric, out_cand_d,
    # out_cand_i, out_res_d, out_res_i, out_exp, out_stats, stream
    "hnsw_graph_beam_sq": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _P, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _P, _P],
    # levels, vectors, codes, bits, mins, scales, norms, q, qn, cur_i,
    # cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats, stream
    "hnsw_greedy": [GreedyLevels, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                    _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # vectors, norms, targets, cand, U, W, d, deg, sel_cap, alpha, metric,
    # out_i, out_d, out_pairs, stream
    "hnsw_select": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                    _P, _P, _P, _P],
    # vectors, cand, cand_d, U, W, d, deg, alpha, metric, out_i, out_d,
    # out_pairs, stream
    "hnsw_select_sorted": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                           _P, _P, _P, _P],
    # q, qn, cand_d, cand_i, cand_pos, B, r, rows, sq16, pnorms, mins,
    # scales, d, k, replicated, out_d, out_i, stream
    "ivf_rerank": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                   _P, _I, _I, _I, _P, _P, _P],
    # the wide forms (csrc/hnsw_select_wide.cu, graph_wide.cu, probe_wide.cu):
    # the fast form's arguments, then a global scratch of `grid` blocks
    # vectors, norms, targets, cand, U, W, d, deg, sel_cap, alpha, metric,
    # scratch, grid, out_i, out_d, out_pairs, stream
    "hnsw_select_wide": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                         _P, _I, _P, _P, _P, _P],
    # vectors, cand, cand_d, U, W, d, deg, alpha, metric, scratch, grid,
    # out_i, out_d, out_pairs, stream
    "hnsw_select_sorted_wide": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                                _P, _I, _P, _P, _P, _P],
    # vectors, norms, targets, cand, U, W, d, deg, sel_cap, alpha, metric,
    # ctas, out_i, out_d, out_pairs, stream (the cluster form)
    "hnsw_select_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                            _I, _P, _P, _P, _P],
    # vectors, cand, cand_d, U, W, d, deg, alpha, metric, ctas, out_i,
    # out_d, out_pairs, stream
    "hnsw_select_sorted_cluster": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                                   _I, _P, _P, _P, _P],
    "hnsw_graph_beam_wide": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I,
                             _I, _I, _I, _I, _I, _P, _P, _P,
                             _P, _P, _P, _P, _I, _P],
    "hnsw_graph_beam_sq_wide": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _P, _I, _I, _I, _I, _I, _I, _I, _P,
                                _P, _P, _P, _P, _P, _P, _I, _P],
    "hnsw_serve_beam_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                             _P, _P, _P, _I, _P],
    "hnsw_greedy_wide": [GreedyLevels, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # q, qn, cells, B, P, pvecs, pnorms, members, alive, allowed, L, d,
    # metric, dist, stream
    "ivf_probe_f32_dist": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # qc, qs, qsum, qn, cells, B, P, codes, mins, scales, pnorms, members,
    # alive, allowed, L, d, metric, dist, stream
    "ivf_probe_sq8_dist": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _I, _P, _P],
    # cells, B, P, members, L, sel_d, sel_pos, k, m, replicated, mode, wid,
    # flag, out_d, out_i, out_pos, stream
    "ivf_probe_tail_wide": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P,
                            _P, _P, _P, _P, _P],
    # q, qn, cand_d, cand_i, cand_pos, B, r, rows, sq16, pnorms, mins,
    # scales, d, replicated, table, ex, stream
    "ivf_rerank_dist": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _I,
                        _I, _P, _P, _P],
    # x (bf16), xn, n, cents (bf16), cn, C, d (a multiple of 16), r, out_i,
    # out_d, stream
    "kmeans_assign": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    # q, qn, qsum, B, codes, mins, scales, valid, N, d, ldr, c0, ld, chunk, k,
    # out_d, out_i, dist, ld_dist, rec, rec_ready, part, stream
    "sq8_scan": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _P, _P, _P, ctypes.c_longlong, _P, _I, _I, _P],
    # q, qn, cents, cnorms, B, C, d, P, mi, S, out_d, out_i, part, counters,
    # stream
    "cell_select": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}

# queries of the library that return a size: a wide form's scratch a block
# (W; deg, ef, iters, expand, k_res, rerank; a beam's 0 where its state fits
# shared memory), K2's and K7's wide forms' CTAs a row or target (n, k; W,
# d, presorted; 0: the global form) and the wide tail's table words a row
# (m, replicated, mode; 0: in shared memory), K5 wide's global claim table
# words a query (r, replicated; 0: each CTA's shared memory), K8-SQ
# wide's state bytes a block (deg, ef, iters, expand, k_res, d, bits; 0:
# shared memory beside its query row and staged rows), and K6 wide's state
# bytes a block and code rows a batch of its stage (deg, ef, iters, expand,
# rerank, d; bytes 0: shared memory beside the stage), and K12's shared
# memory a block (mi, d)
SIZES = {
    "hnsw_select_wide_bytes": [_I],
    "hnsw_beam_wide_bytes": [_I, _I, _I, _I, _I, _I],
    "topk_rows_wide_ctas": [_I, _I],
    "hnsw_select_wide_ctas": [_I, _I, _I],
    "ivf_probe_tail_wide_words": [_I, _I, _I],
    "ivf_rerank_dist_table_words": [_I, _I],
    "hnsw_beam_sq_wide_bytes": [_I, _I, _I, _I, _I, _I, _I],
    "hnsw_serve_beam_wide_bytes": [_I, _I, _I, _I, _I, _I],
    "hnsw_serve_beam_wide_rows": [_I, _I, _I, _I, _I, _I],
    "cell_select_smem": [_I, _I],
}

_lib: ctypes.CDLL | None = None
build_log = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libturdb_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [(src.name, p.returncode) for src, p in zip(_sources(), procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    build_log += res.stdout + res.stderr
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in SIZES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
