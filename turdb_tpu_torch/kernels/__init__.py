"""Wrappers of the hand-written CUDA kernels, their plain PyTorch versions,
and the launch counters.

    K1 ivf_probe_f32  csrc/ivf_probe.cu      fused f32 IVF probe + top-k / candidates
    K2 topk_rows      csrc/topk_rows.cu      exact per-row k-smallest
    K3 kmeans_assign  csrc/kmeans_assign.cu  bf16 nearest-centroid argmin / top-R
                                             (tensor cores)
    K4 ivf_probe_sq8  csrc/ivf_probe.cu      fused int8 (SQ8) IVF probe + top-k / candidates
                                             (cell-major + a K2 selection past one chunk)
    K5 ivf_rerank     csrc/ivf_rerank.cu     exact rerank over the f32 or SQ16 row store
    K6 hnsw_serve_beam  csrc/hnsw_beam.cu    HNSW int8 serving beam + exact rerank
    K7 hnsw_select      csrc/hnsw_select.cu  HNSW alpha-diversity neighbour selection
       hnsw_select_sorted                    ... its presorted mode (a beam's buffer)
    K8 hnsw_graph_beam  csrc/hnsw_beam.cu    HNSW graph beam over one level (f32 rows;
                                             over the SQ store, counted as hnsw_graph_beam_sq)
    K9 hnsw_greedy      csrc/hnsw_greedy.cu  HNSW greedy descent through one level or several
    K10 dense_blocks    csrc/topk_rows.cu    dense IVF: probed cells -> first-u distinct blocks
                                             (fused into K2: `topk_rows(..., cell_block=, u=)`)
    K11 sq8_scan        csrc/sq8_scan.cu     asymmetric L2 k-NN over a u8 store on the int8
                                             tensor cores (+ a K2 merge)
    K12 cell_select     csrc/cell_select.cu  IVF cell selection: q·Cᵀ and each query's P
                                             nearest cells in one launch (fp32 FFMA); the
                                             GEMM + K2 pair where its rule says

A wrapper given CPU tensors runs the plain version below, at any width;
given CUDA tensors it launches its kernel (built at first use) or raises.
There is no fallback after a failed build or launch, and none by shape.
Every kernel answers at any width a caller can index: past what a fast
form holds in shared memory or registers (SEL_MAX for the probes and the
rerank, EF_MAX / SLOTS_MAX / EXP_MAX for the beams, SELECT_W_MAX and
SELECT_SMEM_MAX for K7, DIM_MAX for the row readers) the wrapper launches
the kernel's wide form (csrc/hnsw_select_wide.cu, graph_wide.cu,
probe_wide.cu: state in a global scratch, or in shared memory where a
beam's or a probe tail's fits, rows read from device memory; K7's window
of rows in a thread block cluster's shared memory, `select_wide_ctas`),
counted under its own name (`<kernel>_wide`; K4's query-major pass as
`ivf_probe_sq8_wide_query`). K2 takes any k (past
SEL_MAX its wide form, counted as
`topk_rows_wide` too: a row's keys in a thread block cluster's shared
memory, `topk_wide_ctas`), K11 any k and any d (d-slices), and a caller
walks more levels than K9 holds in launches of at most GREEDY_LEVELS_MAX. Only
inputs no kernel can index (int32 lane positions) raise.
`launches[name]` counts kernel launches only.

Dims. The row kernels read rows 4 elements at a time: a row store whose
dim is not a multiple of 4 is copied zero-padded for each launch
(`_rows4`), and the queries with it (`pad_dim`), so a pad lane meets a
zero query lane.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from turdb_tpu_torch.kernels import build
from turdb_tpu_torch.ops.quantize import Sq8Rows, sq16_decode

INF = math.inf

# epilogues of topk_rows over a dot matrix (EPI_NONE selects on x itself)
EPI_NONE, EPI_L2, EPI_COS, EPI_IP = 0, 1, 2, 3
# widest selection a kernel takes (csrc/select.cuh)
SEL_MAX = 2048
# lanes one probe block scores and selects from; a wider probe (P*L) runs
# one block per chunk of lanes and a merge (csrc/ivf_probe.cu), or, in K4,
# the cell-major pass (`probe_route`)
PROBE_CHUNK_LANES = 4096
# K4's cell-major pass: the most bytes of [rows, P*L] f32 distances one of
# its slices of queries writes (as `_probe_plain` caps its temporaries)
CELL_DIST_BYTES = 1 << 29
# probe output modes: the final top-k, or the r best lanes for the rerank
MODE_TOPK, MODE_CAND = 0, 1

# the wide forms, each counted under its own name
WIDE = ("topk_rows_wide", "ivf_probe_f32_wide", "ivf_probe_sq8_wide",
        "ivf_probe_sq8_wide_query", "ivf_rerank_wide", "hnsw_serve_beam_wide",
        "hnsw_select_wide", "hnsw_graph_beam_wide", "hnsw_select_sorted_wide",
        "hnsw_graph_beam_sq_wide", "hnsw_greedy_wide")
launches = {"ivf_probe_f32": 0, "topk_rows": 0, "kmeans_assign": 0,
            "ivf_probe_sq8": 0, "ivf_rerank": 0, "hnsw_serve_beam": 0,
            "hnsw_select": 0, "hnsw_graph_beam": 0, "hnsw_select_sorted": 0,
            "hnsw_graph_beam_sq": 0, "hnsw_greedy": 0, "dense_blocks": 0,
            "sq8_scan": 0, "cell_select": 0, **{name: 0 for name in WIDE}}
# blocks of a wide beam or selection launch at most (each walks its share of
# the queries over its own scratch slice)
WIDE_BLOCKS = 512
# widest row a row-reading kernel (K6-K9) keeps in its buffers
DIM_MAX = 4096


def reset_launches() -> None:
    """Zero `launches`."""
    for name in launches:
        launches[name] = 0


def pad_dim(x: torch.Tensor) -> torch.Tensor:
    """`x` [..., d] with zero columns up to a multiple of 4 (the kernels read
    rows 4 elements at a time); `x` itself when d already is one."""
    extra = -x.shape[-1] % 4
    return x if extra == 0 else torch.nn.functional.pad(x, (0, extra))


def _rows4(t: torch.Tensor) -> torch.Tensor:
    """The rows a kernel reads 4 elements at a time: `t` when its dim is a
    multiple of 4, else a zero-padded copy (a copy a launch)."""
    return t if t.shape[-1] % 4 == 0 else pad_dim(t.contiguous())


def _rows4_store(vectors):
    """`_rows4` of an f32 row store or of an `Sq8Rows` store's codes."""
    if isinstance(vectors, Sq8Rows):
        return Sq8Rows(_rows4(vectors.codes), vectors.mins, vectors.scales)
    return _rows4(vectors)


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when all are on the CPU."""
    devs = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devs}
    if kinds == {"cuda"} and len(devs) == 1:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on one cuda device or all on cpu, got {devs}")


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


# the C entry points, looked up in the library once each
_entry: dict = {}


def _launch(name, device, *args, counter=""):
    """Launch kernel `name` on `device`, the device of its tensors, on that
    device's current stream, whatever device is current: a mesh keeps
    shards on several cards and a kernel must run where its pointers live.
    The device is made current only for the launch, and only when it is
    not already. The launch adds one to `launches[counter]` (the entry
    point's own name by default; None: a later step of a kernel whose
    first launch counted)."""
    fn = _entry.get(name)
    if fn is None:
        fn = _entry[name] = getattr(build.library(), name)
    cur = torch.cuda.current_device()
    index = cur if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == cur:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        # an argument past a kernel's limits (selection width, shared
        # memory) comes back as a CUDA error: the limits live in csrc/
        msg = build.library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    if counter is not None:
        launches[counter or name] += 1


def _as_u8(mask):
    return None if mask is None else mask.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# K2: exact per-row k-smallest
# ---------------------------------------------------------------------------

def _row_values(x, rown, coln, colvalid, epilogue, clamp):
    if epilogue == EPI_L2:
        v = (rown[:, None] + coln[None, :]) - 2.0 * x
        if clamp:
            v = torch.clamp_min(v, 0.0)
    elif epilogue == EPI_COS:
        v = 1.0 - x
    elif epilogue == EPI_IP:
        v = -x
    else:
        v = x
    if colvalid is not None:
        v = torch.where(colvalid[None, :], v, INF)
    return v


def topk_rows_plain(x, k, rown=None, coln=None, colvalid=None,
                    epilogue=EPI_NONE, clamp=False):
    v = _row_values(x, rown, coln, colvalid, epilogue, clamp)
    vals, pos = torch.sort(v, dim=-1, stable=True)
    return vals[:, :k].contiguous(), pos[:, :k].to(torch.int32)


# K2 selects a row longer than TOPK_SHORT_MAX in segments of at most
# TOPK_SEG_W columns, merged by the row's last block; shorter rows take the
# warp path (csrc/topk_rows.cu)
TOPK_SEG_W, TOPK_SHORT_MAX = 8192, 2048
# per-device row counters of the segment merge: zero between launches (the
# kernel resets what it counts), so launches that share them run in one
# stream's order
_row_counters: dict = {}


def topk_segments(n: int) -> int:
    """The segments K2 cuts a row of n columns into (1: no merge); they
    are of equal width, ceil(n / segments)."""
    return -(-n // TOPK_SEG_W) if n > TOPK_SHORT_MAX else 1


def topk_wide_ctas(n: int, k: int) -> int:
    """CTAs a row of K2's wide form (k > SEL_MAX) over rows of n columns on
    the current card: a thread block cluster of 3 to 16, an equal segment
    of the row each; 0 for the global form (csrc/topk_rows.cu
    `topk_rows_wide_ctas` holds the rule)."""
    return int(build.library().topk_rows_wide_ctas(n, k))


def _counters(device, n):
    """At least n of the device's zeroed ints (K2's rows, K12's query
    tiles; each launch leaves what it counted at zero)."""
    counters = _row_counters.get(device)
    if counters is None or counters.numel() < n:
        counters = _row_counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                       device=device)
    return counters


def _topk_scratch(b, n, k, device):
    """(candidate keys, candidate positions, row counters) of a segmented
    launch; for the global wide form (k > SEL_MAX, `topk_wide_ctas` 0) the
    rows' keys [B, N] and their [B, pow2(k)] 64-bit winners; else Nones."""
    if k > SEL_MAX:
        return (torch.empty(b * n, dtype=torch.int32, device=device),
                torch.empty(b * 2 * (1 << (k - 1).bit_length()), dtype=torch.int32,
                            device=device), None)
    nseg = topk_segments(n)
    if nseg == 1:
        return None, None, None
    cand = torch.empty((2, b * nseg * k), dtype=torch.int32, device=device)
    return cand[0], cand[1], _counters(device, b)


def topk_rows(x: torch.Tensor, k: int, *, rown=None, coln=None, colvalid=None,
              epilogue: int = EPI_NONE, clamp: bool = False, cell_block=None,
              u: int | None = None):
    """Exact k smallest of each row of `x` [B, N] f32, after an optional
    epilogue: L2 `(rown[b] + coln[j]) − 2·x[b, j]` (clamped at 0 if
    `clamp`), COS `1 − x`, IP `−x`; lanes where `colvalid` [N] is False
    become +inf. Returns ([B, k] values ascending, [B, k] int32 column
    positions); ties go to the lower position, as `lax.top_k` does. On
    CUDA one launch a call, at any k: past SEL_MAX its wide form, counted
    as `topk_rows_wide` too (a row's keys in a cluster's shared memory,
    `topk_wide_ctas`; past that in a scratch row).

    With `cell_block` [C] int32 (the dense IVF map, C = N) and `u`, K10
    runs in the same launch on each row's winners: a third output [B,
    min(u, k)] holds `dense_blocks_plain(cell_block, positions, u)`, the
    first u distinct blocks of the selected cells (the launch counts as
    `dense_blocks` too)."""
    b, n = x.shape
    if not 0 < k <= n:
        raise ValueError(f"topk_rows: need 0 < k <= N, got k={k}, N={n}")
    if epilogue == EPI_L2 and (rown is None or coln is None):
        raise ValueError("topk_rows: the L2 epilogue needs rown and coln")
    if cell_block is not None and (u is None or u < 1):
        raise ValueError(f"topk_rows: the dense blocks need u >= 1, got {u}")
    if not _on_cuda(x, rown, coln, colvalid, cell_block):
        vals, pos = topk_rows_plain(x, k, rown, coln, colvalid, epilogue, clamp)
        if cell_block is None:
            return vals, pos
        return vals, pos, dense_blocks_plain(cell_block, pos, u)
    _check(x, "x", torch.float32, (b, n))
    if epilogue == EPI_L2:
        _check(rown, "rown", torch.float32, (b,))
        _check(coln, "coln", torch.float32, (n,))
    if colvalid is not None:
        _check(colvalid, "colvalid", torch.bool, (n,))
    if cell_block is not None:
        _check(cell_block, "cell_block", torch.int32, cell_block.shape[:1])
    out_d = torch.empty((b, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=x.device)
    out_b = (None if cell_block is None else
             torch.empty((b, min(u, k)), dtype=torch.int32, device=x.device))
    ctas = topk_wide_ctas(n, k) if k > SEL_MAX else 0
    if b:
        args = (x.data_ptr(), b, n, _ptr(rown) if epilogue == EPI_L2 else None,
                _ptr(coln) if epilogue == EPI_L2 else None, _ptr(_as_u8(colvalid)), epilogue,
                int(clamp), k)
        blocks = (_ptr(cell_block), u or 0, _ptr(out_b))
        if ctas:
            _launch("topk_rows_wide", x.device, *args, ctas, out_d.data_ptr(),
                    out_i.data_ptr(), *blocks, counter="topk_rows")
        else:
            _launch("topk_rows", x.device, *args, out_d.data_ptr(), out_i.data_ptr(),
                    *map(_ptr, _topk_scratch(b, n, k, x.device)), *blocks)
        if k > SEL_MAX:
            launches["topk_rows_wide"] += 1
        if cell_block is not None:
            launches["dense_blocks"] += 1
    return (out_d, out_i) if cell_block is None else (out_d, out_i, out_b)


# ---------------------------------------------------------------------------
# K1: fused f32 IVF probe
# ---------------------------------------------------------------------------

def mask_duplicates(ids: torch.Tensor, dists: torch.Tensor, invalid_id: int = -1):
    """Within each row keep the first occurrence of each id; later
    duplicates (and `invalid_id`) get distance +inf and id `invalid_id`.
    The plain version of K1's replica dedup."""
    n = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool, device=ids.device), -1)
    dup = torch.any(eq & earlier, dim=-1) | (ids == invalid_id)
    return (torch.where(dup, invalid_id, ids),
            torch.where(dup, INF, dists))


def _probe_select_plain(dist, ids, cells, lcap, k, m, replicated, mode):
    """The selection after a probe: dist / ids [b, P*L] -> the top-k
    (dedup by first copy under replicas) or the m best candidates with
    their flat positions cell*L + lane."""
    if mode == MODE_CAND:
        cd, pos = topk_rows_plain(dist, m)
        pos = pos.long()
        flat = torch.gather(cells.long(), 1, pos // lcap) * lcap + pos % lcap
        return cd, torch.gather(ids, 1, pos).to(torch.int32), flat.to(torch.int32)
    if replicated:
        d0, pos = topk_rows_plain(dist, m)
        i0, d0 = mask_duplicates(torch.gather(ids, 1, pos.long()), d0)
        dk, pos = topk_rows_plain(d0, k)
        ik = torch.gather(i0, 1, pos.long())
    else:
        dk, pos = topk_rows_plain(dist, k)
        ik = torch.gather(ids, 1, pos.long())
    return dk, torch.where(torch.isinf(dk), -1, ik).to(torch.int32)


def _probe_plain(score, cells, members, alive, allowed, row_bytes, k, m, replicated, mode):
    """Shared body of K1's and K4's plain versions: `score(s, src)` gives
    the [b, P, L] distances of queries s:s+b over their cells `src`."""
    b, p = cells.shape
    lcap = members.shape[1]
    # the [b, P, L, d] gather is bounded to ~512 MB of temporaries
    bmax = max(1, (1 << 29) // (p * lcap * row_bytes))
    outs = []
    for s in range(0, b, bmax):
        src = cells[s:s + bmax].long()
        mem = members[src]                                   # [b, P, L]
        live = (mem >= 0) & alive[src]
        if allowed is not None:
            live = live & allowed[src]
        nb = src.shape[0]
        dist = torch.where(live, score(s, src), INF).reshape(nb, p * lcap)
        outs.append(_probe_select_plain(dist, mem.reshape(nb, p * lcap), cells[s:s + bmax],
                                        lcap, k, m, replicated, mode))
    width = m if mode == MODE_CAND else k
    if not outs:
        empty = torch.empty((0, width), dtype=torch.int32, device=cells.device)
        return (torch.empty((0, width), device=cells.device), empty,
                *((empty,) if mode == MODE_CAND else ()))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def ivf_probe_f32_plain(q, qn, cells, pvecs, pnorms, members, alive, allowed,
                        metric, k, m, replicated, mode=MODE_TOPK):
    def score(s, src):
        dots = torch.einsum("bd,bpld->bpl", q[s:s + src.shape[0]], pvecs[src])
        if metric == 0:
            return (qn[s:s + src.shape[0], None, None] + pnorms[src]) - 2.0 * dots
        if metric == 1:
            return 1.0 - dots
        return -dots

    return _probe_plain(score, cells, members, alive, allowed, 4 * pvecs.shape[2],
                        k, m, replicated, mode)


def _probe_checks(name, cells, members, alive, allowed, k, m, replicated, mode):
    b, p = cells.shape
    nb, lcap = members.shape
    n_lanes = p * lcap
    if max(nb, p) * lcap >= 1 << 31:
        raise ValueError(f"{name}: lane indices are int32; got {nb} cells, P={p}, L={lcap}")
    if mode not in (MODE_TOPK, MODE_CAND):
        raise ValueError(f"{name}: unknown mode {mode}")
    if not 0 < k <= m <= n_lanes:
        raise ValueError(f"{name}: need 0 < k <= m <= P*L; got k={k}, m={m}, P*L={n_lanes}")
    if mode == MODE_TOPK and not replicated and m != k:
        raise ValueError(f"{name}: m must equal k without replicas")
    if mode == MODE_CAND and m != k:
        raise ValueError(f"{name}: candidate mode returns m = k lanes")
    _check(cells, "cells", torch.int32, (b, p))
    _check(members, "members", torch.int32, (nb, lcap))
    _check(alive, "alive", torch.bool, (nb, lcap))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, (nb, lcap))


def _probe_outputs(b, k, m, mode, device):
    """Outputs of a probe: distances, ids, and in candidate mode positions."""
    width = m if mode == MODE_CAND else k
    out_d = torch.empty((b, width), dtype=torch.float32, device=device)
    out_i = torch.empty((b, width), dtype=torch.int32, device=device)
    out_pos = torch.empty((b, width), dtype=torch.int32, device=device) if mode == MODE_CAND else None
    return out_d, out_i, out_pos


def _probe_scratch(b, p, lcap, m, device):
    """The scratch rows of a query-major launch that runs in chunks."""
    nchunks = -(-p * lcap // PROBE_CHUNK_LANES)
    return ([torch.empty((b, nchunks * m), dtype=torch.int32, device=device) for _ in range(3)]
            if nchunks > 1 else [None] * 3)


def _cell_fits(lcap: int, d: int, device=None) -> bool:
    """Whether one block of K4's cell-major pass takes a cell of lcap lanes
    at width d on `device` (default: the current card): the kernel
    library's rule (csrc/ivf_probe.cu cell_fits: codes in 16-byte words and
    the block's shared memory within the card's limit)."""
    fn = _entry.get("ivf_probe_sq8_cell_ok")
    if fn is None:
        fn = _entry["ivf_probe_sq8_cell_ok"] = build.library().ivf_probe_sq8_cell_ok
    index = torch.cuda.current_device() if device is None or device.index is None else device.index
    ok = ctypes.c_int(0)
    err = fn(lcap, d, index, ctypes.byref(ok))
    if err != 0:
        msg = build.library().kernel_error_string(err).decode()
        raise RuntimeError(f"ivf_probe_sq8_cell_ok failed: {msg} ({err})")
    return bool(ok.value)


def probe_route(p: int, lcap: int, d: int, device=None, fits=_cell_fits) -> str:
    """The order K4 scores a probe of p cells of lcap lanes at width d in.
    "cell": when the probe is wider than one chunk of lanes (p*lcap >
    PROBE_CHUNK_LANES) and `fits(lcap, d, device)` (the kernel library's
    rule for one cell-major block), the (query, probe) pairs are grouped by
    cell and each cell is read once for all the queries that probe it.
    "query": a block per query (or per chunk of its lanes, merged)."""
    if p * lcap > PROBE_CHUNK_LANES and fits(lcap, d, device):
        return "cell"
    return "query"


def _probe_result(out_d, out_i, out_pos):
    return (out_d, out_i) if out_pos is None else (out_d, out_i, out_pos)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it when its data is not 16-byte aligned (a wide
    form reads its rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tail_scratch(rows, m, replicated, mode, device):
    """The wide tail's global scratch for `rows` rows of m winners: (claim
    table [rows, words], ids [rows, m]) where a row's winners pass a
    block's shared memory, else (None, None) (csrc/probe_wide.cu
    `ivf_probe_tail_wide_words` holds the rule)."""
    words = int(build.library().ivf_probe_tail_wide_words(m, int(replicated), mode))
    if not words:
        return None, None
    return (torch.empty(rows * words, dtype=torch.int32, device=device),
            torch.empty(rows * m, dtype=torch.int32, device=device))


def _probe_tail(cells, members, sel_d, sel_pos, k, m, replicated, mode, out, scratch,
                counter=""):
    """The probe's outputs `out` (rows of it) from K2's selection of m
    winners a row: the fast tail (m <= SEL_MAX, a block's shared memory)
    or the wide one (`scratch` from `_tail_scratch`)."""
    rows, p = cells.shape
    lcap = members.shape[1]
    out_d, out_i, out_pos = out
    if m <= SEL_MAX:
        _launch("ivf_probe_cells_finish", cells.device, cells.data_ptr(), rows, p,
                members.data_ptr(), lcap, sel_d.data_ptr(), sel_pos.data_ptr(), k, m,
                int(replicated), mode, out_d.data_ptr(), out_i.data_ptr(), _ptr(out_pos),
                counter=None)
    else:
        _launch("ivf_probe_tail_wide", cells.device, cells.data_ptr(), rows, p,
                members.data_ptr(), lcap, sel_d.data_ptr(), sel_pos.data_ptr(), k, m,
                int(replicated), mode, *map(_ptr, scratch), out_d.data_ptr(),
                out_i.data_ptr(), _ptr(out_pos), counter=counter)


def _probe_wide(name, dist_args, cells, members, k, m, replicated, mode, counter=None):
    """A probe past SEL_MAX winners or past DIM_MAX (K1, K4 query-major):
    for each slice of queries whose [rows, P*L] f32 distances fit
    CELL_DIST_BYTES, one launch writes every lane's distance
    (`<name>_dist`, counted as `counter`, by default `<name>_wide`;
    `dist_args(s, e, dist)` gives its arguments for queries s:e), K2
    selects each row's m best by (distance, position), and the tail drops
    later copies of an id and writes the outputs."""
    b, p = cells.shape
    lcap = members.shape[1]
    dev = cells.device
    rows = max(1, min(b, CELL_DIST_BYTES // (4 * p * lcap)))
    dist = torch.empty((rows, p * lcap), dtype=torch.float32, device=dev)
    scratch = _tail_scratch(rows, m, replicated, mode, dev)
    out = _probe_outputs(b, k, m, mode, dev)
    for s in range(0, b, rows):
        e = min(b, s + rows)
        _launch(f"{name}_dist", dev, *dist_args(s, e, dist), counter=counter or f"{name}_wide")
        sel_d, sel_pos = topk_rows(dist[:e - s], m)
        _probe_tail(cells[s:e], members, sel_d, sel_pos, k, m, replicated, mode,
                    [None if t is None else t[s:] for t in out], scratch, counter=None)
    return _probe_result(*out)


def ivf_probe_f32(q, qn, cells, pvecs, pnorms, members, alive, allowed=None, *,
                  metric: int, k: int, m: int, replicated: bool, mode: int = MODE_TOPK):
    """Score the probed cells of each query and select from them.

    q [B, d] f32, qn [B] = ‖q‖², cells [B, P] int32 (the probed cells),
    pvecs [NB, L, d] f32, pnorms [NB, L], members [NB, L] int32 (-1 = empty),
    alive / allowed [NB, L] bool. Distances follow `metric` (Metric.value):
    L2 `(qn + pnorms) − 2·dot`, COSINE `1 − dot`, IP `−dot`; dead, empty
    and unallowed lanes are +inf. Lanes are ordered cell by cell as
    `cells` lists them; ties go to the lower lane.

    MODE_TOPK: without `replicated` the k smallest are returned; with it
    the m smallest are taken, later copies of an id dropped, and the first
    k survivors kept. Returns ([B, k] f32 ascending, [B, k] int32 ids, -1
    where +inf).
    MODE_CAND (k == m): the m smallest lanes, before any dedup, as
    ([B, m] distances, [B, m] ids, [B, m] int32 flat positions cell*L + lane).
    On CUDA m > SEL_MAX or d > DIM_MAX (the query row the fast form keeps in
    shared memory) runs the wide form (`_probe_wide`: every lane's distance
    written, one K2 selection, the dedup tail; counted as
    `ivf_probe_f32_wide`)."""
    b, p = cells.shape
    nb, lcap, d = pvecs.shape
    _probe_checks("ivf_probe_f32", cells, members, alive, allowed, k, m, replicated, mode)
    if metric not in (0, 1, 2):
        raise ValueError(f"ivf_probe_f32: unknown metric {metric}")
    if not _on_cuda(q, qn, cells, pvecs, pnorms, members, alive, allowed):
        return ivf_probe_f32_plain(q, qn, cells, pvecs, pnorms, members,
                                   alive, allowed, metric, k, m, replicated, mode)
    q, pvecs = pad_dim(q), _rows4(pvecs)
    d = pvecs.shape[2]
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(pvecs, "pvecs", torch.float32, (nb, lcap, d))
    _check(pnorms, "pnorms", torch.float32, (nb, lcap))
    if pvecs.data_ptr() % 16:
        raise ValueError("ivf_probe_f32: rows are read as float4, so pvecs must be 16-byte "
                         "aligned")
    if m > SEL_MAX or d > DIM_MAX:
        q = _aligned16(q)
        return _probe_wide("ivf_probe_f32", lambda s, e, dist: (
            q[s:].data_ptr(), qn[s:].data_ptr(), cells[s:].data_ptr(), e - s, p,
            pvecs.data_ptr(), pnorms.data_ptr(), members.data_ptr(), _ptr(_as_u8(alive)),
            _ptr(_as_u8(allowed)), lcap, d, metric, dist.data_ptr()),
                           cells, members, k, m, replicated, mode)
    out_d, out_i, out_pos = _probe_outputs(b, k, m, mode, q.device)
    scratch = _probe_scratch(b, p, lcap, m, q.device)
    if b:
        _launch("ivf_probe_f32", q.device, q.data_ptr(), qn.data_ptr(), cells.data_ptr(),
                b, p, pvecs.data_ptr(), pnorms.data_ptr(), members.data_ptr(),
                _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), lcap, d, metric,
                k, m, int(replicated), mode, PROBE_CHUNK_LANES, *map(_ptr, scratch),
                out_d.data_ptr(), out_i.data_ptr(), _ptr(out_pos))
    return _probe_result(out_d, out_i, out_pos)


# ---------------------------------------------------------------------------
# K4: fused int8 (SQ8) IVF probe
# ---------------------------------------------------------------------------

def _int8_dots(qc, codes):
    """Exact int8 · int8 dots q [B, d] x codes [B, ..., d] -> [B, ...] f32.
    The products summed in fp32 are exact integers while every partial
    sum stays below 2**24 (d <= 1024); wider rows sum in fp64."""
    acc = torch.float32 if qc.shape[-1] <= 1024 else torch.float64
    return torch.einsum("bd,b...d->b...", qc.to(acc), codes.to(acc)).float()


def sq8_epilogue(doti, base, scale, qn, qsum, qs, norm, metric):
    """Distance from an exact int8 dot (`_approx_dist` of the reference's
    hnsw_serve.py): q·x̂ = base·Σq + scale·(qs·dot); L2 `(qn − 2·q·x̂) +
    norm` (unclamped), COSINE `1 − q·x̂`, IP `−q·x̂`."""
    q_dot_x = base * qsum + scale * (qs * doti)
    if metric == 0:
        return qn - 2.0 * q_dot_x + norm
    if metric == 1:
        return 1.0 - q_dot_x
    return -q_dot_x


def ivf_probe_sq8_plain(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members,
                        alive, allowed, k, m, replicated, mode=MODE_TOPK, metric=0):
    d = codes.shape[2]

    def score(s, src):
        e = s + src.shape[0]
        doti = _int8_dots(qc[s:e], codes[src])
        return sq8_epilogue(doti, mins[src], scales[src], qn[s:e, None, None],
                            qsum[s:e, None, None], qs[s:e, None, None], pnorms[src], metric)

    return _probe_plain(score, cells, members, alive, allowed, 4 * d,
                        k, m, replicated, mode)


def ivf_probe_sq8(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                  allowed=None, *, k: int, m: int, replicated: bool, mode: int = MODE_TOPK,
                  metric: int = 0):
    """K1's probe over the int8 store: qc [B, d] int8, qs / qsum / qn [B]
    (`ops.quantize.quantize_queries`), codes [NB, L, d] int8 centred,
    mins [NB, L] m′ = min + 128·scale, scales [NB, L], pnorms [NB, L] the
    exact ‖x‖². The distance is `sq8_epilogue` of the int8 dot: for
    `metric` 0 (the IVF index's, whatever its own metric) `qn −
    2·(m′·qsum + scale·(qs·(qc·code))) + pnorms`; 1 and 2 are the HNSW
    serving pack's COSINE and IP seeding. Selection, modes and returns as
    `ivf_probe_f32`. On CUDA a probe wider than one chunk of lanes runs
    cell-major (`probe_route`), and its selection is a K2 launch. Past
    m = SEL_MAX the tail is the wide one (counted as `ivf_probe_sq8_wide`),
    and the query-major route writes every lane's distance for K2 to select
    from (`_probe_wide`, counted as `ivf_probe_sq8_wide_query`) in place of
    its in-block selection, as it does past d = DIM_MAX."""
    b, p = cells.shape
    nb, lcap, d = codes.shape
    _probe_checks("ivf_probe_sq8", cells, members, alive, allowed, k, m, replicated, mode)
    if metric not in (0, 1, 2):
        raise ValueError(f"ivf_probe_sq8: unknown metric {metric}")
    if not _on_cuda(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                    allowed):
        return ivf_probe_sq8_plain(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms,
                                   members, alive, allowed, k, m, replicated, mode, metric)
    qc, codes = pad_dim(qc), _rows4(codes)
    d = codes.shape[2]
    _check(qc, "qc", torch.int8, (b, d))
    for t, name in ((qs, "qs"), (qsum, "qsum"), (qn, "qn")):
        _check(t, name, torch.float32, (b,))
    _check(codes, "codes", torch.int8, (nb, lcap, d))
    for t, name in ((mins, "mins"), (scales, "scales"), (pnorms, "pnorms")):
        _check(t, name, torch.float32, (nb, lcap))
    if codes.data_ptr() % 4 or qc.data_ptr() % 4:
        raise ValueError("ivf_probe_sq8: codes are read as 32-bit words, so codes / qc must "
                         "be 4-byte aligned")
    if b and probe_route(p, lcap, d, qc.device) == "cell":
        return _probe_sq8_cells(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members,
                                alive, allowed, k, m, replicated, mode, metric)
    if m > SEL_MAX or d > DIM_MAX:
        return _probe_wide("ivf_probe_sq8", lambda s, e, dist: (
            qc[s:].data_ptr(), qs[s:].data_ptr(), qsum[s:].data_ptr(), qn[s:].data_ptr(),
            cells[s:].data_ptr(), e - s, p, codes.data_ptr(), mins.data_ptr(), scales.data_ptr(),
            pnorms.data_ptr(), members.data_ptr(), _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)),
            lcap, d, metric, dist.data_ptr()),
                           cells, members, k, m, replicated, mode, "ivf_probe_sq8_wide_query")
    out_d, out_i, out_pos = _probe_outputs(b, k, m, mode, qc.device)
    scratch = _probe_scratch(b, p, lcap, m, qc.device)
    if b:
        _launch("ivf_probe_sq8", qc.device, qc.data_ptr(), qs.data_ptr(), qsum.data_ptr(),
                qn.data_ptr(), cells.data_ptr(), b, p, codes.data_ptr(), mins.data_ptr(),
                scales.data_ptr(), pnorms.data_ptr(), members.data_ptr(),
                _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), lcap, d, metric, k, m,
                int(replicated), mode, PROBE_CHUNK_LANES, *map(_ptr, scratch),
                out_d.data_ptr(), out_i.data_ptr(), _ptr(out_pos))
    return _probe_result(out_d, out_i, out_pos)


def _probe_sq8_cells(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                     allowed, k, m, replicated, mode, metric):
    """K4's cell-major pass, in slices of queries whose [rows, P*L]
    distances fit CELL_DIST_BYTES: the pairs grouped by cell and every
    lane's distance written (one launch a slice, counted as K4's), the m
    best of each row by (distance, position) from K2, and the tail that
    turns them into the probe's outputs (past SEL_MAX the wide tail,
    counted as `ivf_probe_sq8_wide`)."""
    b, p = cells.shape
    nb, lcap, d = codes.shape
    dev = qc.device
    if codes.data_ptr() % 16 or qc.data_ptr() % 16:
        raise ValueError("ivf_probe_sq8: the cell-major pass copies 16-byte words, so codes "
                         "and qc must be 16-byte aligned")
    rows = min(b, max(1, CELL_DIST_BYTES // (4 * p * lcap)))
    work = torch.empty(2 * nb + rows * p, dtype=torch.int32, device=dev)
    dist = torch.empty((rows, p * lcap), dtype=torch.float32, device=dev)
    scratch = _tail_scratch(rows, m, replicated, mode, dev) if m > SEL_MAX else None
    out = _probe_outputs(b, k, m, mode, dev)
    for s in range(0, b, rows):
        e = min(b, s + rows)
        _launch("ivf_probe_sq8_cells", dev, qc[s:].data_ptr(), qs[s:].data_ptr(),
                qsum[s:].data_ptr(), qn[s:].data_ptr(), cells[s:].data_ptr(), e - s, p,
                codes.data_ptr(), mins.data_ptr(), scales.data_ptr(), pnorms.data_ptr(),
                members.data_ptr(), _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), nb, lcap, d,
                metric, work.data_ptr(), dist.data_ptr(), counter="ivf_probe_sq8")
        sel_d, sel_pos = topk_rows(dist[:e - s], m)
        _probe_tail(cells[s:e], members, sel_d, sel_pos, k, m, replicated, mode,
                    [None if t is None else t[s:] for t in out], scratch,
                    counter="ivf_probe_sq8_wide")
    return _probe_result(*out)


# ---------------------------------------------------------------------------
# K5: exact rerank
# ---------------------------------------------------------------------------

def _rerank_table(b, r, replicated, device):
    """K5 wide's global claim table [b, words] where a CTA's shared memory
    cannot hold one over r ids, else None (csrc/probe_wide.cu
    `ivf_rerank_dist_table_words` holds the rule)."""
    words = int(build.library().ivf_rerank_dist_table_words(r, int(replicated)))
    return torch.empty((b, words), dtype=torch.int32, device=device) if words else None


def ivf_rerank_plain(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins, scales, k,
                     replicated):
    d = pvecs.shape[-1]
    pos = cand_pos.long()
    flat = pvecs.reshape(-1, d)
    if pvecs.dtype == torch.int16:
        vecs = sq16_decode(flat[pos], mins.reshape(-1)[pos], scales.reshape(-1)[pos])
    else:
        vecs = flat[pos]
    dots = torch.einsum("bd,brd->br", q, vecs)
    exact = (qn[:, None] + pnorms.reshape(-1)[pos]) - 2.0 * dots
    exact = torch.where(torch.isinf(cand_d), INF, exact)
    ids = cand_i
    if replicated:
        ids, exact = mask_duplicates(ids, exact)
    dk, sel = topk_rows_plain(exact, k)
    ik = torch.gather(ids, 1, sel.long())
    return dk, torch.where(torch.isinf(dk), -1, ik).to(torch.int32)


def ivf_rerank(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins=None, scales=None, *,
               k: int, replicated: bool):
    """Exact L2 over a probe's r candidates (`ivf_probe_*` in MODE_CAND).

    q [B, d] f32, qn [B]; cand_d / cand_i / cand_pos [B, r] (probe
    distance, id, flat position cell*L + lane); pvecs [NB, L, d] f32, or
    int16 holding the SQ16 store's uint16 bits with mins (m′) and scales
    [NB, L]; pnorms [NB, L] the exact ‖x‖². A candidate whose probe
    distance is ±inf stays +inf; under `replicated` later copies of an id
    (and id -1) are dropped. Returns the k smallest by (distance,
    candidate index): ([B, k] f32 ascending, [B, k] int32 ids, -1 where +inf).
    On CUDA r > SEL_MAX or d > DIM_MAX runs the wide form: one launch
    writes the [B, r] exact distances (dropped copies +inf; counted as
    `ivf_rerank_wide`; under replicas past what a CTA's claim table holds,
    a claim pass into a global table `_rerank_table` runs first), K2
    selects the k smallest, and their ids are gathered."""
    b, r = cand_d.shape
    nb, lcap, d = pvecs.shape
    sq16 = pvecs.dtype == torch.int16
    if not 0 < k <= r:
        raise ValueError(f"ivf_rerank: need 0 < k <= r; got k={k}, r={r}")
    if sq16 and (mins is None or scales is None):
        raise ValueError("ivf_rerank: the SQ16 store needs mins and scales")
    store_meta = (mins, scales) if sq16 else ()
    if not _on_cuda(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, *store_meta):
        return ivf_rerank_plain(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins,
                                scales, k, replicated)
    q, pvecs = pad_dim(q), _rows4(pvecs)
    d = pvecs.shape[2]
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(cand_d, "cand_d", torch.float32, (b, r))
    _check(cand_i, "cand_i", torch.int32, (b, r))
    _check(cand_pos, "cand_pos", torch.int32, (b, r))
    _check(pvecs, "pvecs", torch.int16 if sq16 else torch.float32, (nb, lcap, d))
    _check(pnorms, "pnorms", torch.float32, (nb, lcap))
    for t, name in zip(store_meta, ("mins", "scales")):
        _check(t, name, torch.float32, (nb, lcap))
    if pvecs.data_ptr() % 16:
        raise ValueError("ivf_rerank: rows are read 4 elements at a time, so pvecs must be "
                         "16-byte aligned")
    if (r > SEL_MAX or d > DIM_MAX) and b:
        q = _aligned16(q)
        ex = torch.empty((b, r), dtype=torch.float32, device=q.device)
        _launch("ivf_rerank_dist", q.device, q.data_ptr(), qn.data_ptr(), cand_d.data_ptr(),
                cand_i.data_ptr(), cand_pos.data_ptr(), b, r, pvecs.data_ptr(), int(sq16),
                pnorms.data_ptr(), _ptr(mins if sq16 else None), _ptr(scales if sq16 else None),
                d, int(replicated), _ptr(_rerank_table(b, r, replicated, q.device)),
                ex.data_ptr(), counter="ivf_rerank_wide")
        dk, pos = topk_rows(ex, k)
        ik = torch.gather(cand_i, 1, pos.long())
        return dk, torch.where(torch.isinf(dk), -1, ik)
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b:
        _launch("ivf_rerank", q.device, q.data_ptr(), qn.data_ptr(), cand_d.data_ptr(),
                cand_i.data_ptr(), cand_pos.data_ptr(), b, r, pvecs.data_ptr(), int(sq16),
                pnorms.data_ptr(), _ptr(mins if sq16 else None),
                _ptr(scales if sq16 else None), d, k, int(replicated),
                out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


# ---------------------------------------------------------------------------
# K3: k-means assignment
# ---------------------------------------------------------------------------

R_MAX = 4
_ASSIGN_CHUNK = 4096  # plain version: [chunk, C] distance block per step


def kmeans_assign_plain(x, cents, xn, cn, r):
    xb = x.to(torch.bfloat16).float()
    cb = cents.to(torch.bfloat16).float()
    ids, ds = [], []
    for s in range(0, x.shape[0], _ASSIGN_CHUNK):
        d = (xn[s:s + _ASSIGN_CHUNK, None] + cn[None, :]) - 2.0 * (
            xb[s:s + _ASSIGN_CHUNK] @ cb.T)
        if r == 1:
            i = torch.argmin(d, dim=1, keepdim=True)
            v = torch.gather(d, 1, i)
        else:
            v, i = torch.sort(d, dim=1, stable=True)
            # copies: views would keep each chunk's full sort alive
            v, i = v[:, :r].clone(), i[:, :r].clone()
        ids.append(i.to(torch.int32))
        ds.append(v)
    if not ids:
        return (torch.empty((0, r), dtype=torch.int32, device=x.device),
                torch.empty((0, r), device=x.device))
    return torch.cat(ids), torch.cat(ds)


def _bf16_operand(t, d16):
    """t rounded to bf16 (a no-op for bf16), its columns zero-padded to d16:
    K3's operand layout. Zero columns leave every dot unchanged."""
    t = t.to(torch.bfloat16)
    if t.shape[1] != d16:
        t = torch.nn.functional.pad(t, (0, d16 - t.shape[1]))
    return t.contiguous()


def kmeans_assign(x, cents, xn, cn, r: int = 1):
    """Nearest centroids of each row: x [n, d] and cents [C, d] are rounded
    to bf16, their products summed in fp32, and `(xn + cn) − 2·dot` ranked.
    `x` may come rounded already (bf16): a k-means run rounds its rows once
    for all its rounds; the centroids are rounded once a call. Returns
    ([n, r] int32 ids, [n, r] f32 distances) ascending, lowest id on ties
    (as `jnp.argmin` / `lax.top_k`). cn = +inf never wins; a row of all
    +inf returns ids 0..r-1."""
    n, d = x.shape
    c = cents.shape[0]
    if not 1 <= r <= min(R_MAX, c):
        raise ValueError(f"kmeans_assign: need 1 <= r <= min({R_MAX}, C), got r={r}, C={c}")
    if not _on_cuda(x, cents, xn, cn):
        return kmeans_assign_plain(x, cents, xn, cn, r)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    # x may be a view (a row store's rows): its operand below is a copy
    _check(cents, "cents", torch.float32, (c, d))
    _check(xn, "xn", torch.float32, (n,))
    _check(cn, "cn", torch.float32, (c,))
    d16 = -(-d // 16) * 16
    xb, cb = _bf16_operand(x, d16), _bf16_operand(cents, d16)
    out_i = torch.empty((n, r), dtype=torch.int32, device=x.device)
    out_d = torch.empty((n, r), dtype=torch.float32, device=x.device)
    if n:
        _launch("kmeans_assign", x.device, xb.data_ptr(), xn.data_ptr(), n, cb.data_ptr(),
                cn.data_ptr(), c, d16, r, out_i.data_ptr(), out_d.data_ptr())
    return out_i, out_d


# ---------------------------------------------------------------------------
# K6 / K8: the HNSW level-0 beam (serving pack / f32 graph)
# ---------------------------------------------------------------------------

# widest beam buffer, neighbour slots a step (expand * deg) and expanded-id
# list the fast beam kernels keep in shared memory (csrc/hnsw_beam.cu), with
# a hash table of at least twice their sum; the callers' iters = ef + ef // 2
# stays within EXP_MAX at every ef up to EF_MAX. Past any of them (or
# DIM_MAX) a beam runs its wide form (csrc/graph_wide.cu)
EF_MAX, SLOTS_MAX, EXP_MAX = 1024, 1024, 2048


class BeamResult(NamedTuple):
    """A beam's sorted candidate buffer [B, ef]; the filtered result buffer
    [B, k_res] (or None); the expanded ids [B, exp_cap] in expansion order
    (or None); and `stats` [B, 2] int32: the nodes each query expanded and
    the neighbours it scored (the work its bound counts)."""

    cand_d: torch.Tensor
    cand_i: torch.Tensor
    res_d: torch.Tensor | None
    res_i: torch.Tensor | None
    exp_ids: torch.Tensor | None
    stats: torch.Tensor


def _topk_gather(d, i, k):
    """k smallest of d with their ids (ties to the lower position)."""
    vals, pos = topk_rows_plain(d, k)
    return vals, torch.gather(i, 1, pos.long())


def _member(ids, table):
    return torch.any(ids[..., :, None] == table[..., None, :], dim=-1) & (ids != -1)


def _beam_plain(cand_i, cand_d, done, loops, expand, deg, neighbours, allowed=None,
                res=None, exp_cap=0):
    """The reference beam (`_beam_level`, hnsw_serve.py `serve_search_impl`
    stage 1b) over [B, ef] buffers; `neighbours(sel_i)` gives the raw ids
    and distances [B, expand * deg] of the selected nodes' lists."""
    b, ef = cand_i.shape
    exp_ids = torch.full((b, exp_cap), -1, dtype=torch.int32, device=cand_i.device)
    stats = torch.zeros((b, 2), dtype=torch.int32, device=cand_i.device)
    pos = torch.arange(ef, dtype=torch.int32, device=cand_i.device).expand(b, ef)
    res_d, res_i = res if res is not None else (None, None)
    it = 0
    while it < loops and not bool(done.all()):
        is_exp = _member(cand_i, exp_ids)
        avail = torch.where(is_exp | (cand_i < 0), INF, cand_d)
        sel_d, sel_pos = _topk_gather(avail, pos, expand)
        sel_i = torch.gather(cand_i, 1, sel_pos.long())
        # the bound of the reference: a query is done when even its best
        # unexpanded candidate is worse than its worst buffered one
        worst = torch.amax(cand_d, dim=-1)
        done = done | torch.isinf(sel_d[:, 0]) | (sel_d[:, 0] > worst)
        live = ~done
        exp_ok = live[:, None] & ~torch.isinf(sel_d) & (sel_d <= worst[:, None])
        sel_i = torch.where(exp_ok, sel_i, -1)
        stats[:, 0] += exp_ok.sum(1, dtype=torch.int32)
        nbrs, nd = neighbours(sel_i)
        ok = (nbrs >= 0) & exp_ok.repeat_interleave(deg, dim=1)
        ok &= ~(_member(nbrs, cand_i) | _member(nbrs, exp_ids))
        nbrs_m, _ = mask_duplicates(torch.where(ok, nbrs, -1), torch.zeros_like(nd))
        ok &= nbrs_m >= 0
        stats[:, 1] += ok.sum(1, dtype=torch.int32)
        nd = torch.where(ok, nd, INF)
        cd2, ci2 = _topk_gather(torch.cat([cand_d, nd], 1), torch.cat([cand_i, nbrs_m], 1), ef)
        exp_ids[:, it * expand:(it + 1) * expand] = sel_i
        if res_d is not None:
            n_ok = ok & allowed[nbrs_m.clamp_min(0).long()]
            rd2, ri2 = _topk_gather(torch.cat([res_d, torch.where(n_ok, nd, INF)], 1),
                                    torch.cat([res_i, torch.where(n_ok, nbrs_m, -1)], 1),
                                    res_d.shape[1])
            res_d = torch.where(live[:, None], rd2, res_d)
            res_i = torch.where(live[:, None], ri2, res_i)
        keep = live[:, None]
        cand_i = torch.where(keep, ci2, cand_i)
        cand_d = torch.where(keep, cd2, cand_d)
        it += 1
    return cand_i, cand_d, res_d, res_i, exp_ids, stats


def _beam_init(seed_i, seed_d, ef):
    """[B, ef] buffers holding the seeds [B, S <= ef], then (-1, +inf)."""
    b, s = seed_i.shape
    cand_i = torch.full((b, ef), -1, dtype=torch.int32, device=seed_i.device)
    cand_d = torch.full((b, ef), INF, device=seed_i.device)
    cand_i[:, :s] = seed_i
    cand_d[:, :s] = seed_d
    return cand_i, cand_d


def _loops(iters, expand):
    loops = -(-iters // expand)
    return loops, loops * expand


def _gathered_epilogue(dots, metric, qn, xn):
    """`gathered_distances`' epilogue: L2 clamped at 0, COS, IP."""
    if metric == 0:
        return torch.clamp_min((qn + xn) - 2.0 * dots, 0.0)
    if metric == 1:
        return 1.0 - dots
    return -dots


def hnsw_graph_beam_plain(adj, vectors, norms, q, qn, seed_i, seed_d, allowed=None, *,
                          ef, iters, metric, expand=4, k_res=None, active=None,
                          return_expanded=False):
    """`vectors` is the f32 rows or an `Sq8Rows` store (its gather)."""
    b, s = seed_i.shape
    deg = adj.shape[1]
    loops, exp_cap = _loops(iters, expand)
    if active is not None:
        seed_i = torch.where(active[:, None], seed_i, -1)
        seed_d = torch.where(active[:, None], seed_d, INF)
    cand_i, cand_d = _beam_init(seed_i, seed_d, ef)
    res = None
    if allowed is not None:
        kr = k_res or ef
        sk = min(s, kr)
        seed_ok = allowed[seed_i.clamp_min(0).long()] & (seed_i >= 0)
        res_i, res_d = _beam_init(torch.where(seed_ok, seed_i, -1)[:, :sk],
                                  torch.where(seed_ok, seed_d, INF)[:, :sk], kr)
        res = (res_d, res_i)

    def neighbours(sel_i):
        nbrs = adj[sel_i.clamp_min(0).long()].reshape(b, -1)
        safe = nbrs.clamp_min(0).long()
        dots = torch.einsum("bd,bkd->bk", q, vectors[safe])
        return nbrs, _gathered_epilogue(dots, metric, qn[:, None], norms[safe])

    done = (seed_i < 0).all(1)
    cand_i, cand_d, res_d, res_i, exp_ids, stats = _beam_plain(
        cand_i, cand_d, done, loops, expand, deg, neighbours, allowed, res, exp_cap)
    return BeamResult(cand_d, cand_i, res_d, res_i,
                      exp_ids if return_expanded else None, stats)


def _beam_checks(name, b, s, ef, iters, expand, deg, d, seed_i, seed_d):
    if not 1 <= expand <= ef:
        raise ValueError(f"{name}: need 1 <= expand <= ef, got expand={expand}, ef={ef}")
    if not 1 <= s <= ef:
        raise ValueError(f"{name}: need 1 <= seeds <= ef, got {s} seeds, ef={ef}")
    if iters < 1:
        raise ValueError(f"{name}: iters must be positive, got {iters}")
    _check(seed_i, "seed_i", torch.int32, (b, s))
    _check(seed_d, "seed_d", torch.float32, (b, s))


def beam_fast(ef, iters, expand, deg, d, k_res=0) -> bool:
    """Whether a fast beam kernel keeps these widths in shared memory: ef
    and k_res <= EF_MAX, expand·deg <= SLOTS_MAX, at most EXP_MAX
    expansions and d (rounded up to 4) <= DIM_MAX. Else the wide form runs."""
    _, exp_cap = _loops(iters, expand)
    return (ef <= EF_MAX and k_res <= EF_MAX and expand * deg <= SLOTS_MAX
            and exp_cap <= EXP_MAX and _d4(d) <= DIM_MAX)


def _wide_scratch(bytes_a_block: int, b: int, device):
    """(scratch, grid) of a wide launch over b queries or targets: at most
    WIDE_BLOCKS blocks, each with its slice of bytes_a_block."""
    grid = max(1, min(b, WIDE_BLOCKS))
    return torch.empty(grid * bytes_a_block, dtype=torch.uint8, device=device), grid


def _d4(d: int) -> int:
    """The width a row kernel reads: d rounded up to 4."""
    return d + (-d % 4)


def hnsw_graph_beam(adj, vectors, norms, q, qn, seed_i, seed_d, allowed=None, *,
                    ef: int, iters: int, metric: int, expand: int = 4, k_res: int | None = None,
                    active=None, return_expanded: bool = False) -> BeamResult:
    """The graph beam over one adjacency level (`_beam_level` of the
    reference's models/hnsw.py).

    adj [cap, deg] int32 (-1 padded), vectors [cap, d] f32 or an `Sq8Rows`
    store (u8 / u16 codes dequantized on the gather as one fused
    multiply-add `min + scale·code`, as `rows[ids]` computes it; its
    launches count as `hnsw_graph_beam_sq`), norms [cap] (exact f32),
    q [B, d], qn [B] = ‖q‖², seeds seed_i / seed_d [B, S] (S <= ef, -1 /
    +inf for none), `allowed` [cap] bool or None, `active` [B] bool or
    None (inactive queries start with no seed). Each step expands the
    `expand` nearest unexpanded candidates, scores their unseen neighbours
    (`gathered_distances`: L2 clamped at 0, COS `1 − dot`, IP `−dot`) and
    merges them into the ef buffer (ties to the earlier entry), for at most
    ceil(iters / expand) steps; a query stops when nothing is left to
    expand. With `allowed`, nodes outside it are traversed and kept out of
    a second result buffer of width `k_res` (default ef). On CUDA widths
    past `beam_fast` (ef or k_res > EF_MAX, expand·deg > SLOTS_MAX, more
    than EXP_MAX expansions, d > DIM_MAX) run the wide form, counted as
    `hnsw_graph_beam_wide` / `hnsw_graph_beam_sq_wide`."""
    b, s = seed_i.shape
    cap, deg = adj.shape
    d = vectors.shape[1]
    _beam_checks("hnsw_graph_beam", b, s, ef, iters, expand, deg, d, seed_i, seed_d)
    if metric not in (0, 1, 2):
        raise ValueError(f"hnsw_graph_beam: unknown metric {metric}")
    kr = (k_res or ef) if allowed is not None else 0
    sq = isinstance(vectors, Sq8Rows)
    store = (vectors.codes, vectors.mins, vectors.scales) if sq else (vectors,)
    if not _on_cuda(adj, *store, norms, q, qn, seed_i, seed_d, allowed, active):
        return hnsw_graph_beam_plain(adj, vectors, norms, q, qn, seed_i, seed_d, allowed,
                                     ef=ef, iters=iters, metric=metric, expand=expand,
                                     k_res=k_res, active=active,
                                     return_expanded=return_expanded)
    fast = beam_fast(ef, iters, expand, deg, d, kr)
    vectors, q = _rows4_store(vectors), pad_dim(q)
    d = vectors.shape[1]
    _, exp_cap = _loops(iters, expand)
    _check(adj, "adj", torch.int32, (cap, deg))
    if sq:
        _check_sq_rows("hnsw_graph_beam", vectors, cap, d)
    else:
        _check(vectors, "vectors", torch.float32, (cap, d))
    _check(norms, "norms", torch.float32, (cap,))
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, (cap,))
    if active is not None:
        _check(active, "active", torch.bool, (b,))
        seed_i = torch.where(active[:, None], seed_i, -1).contiguous()
        seed_d = torch.where(active[:, None], seed_d, INF).contiguous()
    if q.data_ptr() % 16 or (not sq and vectors.data_ptr() % 16):
        raise ValueError("hnsw_graph_beam: vectors and q must be 16-byte aligned")
    dev = q.device
    out = BeamResult(torch.empty((b, ef), dtype=torch.float32, device=dev),
                     torch.empty((b, ef), dtype=torch.int32, device=dev),
                     torch.empty((b, kr), dtype=torch.float32, device=dev) if kr else None,
                     torch.empty((b, kr), dtype=torch.int32, device=dev) if kr else None,
                     (torch.empty((b, exp_cap), dtype=torch.int32, device=dev)
                      if return_expanded else None),
                     torch.empty((b, 2), dtype=torch.int32, device=dev))
    rows = ((vectors.codes.data_ptr(), vectors.bits, vectors.mins.data_ptr(),
             vectors.scales.data_ptr()) if sq else (vectors.data_ptr(),))
    name = "hnsw_graph_beam_sq" if sq else "hnsw_graph_beam"
    args = (adj.data_ptr(), *rows, norms.data_ptr(), q.data_ptr(), qn.data_ptr(),
            seed_i.data_ptr(), seed_d.data_ptr(), b, s, _ptr(_as_u8(allowed)), d, deg, ef, iters,
            expand, kr, metric, *(_ptr(t) for t in out[:5]), out.stats.data_ptr())
    if b and fast:
        _launch(name, adj.device, *args)
    elif b:
        bytes_a_block = (_beam_sq_wide_bytes(deg, ef, iters, expand, kr, d, vectors.bits) if sq
                         else build.library().hnsw_beam_wide_bytes(deg, ef, iters, expand, kr, 0))
        scratch, grid = _wide_scratch(bytes_a_block, b, dev)
        _launch(f"{name}_wide", adj.device, *args, scratch.data_ptr(), grid)
    return out


def _beam_sq_wide_bytes(deg, ef, iters, expand, k_res, d, bits):
    """K8-SQ wide's global scratch a block: 0 where its state lies in
    shared memory beside the query row and the staged rows (csrc/graph_wide.cu
    `sq_stage` holds the rule)."""
    return int(build.library().hnsw_beam_sq_wide_bytes(deg, ef, iters, expand, k_res, d, bits))


def graph_beam_sq_stage(b, s, d, deg, *, ef, iters, expand, k_res, bits, device=None):
    """K8-SQ's stage at these widths on a CUDA device (its rule is in
    csrc/hnsw_beam.cu `pick_stage`): (rows a warp stages at once, blocks an
    SM runs at 16 rows, at 32 rows). A query of the library, not a launch."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = build.library().hnsw_graph_beam_sq_stage(b, s, d, deg, ef, iters, expand, k_res,
                                                       bits, out)
    if err:
        msg = build.library().kernel_error_string(err).decode()
        raise RuntimeError(f"hnsw_graph_beam_sq_stage: {msg} ({err})")
    return tuple(out)


def _check_sq_rows(name, rows: Sq8Rows, cap, d):
    """The SQ store a kernel reads: codes [cap, d] uint8 or int16 (the
    uint16 bits), read 4 codes at a time; mins and scales [cap] f32."""
    _check(rows.codes, "codes", rows.codes.dtype, (cap, d))
    _check(rows.mins, "mins", torch.float32, (cap,))
    _check(rows.scales, "scales", torch.float32, (cap,))
    if rows.codes.data_ptr() % (4 * rows.codes.element_size()):
        raise ValueError(f"{name}: the codes must be aligned to 4 codes")


# ---------------------------------------------------------------------------
# K9: the HNSW greedy descent
# ---------------------------------------------------------------------------

GREEDY_CAP = 128  # steps of one level's walk (the reference's cap, hnsw.py:73)
GREEDY_LEVELS_MAX = build.GREEDY_LEVELS_MAX


def _greedy_adjs(adj):
    """One level, or a sequence of levels walked top first, as a list."""
    adjs = [adj] if isinstance(adj, torch.Tensor) else list(adj)
    if not 1 <= len(adjs) <= GREEDY_LEVELS_MAX:
        raise ValueError(f"hnsw_greedy: walks 1 to {GREEDY_LEVELS_MAX} levels in one launch, "
                         f"got {len(adjs)}")
    return adjs


def _greedy_walk(adj, vectors, norms, q, qn, cur_i, cur_d, metric):
    """The reference's batched walk through one level (`_greedy_level`):
    every query steps until none moves; a query's work is the steps it
    took while it moved and the one that found no better neighbour."""
    stats = torch.zeros((cur_i.shape[0], 2), dtype=torch.int32, device=cur_i.device)
    live = torch.ones(cur_i.shape, dtype=torch.bool, device=cur_i.device)
    for _ in range(GREEDY_CAP):
        nbrs = adj[cur_i.clamp_min(0).long()]
        safe = nbrs.clamp_min(0).long()
        dots = torch.einsum("bd,bkd->bk", q, vectors[safe])
        nd = torch.where(nbrs >= 0, _gathered_epilogue(dots, metric, qn[:, None], norms[safe]),
                         INF)
        j = torch.argmin(nd, dim=-1, keepdim=True)
        bd = torch.gather(nd, 1, j)[:, 0]
        bi = torch.gather(nbrs, 1, j)[:, 0]
        moved = bd < cur_d
        work = torch.stack([torch.ones_like(bi), (nbrs >= 0).sum(1, dtype=torch.int32)], 1)
        stats += live[:, None].int() * work
        live = moved
        if not bool(moved.any()):
            break
        cur_i = torch.where(moved, bi, cur_i)
        cur_d = torch.where(moved, bd, cur_d)
    return cur_i, cur_d, stats


def hnsw_greedy_plain(adj, vectors, norms, q, qn, cur_i, cur_d, *, metric, lowest=None):
    """The chain of one-level walks: level by level from the first, each
    query from where the last level left it, only the queries that walk
    the level (see `hnsw_greedy`); the work summed over the levels."""
    adjs = _greedy_adjs(adj)
    stats = torch.zeros((cur_i.shape[0], 2), dtype=torch.int32, device=cur_i.device)
    cur_i, cur_d = cur_i.clone(), cur_d.clone()
    for j, a in enumerate(adjs):
        rows = (torch.arange(cur_i.shape[0], device=cur_i.device) if lowest is None
                else torch.nonzero(lowest <= len(adjs) - 1 - j)[:, 0])
        ni, nd, work = _greedy_walk(a, vectors, norms, q[rows], qn[rows], cur_i[rows],
                                    cur_d[rows], metric)
        cur_i[rows], cur_d[rows] = ni, nd
        stats[rows] += work
    return cur_i, cur_d, stats


def hnsw_greedy(adj, vectors, norms, q, qn, cur_i, cur_d, *, metric: int, lowest=None):
    """The greedy descent (`_greedy_level` of the reference's
    models/hnsw.py) through one adjacency level or several, in one launch.

    adj: one level [cap, deg] int32 (-1 padded), or a sequence of up to
    GREEDY_LEVELS_MAX levels of one shape, walked in order (the top first);
    vectors [cap, d] f32 or an `Sq8Rows` store, norms [cap], q [B, d],
    qn [B] = ‖q‖², cur_i [B] int32 and cur_d [B] f32 the start and its
    distance; `lowest` [B] int32 or None: the levels are numbered from
    len - 1 (the first) down to 0 (the last), and query b walks those
    numbered lowest[b] or more (None: all; len or more: none, its start
    passes through). Each step scores the neighbours of cur
    (`gathered_distances`: L2 clamped at 0, COS, IP; -1 entries +inf; cur
    -1 reads row 0's list), takes the first of the nearest and moves there
    only if it is strictly nearer than cur_d; at most GREEDY_CAP steps a
    level, each level from where the last one ended, so the result is the
    chain of one-level walks. Returns (cur_i [B] int32, cur_d [B] f32,
    stats [B, 2] int32: the lists each query read and the neighbours it
    scored, over its levels). On CUDA d > DIM_MAX runs the wide form (a
    block a query, each neighbour row read by a warp on 16-byte words,
    warp_dot's sum order; counted as `hnsw_greedy_wide`); more levels than
    GREEDY_LEVELS_MAX raise everywhere (a caller walks them in launches of
    at most that many, top first: the walk is a chain)."""
    adjs = _greedy_adjs(adj)
    b = cur_i.shape[0]
    cap, deg = adjs[0].shape
    d = vectors.shape[1]
    if metric not in (0, 1, 2):
        raise ValueError(f"hnsw_greedy: unknown metric {metric}")
    sq = isinstance(vectors, Sq8Rows)
    store = (vectors.codes, vectors.mins, vectors.scales) if sq else (vectors,)
    if not _on_cuda(*adjs, *store, norms, q, qn, cur_i, cur_d, lowest):
        return hnsw_greedy_plain(adjs, vectors, norms, q, qn, cur_i, cur_d, metric=metric,
                                 lowest=lowest)
    vectors, q = _rows4_store(vectors), pad_dim(q)
    d = vectors.shape[1]
    for a in adjs:
        _check(a, "adj", torch.int32, (cap, deg))
    if sq:
        _check_sq_rows("hnsw_greedy", vectors, cap, d)
    else:
        _check(vectors, "vectors", torch.float32, (cap, d))
    _check(norms, "norms", torch.float32, (cap,))
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(cur_i, "cur_i", torch.int32, (b,))
    _check(cur_d, "cur_d", torch.float32, (b,))
    if lowest is not None:
        _check(lowest, "lowest", torch.int32, (b,))
    if q.data_ptr() % 16 or (not sq and vectors.data_ptr() % 16):
        raise ValueError("hnsw_greedy: vectors and q must be 16-byte aligned")
    out_i = torch.empty(b, dtype=torch.int32, device=q.device)
    out_d = torch.empty(b, dtype=torch.float32, device=q.device)
    stats = torch.empty((b, 2), dtype=torch.int32, device=q.device)
    if b:
        levels = build.GreedyLevels((ctypes.c_void_p * GREEDY_LEVELS_MAX)(
            *(a.data_ptr() for a in adjs)), len(adjs))
        _launch("hnsw_greedy" if d <= DIM_MAX else "hnsw_greedy_wide", q.device, levels,
                None if sq else vectors.data_ptr(),
                vectors.codes.data_ptr() if sq else None, vectors.bits if sq else 0,
                vectors.mins.data_ptr() if sq else None,
                vectors.scales.data_ptr() if sq else None, norms.data_ptr(), q.data_ptr(),
                qn.data_ptr(), cur_i.data_ptr(), cur_d.data_ptr(), _ptr(lowest), b, d, deg,
                metric, out_i.data_ptr(), out_d.data_ptr(), stats.data_ptr())
    return out_i, out_d, stats


def hnsw_serve_beam_plain(nbr_codes, nbr_meta, vectors, norms, q, qn, qc, qs, qsum, seed_i,
                          seed_d, allowed=None, *, ef, iters, expand, rerank, k, metric):
    b, s = seed_i.shape
    deg = nbr_codes.shape[1]
    loops, exp_cap = _loops(iters, expand)
    cand_i, cand_d = _beam_init(seed_i, seed_d, ef)

    def neighbours(sel_i):
        safe = sel_i.clamp_min(0).long()
        meta = nbr_meta[safe]                                  # [B, E, deg, 4]
        f = meta.view(torch.float32)                           # base, scale, ‖x‖² bits
        base, scale, nnorm = f[..., 0], f[..., 1], f[..., 2]
        doti = _int8_dots(qc, nbr_codes[safe])                 # [B, E, deg]
        nd = sq8_epilogue(doti, base, scale, qn[:, None, None], qsum[:, None, None],
                          qs[:, None, None], nnorm, metric)
        return meta[..., 3].reshape(b, -1), nd.reshape(b, -1)

    cand_i, cand_d, *_, stats = _beam_plain(cand_i, cand_d, (seed_i < 0).all(1), loops,
                                            expand, deg, neighbours, exp_cap=exp_cap)
    # exact rerank of the r best
    r = min(rerank or ef, ef)
    if r < ef:
        cand_d, cand_i = _topk_gather(cand_d, cand_i, r)
    safe = cand_i.clamp_min(0).long()
    dots = torch.einsum("bd,brd->br", q, vectors[safe])
    if metric == 0:
        exact = qn[:, None] + norms[safe] - 2.0 * dots
    else:
        exact = 1.0 - dots if metric == 1 else -dots
    bad = cand_i < 0
    if allowed is not None:
        bad |= ~allowed[safe]
    d_out, i_out = _topk_gather(torch.where(bad, INF, exact), cand_i, k)
    return d_out, torch.where(torch.isinf(d_out), -1, i_out), stats


def hnsw_serve_beam(nbr_codes, nbr_meta, vectors, norms, q, qn, qc, qs, qsum, seed_i, seed_d,
                    allowed=None, *, ef: int, iters: int, expand: int, rerank: int, k: int,
                    metric: int):
    """The serving beam and its exact rerank (`serve_search_impl` of the
    reference's models/hnsw_serve.py, after the seeding).

    nbr_codes [cap, deg, d] int8 (the centred SQ8 codes of each node's
    neighbours), nbr_meta [cap, deg, 4] int32 (f32 base, scale, ‖x‖² as
    bits, then the neighbour id), vectors [cap, d] f32 and norms [cap] (the
    rerank store), q [B, d] f32 with qn, and its int8 quantization qc, qs,
    qsum (`ops.quantize.quantize_queries`); seeds [B, S <= ef]. The beam
    scores a neighbour with `sq8_epilogue` of its exact int8 dot, as
    `hnsw_graph_beam` does otherwise; then the `rerank` best (0: all ef)
    get their exact distance (L2 `(qn + norm) − 2·dot` unclamped, COS, IP),
    +inf outside `allowed` [cap], and the k smallest are returned:
    ([B, k] f32 ascending, [B, k] int32 ids, -1 where +inf, and the
    [B, 2] int32 stats of `BeamResult`). On CUDA widths past `beam_fast`
    run the wide form, counted as `hnsw_serve_beam_wide` (the expanded
    nodes' blocks staged in shared memory, `serve_wide_stage`; the rerank's
    dots a warp a row)."""
    b, s = seed_i.shape
    cap, deg, d = nbr_codes.shape
    _beam_checks("hnsw_serve_beam", b, s, ef, iters, expand, deg, d, seed_i, seed_d)
    r = min(rerank or ef, ef)
    if not 0 < k <= r:
        raise ValueError(f"hnsw_serve_beam: need 0 < k <= rerank width, got k={k}, r={r}")
    if metric not in (0, 1, 2):
        raise ValueError(f"hnsw_serve_beam: unknown metric {metric}")
    if not _on_cuda(nbr_codes, nbr_meta, vectors, norms, q, qn, qc, qs, qsum, seed_i, seed_d,
                    allowed):
        return hnsw_serve_beam_plain(nbr_codes, nbr_meta, vectors, norms, q, qn, qc, qs, qsum,
                                     seed_i, seed_d, allowed, ef=ef, iters=iters, expand=expand,
                                     rerank=rerank, k=k, metric=metric)
    fast = beam_fast(ef, iters, expand, deg, d)
    nbr_codes, vectors, q, qc = _rows4(nbr_codes), _rows4(vectors), pad_dim(q), pad_dim(qc)
    d = vectors.shape[1]
    _check(nbr_codes, "nbr_codes", torch.int8, (cap, deg, d))
    _check(nbr_meta, "nbr_meta", torch.int32, (cap, deg, 4))
    _check(vectors, "vectors", torch.float32, (cap, d))
    _check(norms, "norms", torch.float32, (cap,))
    _check(q, "q", torch.float32, (b, d))
    _check(qc, "qc", torch.int8, (b, d))
    for t, name in ((qn, "qn"), (qs, "qs"), (qsum, "qsum")):
        _check(t, name, torch.float32, (b,))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, (cap,))
    if vectors.data_ptr() % 16 or q.data_ptr() % 16 or nbr_codes.data_ptr() % 4 \
            or qc.data_ptr() % 4 or nbr_meta.data_ptr() % 16:
        raise ValueError("hnsw_serve_beam: vectors, q and nbr_meta must be 16-byte and "
                         "nbr_codes, qc 4-byte aligned")
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    stats = torch.empty((b, 2), dtype=torch.int32, device=q.device)
    args = (nbr_codes.data_ptr(), nbr_meta.data_ptr(), vectors.data_ptr(), norms.data_ptr(),
            q.data_ptr(), qn.data_ptr(), qc.data_ptr(), qs.data_ptr(), qsum.data_ptr(),
            seed_i.data_ptr(), seed_d.data_ptr(), b, s, _ptr(_as_u8(allowed)), d, deg, ef, iters,
            expand, r, k, metric, out_d.data_ptr(), out_i.data_ptr(), stats.data_ptr())
    if b and fast:
        _launch("hnsw_serve_beam", nbr_codes.device, *args)
    elif b:
        scratch, grid = _wide_scratch(_serve_wide_bytes(deg, ef, iters, expand, r, d), b,
                                      q.device)
        _launch("hnsw_serve_beam_wide", nbr_codes.device, *args, scratch.data_ptr(), grid)
    return out_d, out_i, stats


def _serve_wide_bytes(deg, ef, iters, expand, rerank, d):
    """K6 wide's global scratch a block: 0 where its state lies in shared
    memory beside its stage (csrc/graph_wide.cu `serve_stage` holds the
    rule; d a multiple of 4)."""
    return int(build.library().hnsw_serve_beam_wide_bytes(deg, ef, iters, expand, rerank, d))


def serve_wide_stage(deg, ef, iters, expand, rerank, d):
    """K6 wide's stage at these widths on the current CUDA device: (state
    in the global scratch, code rows a batch: a step's expand·deg slots,
    whole nodes, or rows of one node). `rerank` is the rerank's width, d a
    multiple of 4. A query of the library, not a launch."""
    lib = build.library()
    return (_serve_wide_bytes(deg, ef, iters, expand, rerank, d) > 0,
            int(lib.hnsw_serve_beam_wide_rows(deg, ef, iters, expand, rerank, d)))


def serve_beam_stage(b, s, d, deg, *, ef, iters, expand, rerank, device=None):
    """K6's stages at these widths on a CUDA device (its rule is in
    csrc/hnsw_beam.cu `pick_serve_stage`): (code rows a warp stages at
    once, rerank rows a chunk, shared memory a block in bytes, blocks an SM
    runs at 16 code rows, at 32). `rerank` is the rerank's width (at most
    ef). A query of the library, not a launch."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = build.library().hnsw_serve_beam_stage(b, s, d, deg, ef, iters, expand, rerank,
                                                    out)
    if err:
        msg = build.library().kernel_error_string(err).decode()
        raise RuntimeError(f"hnsw_serve_beam_stage: {msg} ({err})")
    return tuple(out)


# ---------------------------------------------------------------------------
# K7: the HNSW diversity selection
# ---------------------------------------------------------------------------

SELECT_W_MAX = 256   # candidates the fast selection kernel holds (csrc/hnsw_select.cu)
SELECT_SMEM_MAX = 160 << 10   # bytes of the candidates' rows (W·d·4) it stages


def select_fast(w: int, d: int) -> bool:
    """Whether K7's fast form holds W candidates' rows of width d (rounded
    up to 4) in shared memory; else its wide form runs
    (csrc/hnsw_select_wide.cu: the window's rows over the shared memory of
    `select_wide_ctas` CTAs, or past that a global scratch)."""
    d = _d4(d)
    return w <= SELECT_W_MAX and d <= DIM_MAX and w * d * 4 <= SELECT_SMEM_MAX


def select_wide_ctas(w: int, d: int, presorted: bool) -> int:
    """CTAs a target of K7's wide form at W candidates of width d (a
    multiple of 4) on the current card: a thread block cluster of 1 to 16
    holding the window's rows in shared memory; 0 for the global form
    (csrc/hnsw_select_wide.cu `hnsw_select_wide_ctas` holds the rule)."""
    return int(build.library().hnsw_select_wide_ctas(w, d, int(presorted)))


def _select_wide(name, vectors, args, outs, u, w, d, presorted):
    """K7's wide form (`name` hnsw_select or hnsw_select_sorted, counted as
    `<name>_wide`): the cluster form at `select_wide_ctas` CTAs a target,
    else the global form over a scratch of WIDE_BLOCKS blocks."""
    ctas = select_wide_ctas(w, d, presorted)
    if ctas:
        _launch(f"{name}_cluster", vectors.device, *args, ctas, *outs, counter=f"{name}_wide")
    else:
        scratch, grid = _wide_scratch(build.library().hnsw_select_wide_bytes(w), u,
                                      vectors.device)
        _launch(f"{name}_wide", vectors.device, *args, scratch.data_ptr(), grid, *outs)


def select_cap(w: int, deg: int, alpha: float) -> int:
    """Candidates the diversity scan reads after the distance sort
    (`_select_from_candidates`, hnsw.py:591): all under alpha-relaxation,
    else ~2.5 deg."""
    return w if alpha != 1.0 else min(w, max(2 * deg + deg // 2, 48))


def hnsw_select_plain(vectors, norms, targets, cand, *, deg, metric, alpha):
    u, w = cand.shape
    t = targets.long()
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=cand.device), -1)
    dup = (torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, dim=-1)
           | (cand == targets[:, None]) | (cand < 0))
    safe = cand.clamp_min(0).long()
    dots = torch.einsum("ud,uwd->uw", vectors[t], vectors[safe])
    d = torch.where(dup, INF, _gathered_epilogue(dots, metric, norms[t][:, None], norms[safe]))
    order = torch.argsort(d, dim=-1, stable=True)[:, :select_cap(w, deg, alpha)]
    cand_s = torch.gather(torch.where(dup, -1, cand), 1, order)
    return _diversity_scan(vectors, cand_s, torch.gather(d, 1, order), deg=deg, metric=metric,
                           alpha=alpha)


def _diversity_scan(vectors, cand_s, d_s, *, deg, metric, alpha):
    """`_select_neighbors_heuristic` over candidates in scan order: a
    candidate is taken when it is nearer to the target than alpha times
    its distance to every one taken before."""
    u = cand_s.shape[0]
    vecs = vectors[cand_s.clamp_min(0).long()]
    valid = cand_s >= 0
    dots = torch.einsum("ucd,ukd->uck", vecs, vecs)
    if metric == 0:
        nrm = torch.sum(vecs * vecs, dim=-1)
        pair = torch.clamp_min(nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots, 0.0)
    else:
        pair = 1.0 - dots if metric == 1 else -dots
    c = cand_s.shape[1]
    sel = torch.zeros((u, c), dtype=torch.bool, device=cand_s.device)
    min_sel = torch.full((u, c), INF, device=cand_s.device)
    count = torch.zeros(u, dtype=torch.int32, device=cand_s.device)
    for j in range(c):
        take = valid[:, j] & (d_s[:, j] < alpha * min_sel[:, j]) & (count < deg)
        sel[:, j] = take
        min_sel = torch.where(take[:, None], torch.minimum(min_sel, pair[:, :, j]), min_sel)
        count += take.int()
    # selected (in distance order) first, then the rest as backfill
    key = torch.where(valid, d_s, INF) + torch.where(sel, 0.0, 1e30)
    order = torch.argsort(key, dim=-1, stable=True)[:, :deg]
    sel_i = torch.gather(cand_s, 1, order)
    sel_d = torch.gather(torch.where(valid, d_s, INF), 1, order)
    sel_i = torch.where(torch.isinf(sel_d), -1, sel_i)
    if sel_i.shape[1] < deg:
        pad = deg - sel_i.shape[1]
        sel_i = torch.nn.functional.pad(sel_i, (0, pad), value=-1)
        sel_d = torch.nn.functional.pad(sel_d, (0, pad), value=INF)
    # the pair columns the scan needs: one per take but the deg-th, each
    # against the valid candidates after it
    later = valid.flip(1).cumsum(1).flip(1) - valid.int()
    need = sel & (sel.cumsum(1) < deg)
    n_pairs = torch.sum(later * need, dim=1, dtype=torch.int32)
    return sel_i.to(torch.int32), sel_d, n_pairs


def hnsw_select(vectors, norms, targets, cand, *, deg: int, metric: int, alpha: float):
    """Diversity-select `deg` edges for each target from its candidates
    (`_select_from_candidates` + `_select_neighbors_heuristic` of the
    reference's models/hnsw.py).

    vectors [cap, d] f32, norms [cap], targets [U] int32 slot ids, cand
    [U, W] int32 (duplicates, -1 and the target itself are dropped). The
    candidates are sorted by their exact distance to the target
    (`gathered_distances`: L2 clamped at 0, COS, IP; ties to the earlier
    candidate), cut to `select_cap`, and scanned in that order: one is
    taken while fewer than deg are, if its distance is below alpha times
    its distance to every one taken before (L2 `(Σv² + Σv²) − 2·dot`
    from the rows, clamped at 0). Returns (sel_i [U, deg] int32: the taken,
    then the others as backfill, both in distance order, -1 padded; sel_d
    [U, deg] their distances, +inf padded; n_pairs [U] int32, the pair
    distances the scan needed). On CUDA W > SELECT_W_MAX, d > DIM_MAX or
    W·d·4 > SELECT_SMEM_MAX (`select_fast`) run the wide form, counted as
    `hnsw_select_wide`."""
    u, w = cand.shape
    cap, d = vectors.shape
    if not 1 <= deg:
        raise ValueError(f"hnsw_select: deg must be positive, got {deg}")
    if metric not in (0, 1, 2):
        raise ValueError(f"hnsw_select: unknown metric {metric}")
    if not _on_cuda(vectors, norms, targets, cand):
        return hnsw_select_plain(vectors, norms, targets, cand, deg=deg, metric=metric,
                                 alpha=alpha)
    vectors = _rows4(vectors)
    d = vectors.shape[1]
    _check(vectors, "vectors", torch.float32, (cap, d))
    _check(norms, "norms", torch.float32, (cap,))
    _check(targets, "targets", torch.int32, (u,))
    _check(cand, "cand", torch.int32, (u, w))
    if vectors.data_ptr() % 16:
        raise ValueError("hnsw_select: vectors must be 16-byte aligned")
    out_i = torch.empty((u, deg), dtype=torch.int32, device=cand.device)
    out_d = torch.empty((u, deg), dtype=torch.float32, device=cand.device)
    n_pairs = torch.empty(u, dtype=torch.int32, device=cand.device)
    args = (vectors.data_ptr(), norms.data_ptr(), targets.data_ptr(), cand.data_ptr(), u, w, d,
            deg, select_cap(w, deg, alpha), float(alpha), metric)
    outs = (out_i.data_ptr(), out_d.data_ptr(), n_pairs.data_ptr())
    if u and select_fast(w, d):
        _launch("hnsw_select", vectors.device, *args, *outs)
    elif u:
        _select_wide("hnsw_select", vectors, args, outs, u, w, d, False)
    return out_i, out_d, n_pairs


def hnsw_select_sorted_plain(vectors, cand_i, cand_d, *, deg, metric, alpha):
    valid = cand_i >= 0
    return _diversity_scan(vectors, cand_i, torch.where(valid, cand_d, INF), deg=deg,
                           metric=metric, alpha=alpha)


def hnsw_select_sorted(vectors, cand_i, cand_d, *, deg: int, metric: int, alpha: float):
    """K7's presorted mode: `_select_neighbors_heuristic` of the reference's
    models/hnsw.py alone, over candidates that arrive sorted with their
    distances, as a beam's buffer does (`_wave_level_core`).

    vectors [cap, d] f32, cand_i [U, W] int32 and cand_d [U, W] f32 in
    ascending order (-1 / +inf at the end). No dedup, no re-sort, no
    window: the scan of `hnsw_select` over all W in the given order (pair
    distances from the rows), then the taken and the others as backfill
    in that order. Returns (sel_i [U, deg], sel_d [U, deg], n_pairs [U])
    as `hnsw_select`. On CUDA the widths past `select_fast` run the wide
    form, counted as `hnsw_select_sorted_wide`."""
    u, w = cand_i.shape
    cap, d = vectors.shape
    if not 1 <= deg:
        raise ValueError(f"hnsw_select_sorted: deg must be positive, got {deg}")
    if metric not in (0, 1, 2):
        raise ValueError(f"hnsw_select_sorted: unknown metric {metric}")
    if not _on_cuda(vectors, cand_i, cand_d):
        return hnsw_select_sorted_plain(vectors, cand_i, cand_d, deg=deg, metric=metric,
                                        alpha=alpha)
    vectors = _rows4(vectors)
    d = vectors.shape[1]
    _check(vectors, "vectors", torch.float32, (cap, d))
    _check(cand_i, "cand_i", torch.int32, (u, w))
    _check(cand_d, "cand_d", torch.float32, (u, w))
    if vectors.data_ptr() % 16:
        raise ValueError("hnsw_select_sorted: vectors must be 16-byte aligned")
    out_i = torch.empty((u, deg), dtype=torch.int32, device=cand_i.device)
    out_d = torch.empty((u, deg), dtype=torch.float32, device=cand_i.device)
    n_pairs = torch.empty(u, dtype=torch.int32, device=cand_i.device)
    args = (vectors.data_ptr(), cand_i.data_ptr(), cand_d.data_ptr(), u, w, d, deg,
            float(alpha), metric)
    outs = (out_i.data_ptr(), out_d.data_ptr(), n_pairs.data_ptr())
    if u and select_fast(w, d):
        _launch("hnsw_select_sorted", vectors.device, *args, *outs)
    elif u:
        _select_wide("hnsw_select_sorted", vectors, args, outs, u, w, d, True)
    return out_i, out_d, n_pairs


# ---------------------------------------------------------------------------
# K10: dense IVF block list (its kernel runs inside K2: `topk_rows(...,
# cell_block=, u=)`)
# ---------------------------------------------------------------------------

def dense_blocks_plain(cell_block, top, u):
    """The physical blocks a dense IVF probe gathers (`_first_unique` of
    `cell_block[top]`, the reference's ivf.py:225-237, :277-284):
    cell_block [C] int32 maps each cell to its block, top [B, P] the
    probed cells. With u >= P returns `cell_block[top]` [B, P]; with u < P
    the first u distinct blocks of each row [B, u], in first-occurrence
    order, followed, where a row has fewer than u, by its repeats in their
    own order (the reference's stable argsort)."""
    blk = cell_block[top.long()]
    p = blk.shape[1]
    if u >= p:
        return blk.to(torch.int32).contiguous()
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool, device=blk.device), -1)
    pos = torch.arange(p, device=blk.device)
    step = max(1, (1 << 26) // (p * p))     # bounds the [b, P, P] comparison
    outs = []
    for s in range(0, blk.shape[0], step):
        part = blk[s:s + step]
        dup = torch.any((part[:, :, None] == part[:, None, :]) & earlier, dim=-1)
        order = torch.argsort(torch.where(dup, p + 1, pos), dim=-1, stable=True)[:, :u]
        outs.append(torch.gather(part, 1, order))
    if not outs:
        return torch.empty((0, u), dtype=torch.int32, device=blk.device)
    return torch.cat(outs).to(torch.int32)


# ---------------------------------------------------------------------------
# K11: asymmetric L2 over a u8 store
# ---------------------------------------------------------------------------

# widest k of K11's list mode (a candidate buffer per query; wider k writes
# the distances out and selects with K2), the rows a block scans (a multiple
# of the kernel's 64-row tile), the widest column slice (a multiple of 16)
# whose tiles fit a block (a wider row runs in slices), and the bytes of
# [rows, N] distances one slice of queries of the distance mode writes
SQ8_LIST_MAX, SQ8_CHUNK, SQ8_D_MAX = 64, 8192, 320
SQ8_DIST_BYTES = 1 << 29
# a d-sliced distance pass: PART_IN adds the earlier slices' partial sums,
# PART_OUT leaves its own for the next slice (csrc/sq8_scan.cu)
SQ8_PART_IN, SQ8_PART_OUT = 1, 2
# the plain version's [B, rows] distance block, in elements
_SQ8_PLAIN_ELEMS = 1 << 26


def _sq8_dist_plain(q, qn, qsum, codes, mins, scales, valid):
    """[B, n] asymmetric L2² of queries over u8 rows, as the reference's
    `sq8_search` writes it: the row norm of x̂ = min + scale·u from Σu and
    Σu², the cross term from one f32 product, clamped at 0, +inf where
    `valid` is False."""
    u = codes.float()
    d = codes.shape[1]
    q_dot_u = q @ u.T
    u_sum, u_sq = torch.sum(u, dim=-1), torch.sum(u * u, dim=-1)
    xn = d * mins ** 2 + 2.0 * mins * scales * u_sum + scales ** 2 * u_sq
    q_dot_x = mins[None, :] * qsum[:, None] + scales[None, :] * q_dot_u
    dist = qn[:, None] - 2.0 * q_dot_x + xn[None, :]
    return torch.where(valid[None, :], torch.clamp_min(dist, 0.0), INF)


def sq8_scan_plain(q, qn, qsum, codes, mins, scales, valid, k):
    n = codes.shape[0]
    step = max(k, _SQ8_PLAIN_ELEMS // max(q.shape[0], 1))
    ds, ids = [], []
    for s in range(0, n, step):
        e = min(n, s + step)
        dist = _sq8_dist_plain(q, qn, qsum, codes[s:e], mins[s:e], scales[s:e], valid[s:e])
        dk, pos = topk_rows_plain(dist, min(k, e - s))
        ds.append(dk)
        ids.append(pos + s)
    dk, pos = topk_rows_plain(torch.cat(ds, dim=1), k)
    ik = torch.gather(torch.cat(ids, dim=1), 1, pos.long())
    return dk, torch.where(torch.isinf(dk), -1, ik).to(torch.int32)


def sq8_slices(d: int) -> list[tuple[int, int]]:
    """The column slices (first column, width) K11 reads a row of d codes
    in: one of d rounded up to 16 up to SQ8_D_MAX, else slices of at most
    SQ8_D_MAX."""
    ldr = -(-d // 16) * 16
    return [(c0, min(SQ8_D_MAX, ldr - c0)) for c0 in range(0, ldr, SQ8_D_MAX)]


def sq8_scan(q, qn, qsum, codes, mins, scales, valid, k: int):
    """Asymmetric L2² k-NN of f32 queries over a u8 store (the reference's
    `sq8_search`, ops/quantize.py:42-76).

    q [B, d] f32 with qn = ‖q‖² and qsum = Σq [B]; codes [N, d] uint8,
    mins / scales [N] f32 (x̂ = min + scale·u); valid [N] bool. Distance
    `qn − 2·(min·qsum + scale·(q·u)) + (d·min² + 2·min·scale·Σu +
    scale²·Σu²)` clamped at 0, +inf where not valid. Returns the k
    smallest by (distance, row): ([B, k] f32 ascending, [B, k] int32 row
    ids, -1 where +inf). On CUDA, q·u runs on the int8 tensor cores: the
    u8 codes times four int8 digits of q under a power-of-two scale (exact
    s32 sums, joined in fp32), at any k and any d:
    - k <= SQ8_LIST_MAX and d <= SQ8_D_MAX: one K11 launch (a [B, k] list
      per chunk of SQ8_CHUNK rows, after its row pre-pass) and one K2
      launch merging the chunks;
    - else the distance mode: for each slice of queries whose [rows, N]
      f32 distances fit SQ8_DIST_BYTES (a scratch of min(B, 2^29 / 4N)
      rows, allocated a call), one K11 launch a column slice (`sq8_slices`:
      a row wider than SQ8_D_MAX sums its slices in fp32) and one K2
      selection (its wide form past SEL_MAX).
    Every K11 launch counts. Rows whose d is not a multiple of 16 are
    copied zero-padded to one for the kernel, store and queries, each
    call."""
    b, d = q.shape
    n = codes.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"sq8_scan: need 0 < k <= N, got k={k}, N={n}")
    if not _on_cuda(q, qn, qsum, codes, mins, scales, valid):
        return sq8_scan_plain(q, qn, qsum, codes, mins, scales, valid, k)
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(qsum, "qsum", torch.float32, (b,))
    _check(codes, "codes", torch.uint8, (n, d))
    _check(mins, "mins", torch.float32, (n,))
    _check(scales, "scales", torch.float32, (n,))
    _check(valid, "valid", torch.bool, (n,))
    dev = q.device
    if b == 0:
        return (torch.empty((0, k), device=dev), torch.empty((0, k), dtype=torch.int32, device=dev))
    slices = sq8_slices(d)
    ldr = slices[-1][0] + slices[-1][1]
    if ldr != d:   # the tiles are copied in 16-byte words: rows of ldr codes
        codes = torch.nn.functional.pad(codes, (0, ldr - d))
        q = torch.nn.functional.pad(q, (0, ldr - d))
    elif codes.data_ptr() % 16:
        codes = codes.clone()
    chunk = min(SQ8_CHUNK, -(-n // 64) * 64)
    nch = -(-n // chunk)
    rec = torch.empty((n, 4), dtype=torch.float32, device=dev)   # the rows' ‖x̂‖², min, scale
    store = (codes.data_ptr(), mins.data_ptr(), scales.data_ptr(), _ptr(_as_u8(valid)), n, d, ldr)
    if k <= SQ8_LIST_MAX and len(slices) == 1:
        part_d = torch.empty((b, nch * k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, nch * k), dtype=torch.int32, device=dev)
        _launch("sq8_scan", dev, q.data_ptr(), qn.data_ptr(), qsum.data_ptr(), b, *store,
                0, ldr, chunk, k, part_d.data_ptr(), part_i.data_ptr(), None, 0, rec.data_ptr(),
                0, 0)
        dk, pos = topk_rows(part_d, k)
        ik = torch.gather(part_i, 1, pos.long())
        return dk, torch.where(torch.isinf(dk), -1, ik)
    rows = min(b, max(1, SQ8_DIST_BYTES // (4 * n)))
    dist = torch.empty((rows, n), dtype=torch.float32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    for s in range(0, b, rows):
        e = min(b, s + rows)
        for j, (c0, width) in enumerate(slices):
            part = ((SQ8_PART_IN if j > 0 else 0)
                    | (SQ8_PART_OUT if j + 1 < len(slices) else 0))
            _launch("sq8_scan", dev, q[s:].data_ptr(), qn[s:].data_ptr(), qsum[s:].data_ptr(),
                    e - s, *store, c0, width, chunk, k, None, None, dist.data_ptr(), n,
                    rec.data_ptr(), int(s > 0 or j > 0), part)
        dk, pos = topk_rows(dist[:e - s], k)
        out_d[s:e] = dk
        out_i[s:e] = torch.where(torch.isinf(dk), -1, pos)
    return out_d, out_i


# ---------------------------------------------------------------------------
# K12: IVF cell selection, q·Cᵀ and the P nearest cells in one launch
# ---------------------------------------------------------------------------

# K12's sizes (csrc/cell_select.cu): the widest P and d it takes, the
# centroids of a tile, a query's candidate buffer, the floats of a staged
# centroid row and the stages of its ring
CELLSEL_P_MAX, CELLSEL_D_MAX, CELLSEL_TC = 32, 256, 128
_CELLSEL_CAP, _CELLSEL_KS, _CELLSEL_STAGES = 48, 36, 3
# the fewest queries a call that takes K12: below it (a SQL statement, a
# small batch) the GEMM + K2 pair is faster on an H100 (PERF.md)
CELLSEL_B_MIN = 2048
# an H100's shared memory an SM (each block also holds 1 KB the runtime
# reserves)
_SMEM_SM = 233_472
# a block's own cost in tiles (its queries' copy, the ring's fill, the
# final sorts), as the plan weighs one more segment
_CELLSEL_BLOCK_TILES = 0.25


def cell_select_plain(q, qn, centroids, cnorms, p):
    """K12's plain version: the q·Cᵀ product, then K2's plain version with
    the unclamped L2 epilogue. Returns ([B, p] distances ascending, [B, p]
    int32 cell positions), ties to the lower position."""
    return topk_rows_plain(q @ centroids.T, p, qn, cnorms, epilogue=EPI_L2)


def cell_select_smem(mi: int, d: int) -> int:
    """Bytes of dynamic shared memory a K12 block of 16·mi queries takes at
    d (the library's `cell_select_smem`): the candidate buffers, the ring,
    the centroid norms a stage, the query rows and a count a query."""
    tq = 16 * mi
    return (tq * _CELLSEL_CAP * 8 + _CELLSEL_STAGES * CELLSEL_TC * (_CELLSEL_KS + 1) * 4
            + tq * (d + 4) * 4 + tq * 4 + 16)


@functools.lru_cache(maxsize=4096)
def cell_select_plan(b: int, c: int, d: int, p: int, sms: int):
    """K12's launch for b >= 1 queries over c centroids of d dims at p
    cells on a card of `sms` SMs: (mi, S), a query tile of 16·mi (the
    smallest power of two up to 4 that holds the batch) and S segments of
    the centroid tiles, each
    a block, S the count that fills the card in the fewest tile-steps (the
    blocks' waves times each block's tiles, plus its own cost), the smaller
    on a tie; or None past the kernel's widths: p past CELLSEL_P_MAX or c,
    d past CELLSEL_D_MAX or no multiple of 4."""
    if not (b >= 1 and 0 < p <= min(c, CELLSEL_P_MAX)
            and 0 < d <= CELLSEL_D_MAX and d % 4 == 0):
        return None
    mi = 1
    while mi < 4 and 16 * mi < b:
        mi *= 2
    # two blocks an SM where their shared memory fits (each holds at most 128
    # registers a thread)
    slots = sms * min(2, _SMEM_SM // (cell_select_smem(mi, d) + 1024))
    qt, nt = -(-b // (16 * mi)), -(-c // CELLSEL_TC)
    best = None
    for s in range(1, nt + 1):
        tps = -(-nt // s)
        if (s - 1) * tps >= nt:      # a segment would be empty: the fewer S does it
            continue
        cost = -(-qt * s // slots) * (tps + _CELLSEL_BLOCK_TILES)
        if best is None or cost < best[0]:
            best = (cost, s)
    return mi, best[1]


_sms: dict = {}


def _sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def cell_select_fused(device, b: int, c: int, d: int, p: int) -> bool:
    """Whether `cell_select` of b queries over c centroids of d dims at p
    cells takes K12 on `device`: a CUDA device, at least CELLSEL_B_MIN
    queries, and widths `cell_select_plan` takes; else the GEMM + K2 pair
    or, on the CPU, the plain version."""
    device = torch.device(device)
    return (device.type == "cuda" and b >= CELLSEL_B_MIN
            and cell_select_plan(b, c, d, p, _sm_count(device)) is not None)


def cell_select(q, qn, centroids, cnorms, p: int):
    """The p nearest cells of each query by `(qn[b] + cnorms[c]) − 2·q·C`,
    unclamped (+inf cnorms rank last): `topk_rows(q @ centroids.T, p,
    rown=qn, coln=cnorms, epilogue=EPI_L2)`. q [B, d], qn [B], centroids
    [C, d], cnorms [C] f32. Returns ([B, p] distances ascending, [B, p]
    int32 cell positions), ties to the lower position.

    On CUDA, where `cell_select_fused` says so, one K12 launch
    (`cell_select_kernel`); else the library's fp32 GEMM and K2. On the CPU
    the plain version."""
    b, d = q.shape
    c = centroids.shape[0]
    if not 0 < p <= c:
        raise ValueError(f"cell_select: need 0 < p <= C, got p={p}, C={c}")
    if not _on_cuda(q, qn, centroids, cnorms):
        return cell_select_plain(q, qn, centroids, cnorms, p)
    if not cell_select_fused(q.device, b, c, d, p):
        return topk_rows(q @ centroids.T, p, rown=qn, coln=cnorms, epilogue=EPI_L2)
    return cell_select_kernel(q, qn, centroids, cnorms, p)


def cell_select_kernel(q, qn, centroids, cnorms, p: int):
    """`cell_select` by K12 at any batch (CUDA tensors, widths that
    `cell_select_plan` takes, else ValueError): one launch computes the
    distances tile by tile in fp32 FFMA and keeps each query's best p on
    chip; the [B, C] matrix is never written, and the segments of the
    centroids merge in the same launch."""
    b, d = q.shape
    c = centroids.shape[0]
    plan = cell_select_plan(b, c, d, p, _sm_count(q.device))
    if plan is None:
        raise ValueError(f"cell_select_kernel: no launch for B={b}, C={c}, d={d}, p={p}")
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(centroids, "centroids", torch.float32, (c, d))
    _check(cnorms, "cnorms", torch.float32, (c,))
    if q.data_ptr() % 16:          # the kernel copies rows in 16-byte words
        q = q.clone()
    if centroids.data_ptr() % 16:
        centroids = centroids.clone()
    mi, s = plan
    dev = q.device
    out_d = torch.empty((b, p), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, p), dtype=torch.int32, device=dev)
    part = torch.empty((b, s, p), dtype=torch.int64, device=dev) if s > 1 else None
    counters = _counters(dev, -(-b // (16 * mi))) if s > 1 else None
    _launch("cell_select", dev, q.data_ptr(), qn.data_ptr(), centroids.data_ptr(),
            cnorms.data_ptr(), b, c, d, p, mi, s, out_d.data_ptr(), out_i.data_ptr(),
            _ptr(part), _ptr(counters))
    return out_d, out_i
