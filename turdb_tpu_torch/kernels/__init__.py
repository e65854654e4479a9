"""Wrappers of the hand-written CUDA kernels, their plain PyTorch versions,
and the launch counters.

    K1 ivf_probe_f32  csrc/ivf_probe.cu      fused f32 IVF probe + top-k / candidates
    K2 topk_rows      csrc/topk_rows.cu      exact per-row k-smallest
    K3 kmeans_assign  csrc/kmeans_assign.cu  bf16 nearest-centroid argmin / top-R
    K4 ivf_probe_sq8  csrc/ivf_probe.cu      fused int8 (SQ8) IVF probe + top-k / candidates
    K5 ivf_rerank     csrc/ivf_rerank.cu     exact rerank over the f32 or SQ16 row store

A wrapper given CPU tensors runs the plain version below; given CUDA
tensors it launches its kernel (built at first use) or raises. There is
no fallback from one to the other. `launches[name]` counts kernel
launches only. Selection widths (k, m, r) above SEL_MAX raise ValueError
before any launch.
"""

from __future__ import annotations

import math

import torch

from turdb_tpu_torch.kernels import build
from turdb_tpu_torch.ops.quantize import sq16_decode

INF = math.inf

# epilogues of topk_rows over a dot matrix (EPI_NONE selects on x itself)
EPI_NONE, EPI_L2, EPI_COS, EPI_IP = 0, 1, 2, 3
# widest selection a kernel takes (csrc/select.cuh)
SEL_MAX = 2048
# lanes one probe block scores and selects from; a wider probe (P*L) runs
# one block per chunk of lanes and a merge (csrc/ivf_probe.cu)
PROBE_CHUNK_LANES = 4096
# probe output modes: the final top-k, or the r best lanes for the rerank
MODE_TOPK, MODE_CAND = 0, 1

launches = {"ivf_probe_f32": 0, "topk_rows": 0, "kmeans_assign": 0,
            "ivf_probe_sq8": 0, "ivf_rerank": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when all are on the CPU."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, got {devs}")


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, *args):
    lib = build.library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        # an argument past a kernel's limits (selection width, shared
        # memory) comes back as a CUDA error: the limits live in csrc/
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    launches[name] += 1


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


def topk_rows(x: torch.Tensor, k: int, *, rown=None, coln=None, colvalid=None,
              epilogue: int = EPI_NONE, clamp: bool = False):
    """Exact k smallest of each row of `x` [B, N] f32, after an optional
    epilogue: L2 `(rown[b] + coln[j]) − 2·x[b, j]` (clamped at 0 if
    `clamp`), COS `1 − x`, IP `−x`; lanes where `colvalid` [N] is False
    become +inf. Returns ([B, k] values ascending, [B, k] int32 column
    positions); ties go to the lower position, as `lax.top_k` does."""
    b, n = x.shape
    if not 0 < k <= min(n, SEL_MAX):
        raise ValueError(f"topk_rows: need 0 < k <= min(N, {SEL_MAX}), got k={k}, N={n}")
    if epilogue == EPI_L2 and (rown is None or coln is None):
        raise ValueError("topk_rows: the L2 epilogue needs rown and coln")
    if not _on_cuda(x, rown, coln, colvalid):
        return topk_rows_plain(x, k, rown, coln, colvalid, epilogue, clamp)
    _check(x, "x", torch.float32, (b, n))
    if epilogue == EPI_L2:
        _check(rown, "rown", torch.float32, (b,))
        _check(coln, "coln", torch.float32, (n,))
    if colvalid is not None:
        _check(colvalid, "colvalid", torch.bool, (n,))
    out_d = torch.empty((b, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b:
        _launch("topk_rows", x.data_ptr(), b, n,
                _ptr(rown) if epilogue == EPI_L2 else None,
                _ptr(coln) if epilogue == EPI_L2 else None,
                _ptr(_as_u8(colvalid)), epilogue, int(clamp), k,
                out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i


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
    if mode not in (MODE_TOPK, MODE_CAND):
        raise ValueError(f"{name}: unknown mode {mode}")
    if not 0 < k <= m <= min(n_lanes, SEL_MAX):
        raise ValueError(f"{name}: need 0 < k <= m <= min(P*L, {SEL_MAX}); "
                         f"got k={k}, m={m}, P*L={n_lanes}")
    if mode == MODE_TOPK and not replicated and m != k:
        raise ValueError(f"{name}: m must equal k without replicas")
    if mode == MODE_CAND and m != k:
        raise ValueError(f"{name}: candidate mode returns m = k lanes")
    _check(cells, "cells", torch.int32, (b, p))
    _check(members, "members", torch.int32, (nb, lcap))
    _check(alive, "alive", torch.bool, (nb, lcap))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, (nb, lcap))


def _probe_buffers(b, p, lcap, k, m, mode, device):
    """Outputs of a probe launch, and the scratch rows of a chunked one."""
    width = m if mode == MODE_CAND else k
    out_d = torch.empty((b, width), dtype=torch.float32, device=device)
    out_i = torch.empty((b, width), dtype=torch.int32, device=device)
    out_pos = torch.empty((b, width), dtype=torch.int32, device=device) if mode == MODE_CAND else None
    nchunks = -(-p * lcap // PROBE_CHUNK_LANES)
    scratch = ([torch.empty((b, nchunks * m), dtype=torch.int32, device=device) for _ in range(3)]
               if nchunks > 1 else [None] * 3)
    return out_d, out_i, out_pos, scratch


def _probe_result(out_d, out_i, out_pos):
    return (out_d, out_i) if out_pos is None else (out_d, out_i, out_pos)


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
    ([B, m] distances, [B, m] ids, [B, m] int32 flat positions cell*L + lane)."""
    b, p = cells.shape
    nb, lcap, d = pvecs.shape
    _probe_checks("ivf_probe_f32", cells, members, alive, allowed, k, m, replicated, mode)
    if metric not in (0, 1, 2):
        raise ValueError(f"ivf_probe_f32: unknown metric {metric}")
    if not _on_cuda(q, qn, cells, pvecs, pnorms, members, alive, allowed):
        return ivf_probe_f32_plain(q, qn, cells, pvecs, pnorms, members,
                                   alive, allowed, metric, k, m, replicated, mode)
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(pvecs, "pvecs", torch.float32, (nb, lcap, d))
    _check(pnorms, "pnorms", torch.float32, (nb, lcap))
    if d % 4 or pvecs.data_ptr() % 16:
        raise ValueError("ivf_probe_f32: rows are read as float4, so dim must be a "
                         f"multiple of 4 (got {d}) and pvecs 16-byte aligned")
    out_d, out_i, out_pos, scratch = _probe_buffers(b, p, lcap, k, m, mode, q.device)
    if b:
        _launch("ivf_probe_f32", q.data_ptr(), qn.data_ptr(), cells.data_ptr(),
                b, p, pvecs.data_ptr(), pnorms.data_ptr(), members.data_ptr(),
                _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), lcap, d, metric,
                k, m, int(replicated), mode, PROBE_CHUNK_LANES, *map(_ptr, scratch),
                out_d.data_ptr(), out_i.data_ptr(), _ptr(out_pos))
    return _probe_result(out_d, out_i, out_pos)


# ---------------------------------------------------------------------------
# K4: fused int8 (SQ8) IVF probe
# ---------------------------------------------------------------------------

def ivf_probe_sq8_plain(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members,
                        alive, allowed, k, m, replicated, mode=MODE_TOPK):
    d = codes.shape[2]
    # int8 x int8 products summed in fp32 are exact integers while every
    # partial sum stays below 2**24 (d <= 1024); wider rows sum in fp64
    acc = torch.float32 if d <= 1024 else torch.float64
    qf = qc.to(acc)

    def score(s, src):
        e = s + src.shape[0]
        doti = torch.einsum("bd,bpld->bpl", qf[s:e], codes[src].to(acc)).float()
        q_dot_x = (mins[src] * qsum[s:e, None, None]
                   + scales[src] * (qs[s:e, None, None] * doti))
        return qn[s:e, None, None] - 2.0 * q_dot_x + pnorms[src]

    return _probe_plain(score, cells, members, alive, allowed, 4 * d,
                        k, m, replicated, mode)


def ivf_probe_sq8(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                  allowed=None, *, k: int, m: int, replicated: bool, mode: int = MODE_TOPK):
    """K1's probe over the int8 store: qc [B, d] int8, qs / qsum / qn [B]
    (`ops.quantize.quantize_queries`), codes [NB, L, d] int8 centred,
    mins [NB, L] m′ = min + 128·scale, scales [NB, L], pnorms [NB, L] the
    exact ‖x‖². The distance is `qn − 2·(m′·qsum + scale·(qs·(qc·code))) +
    pnorms`, L2 whatever the index's metric. Selection, modes and returns
    as `ivf_probe_f32`."""
    b, p = cells.shape
    nb, lcap, d = codes.shape
    _probe_checks("ivf_probe_sq8", cells, members, alive, allowed, k, m, replicated, mode)
    if not _on_cuda(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms, members, alive,
                    allowed):
        return ivf_probe_sq8_plain(qc, qs, qsum, qn, cells, codes, mins, scales, pnorms,
                                   members, alive, allowed, k, m, replicated, mode)
    _check(qc, "qc", torch.int8, (b, d))
    for t, name in ((qs, "qs"), (qsum, "qsum"), (qn, "qn")):
        _check(t, name, torch.float32, (b,))
    _check(codes, "codes", torch.int8, (nb, lcap, d))
    for t, name in ((mins, "mins"), (scales, "scales"), (pnorms, "pnorms")):
        _check(t, name, torch.float32, (nb, lcap))
    if d % 4 or codes.data_ptr() % 4 or qc.data_ptr() % 4:
        raise ValueError("ivf_probe_sq8: codes are read as 32-bit words, so dim must be a "
                         f"multiple of 4 (got {d}) and codes / qc 4-byte aligned")
    out_d, out_i, out_pos, scratch = _probe_buffers(b, p, lcap, k, m, mode, qc.device)
    if b:
        _launch("ivf_probe_sq8", qc.data_ptr(), qs.data_ptr(), qsum.data_ptr(),
                qn.data_ptr(), cells.data_ptr(), b, p, codes.data_ptr(), mins.data_ptr(),
                scales.data_ptr(), pnorms.data_ptr(), members.data_ptr(),
                _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), lcap, d, k, m,
                int(replicated), mode, PROBE_CHUNK_LANES, *map(_ptr, scratch),
                out_d.data_ptr(), out_i.data_ptr(), _ptr(out_pos))
    return _probe_result(out_d, out_i, out_pos)


# ---------------------------------------------------------------------------
# K5: exact rerank
# ---------------------------------------------------------------------------

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
    candidate index): ([B, k] f32 ascending, [B, k] int32 ids, -1 where +inf)."""
    b, r = cand_d.shape
    nb, lcap, d = pvecs.shape
    sq16 = pvecs.dtype == torch.int16
    if not 0 < k <= r <= SEL_MAX:
        raise ValueError(f"ivf_rerank: need 0 < k <= r <= {SEL_MAX}; got k={k}, r={r}")
    if sq16 and (mins is None or scales is None):
        raise ValueError("ivf_rerank: the SQ16 store needs mins and scales")
    store_meta = (mins, scales) if sq16 else ()
    if not _on_cuda(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, *store_meta):
        return ivf_rerank_plain(q, qn, cand_d, cand_i, cand_pos, pvecs, pnorms, mins,
                                scales, k, replicated)
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(cand_d, "cand_d", torch.float32, (b, r))
    _check(cand_i, "cand_i", torch.int32, (b, r))
    _check(cand_pos, "cand_pos", torch.int32, (b, r))
    _check(pvecs, "pvecs", torch.int16 if sq16 else torch.float32, (nb, lcap, d))
    _check(pnorms, "pnorms", torch.float32, (nb, lcap))
    for t, name in zip(store_meta, ("mins", "scales")):
        _check(t, name, torch.float32, (nb, lcap))
    if d % 4 or pvecs.data_ptr() % 16:
        raise ValueError("ivf_rerank: rows are read 4 elements at a time, so dim must be a "
                         f"multiple of 4 (got {d}) and pvecs 16-byte aligned")
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b:
        _launch("ivf_rerank", q.data_ptr(), qn.data_ptr(), cand_d.data_ptr(),
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


def kmeans_assign(x, cents, xn, cn, r: int = 1):
    """Nearest centroids of each row: x [n, d] and cents [C, d] are rounded
    to bf16, their products summed in fp32, and `(xn + cn) − 2·dot` ranked.
    Returns ([n, r] int32 ids, [n, r] f32 distances) ascending, lowest id
    on ties (as `jnp.argmin` / `lax.top_k`). cn = +inf never wins; a row of
    all +inf returns ids 0..r-1."""
    n, d = x.shape
    c = cents.shape[0]
    if not 1 <= r <= min(R_MAX, c):
        raise ValueError(f"kmeans_assign: need 1 <= r <= min({R_MAX}, C), got r={r}, C={c}")
    if not _on_cuda(x, cents, xn, cn):
        return kmeans_assign_plain(x, cents, xn, cn, r)
    _check(x, "x", torch.float32, (n, d))
    _check(cents, "cents", torch.float32, (c, d))
    _check(xn, "xn", torch.float32, (n,))
    _check(cn, "cn", torch.float32, (c,))
    out_i = torch.empty((n, r), dtype=torch.int32, device=x.device)
    out_d = torch.empty((n, r), dtype=torch.float32, device=x.device)
    if n:
        _launch("kmeans_assign", x.data_ptr(), xn.data_ptr(), n, cents.data_ptr(),
                cn.data_ptr(), c, d, r, out_i.data_ptr(), out_d.data_ptr())
    return out_i, out_d
