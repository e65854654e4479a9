"""Wrappers of the hand-written CUDA kernels, their plain PyTorch versions,
and the launch counters.

    K1 ivf_probe_f32  csrc/ivf_probe.cu      fused f32 IVF probe + top-k
    K2 topk_rows      csrc/topk_rows.cu      exact per-row k-smallest
    K3 kmeans_assign  csrc/kmeans_assign.cu  bf16 nearest-centroid argmin / top-R

A wrapper given CPU tensors runs the plain version below; given CUDA
tensors it launches its kernel (built at first use) or raises. There is
no fallback from one to the other. `launches[name]` counts kernel
launches only.
"""

from __future__ import annotations

import math

import torch

from turdb_tpu_torch.kernels import build

INF = math.inf

# epilogues of topk_rows over a dot matrix (EPI_NONE selects on x itself)
EPI_NONE, EPI_L2, EPI_COS, EPI_IP = 0, 1, 2, 3

launches = {"ivf_probe_f32": 0, "topk_rows": 0, "kmeans_assign": 0}


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
    if not 0 < k <= n:
        raise ValueError(f"topk_rows: need 0 < k <= N, got k={k}, N={n}")
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


def ivf_probe_f32_plain(q, qn, cells, pvecs, pnorms, members, alive, allowed,
                        metric, k, m, replicated):
    b, p = cells.shape
    lcap, d = pvecs.shape[1], pvecs.shape[2]
    # the [b, P, L, d] gather is bounded to ~512 MB of temporaries
    bmax = max(1, (1 << 27) // (p * lcap * d))
    outs = []
    for s in range(0, b, bmax):
        src = cells[s:s + bmax].long()
        mem = members[src]                                   # [b, P, L]
        live = (mem >= 0) & alive[src]
        if allowed is not None:
            live = live & allowed[src]
        dots = torch.einsum("bd,bpld->bpl", q[s:s + bmax], pvecs[src])
        if metric == 0:
            dist = (qn[s:s + bmax, None, None] + pnorms[src]) - 2.0 * dots
        elif metric == 1:
            dist = 1.0 - dots
        else:
            dist = -dots
        nb = src.shape[0]
        dist = torch.where(live, dist, INF).reshape(nb, p * lcap)
        ids = mem.reshape(nb, p * lcap)
        if replicated:
            d0, pos = topk_rows_plain(dist, m)
            i0, d0 = mask_duplicates(torch.gather(ids, 1, pos.long()), d0)
            dk, pos = topk_rows_plain(d0, k)
            ik = torch.gather(i0, 1, pos.long())
        else:
            dk, pos = topk_rows_plain(dist, k)
            ik = torch.gather(ids, 1, pos.long())
        outs.append((dk, torch.where(torch.isinf(dk), -1, ik).to(torch.int32)))
    if not outs:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def ivf_probe_f32(q, qn, cells, pvecs, pnorms, members, alive, allowed=None, *,
                  metric: int, k: int, m: int, replicated: bool):
    """Score the probed cells of each query and select its k nearest.

    q [B, d] f32, qn [B] = ‖q‖², cells [B, P] int32 (the probed cells),
    pvecs [NB, L, d] f32, pnorms [NB, L], members [NB, L] int32 (-1 = empty),
    alive / allowed [NB, L] bool. Distances follow `metric` (Metric.value):
    L2 `(qn + pnorms) − 2·dot`, COSINE `1 − dot`, IP `−dot`; dead, empty
    and unallowed lanes are +inf. Without `replicated` the k smallest by
    (distance, lane position) are returned; with it the m smallest are
    taken, later copies of an id dropped, and the first k survivors kept.
    Returns ([B, k] f32 ascending, [B, k] int32 ids, -1 where +inf)."""
    b, p = cells.shape
    nb, lcap, d = pvecs.shape
    n_lanes = p * lcap
    if not 0 < k <= m <= n_lanes:
        raise ValueError(f"ivf_probe_f32: need 0 < k <= m <= P*L; "
                         f"got k={k}, m={m}, P*L={n_lanes}")
    if not replicated and m != k:
        raise ValueError("ivf_probe_f32: m must equal k without replicas")
    if metric not in (0, 1, 2):
        raise ValueError(f"ivf_probe_f32: unknown metric {metric}")
    if not _on_cuda(q, qn, cells, pvecs, pnorms, members, alive, allowed):
        return ivf_probe_f32_plain(q, qn, cells, pvecs, pnorms, members,
                                   alive, allowed, metric, k, m, replicated)
    _check(q, "q", torch.float32, (b, d))
    _check(qn, "qn", torch.float32, (b,))
    _check(cells, "cells", torch.int32, (b, p))
    _check(pvecs, "pvecs", torch.float32, (nb, lcap, d))
    _check(pnorms, "pnorms", torch.float32, (nb, lcap))
    _check(members, "members", torch.int32, (nb, lcap))
    _check(alive, "alive", torch.bool, (nb, lcap))
    if allowed is not None:
        _check(allowed, "allowed", torch.bool, (nb, lcap))
    if d % 4 or pvecs.data_ptr() % 16:
        raise ValueError("ivf_probe_f32: rows are read as float4, so dim must be a "
                         f"multiple of 4 (got {d}) and pvecs 16-byte aligned")
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b:
        _launch("ivf_probe_f32", q.data_ptr(), qn.data_ptr(), cells.data_ptr(),
                b, p, pvecs.data_ptr(), pnorms.data_ptr(), members.data_ptr(),
                _ptr(_as_u8(alive)), _ptr(_as_u8(allowed)), lcap, d, metric,
                k, m, int(replicated), out_d.data_ptr(), out_i.data_ptr())
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
