"""HNSW serving layout on PyTorch (port of turdb_tpu/models/hnsw_serve.py):
packed neighbour blocks searched by an int8 beam, then an exact rerank.

The pack is derived from a built graph's level 0 and its rows
(`pack_serving`):
    nbr_codes    [cap, M0, d] int8: for every node, the centred SQ8 codes of
                 its M0 neighbours, contiguous (one block per expansion)
    nbr_meta     [cap, M0, 4] int32: per neighbour (f32 base, f32 scale,
                 f32 ‖x‖², as bits; the neighbour id), one 16-byte record
    centroids    [C, d], cnorms [C] (+inf for empty cells): the coarse
                 quantizer that seeds the beam
    cell_*       [C, L]: each cell's members, packed as the IVF store K4
                 reads (codes [C, L, d], base, scale, norms, ids, alive)
    vectors, norms: the exact rerank store
Search (`serve_search_impl`): q·Cᵀ and the selection in one launch (K12,
`kernels.cell_select`) pick the `nprobe` nearest cells, K4 scores their
members (with the pack's metric)
and its top min(nseed, ef, P·L) seed the beam; K6 runs the int8 beam over
the packed blocks and the exact rerank with the visibility mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from turdb_tpu_torch.kernels import cell_select, hnsw_serve_beam, ivf_probe_sq8
from turdb_tpu_torch.models.hnsw import count_beam
from turdb_tpu_torch.models.ivf import count_select
from turdb_tpu_torch.ops.distance import Metric, prep_norms
from turdb_tpu_torch.ops.quantize import quantize_queries
from turdb_tpu_torch.utils.timing import count, span

INF = float("inf")
_INV_255 = float(np.float32(1.0 / 255.0))
_128_OVER_255 = float(np.float32(128.0 / 255.0))


class HnswServeState(NamedTuple):
    """The serving pack on the device; see the module docstring."""

    nbr_codes: torch.Tensor    # [cap, M0, d] int8
    nbr_meta: torch.Tensor     # [cap, M0, 4] int32
    centroids: torch.Tensor    # [C, d]
    cnorms: torch.Tensor       # [C]
    cell_codes: torch.Tensor   # [C, L, d] int8
    cell_mins: torch.Tensor    # [C, L] base = min + 128·scale
    cell_scales: torch.Tensor  # [C, L]
    cell_norms: torch.Tensor   # [C, L] ‖x‖², +inf for empty lanes
    cell_members: torch.Tensor  # [C, L] int32 row ids, -1 empty
    cell_alive: torch.Tensor   # [C, L] bool (all True)
    vectors: torch.Tensor      # [cap, d] f32 rerank store
    norms: torch.Tensor        # [cap]


def serve_search_impl(state: HnswServeState, queries: torch.Tensor, allowed, *,
                      metric: Metric, k: int, ef: int, iters: int, expand: int = 4,
                      nprobe: int = 2, nseed: int = 32, rerank: int = 0):
    """Two-stage batched k-NN over the serving pack: cell-probe seeding,
    the int8 beam, and the exact rerank of the `rerank` best (0: all ef),
    `allowed` [cap] bool or None applied at the rerank (hidden nodes are
    traversed). Returns ([B, k] exact distances ascending, [B, k] int32
    slots, -1 padded)."""
    with span("turdb.serve.seed"):
        q = queries.float().contiguous()
        qn = prep_norms(q)
        qc, qs, qsum = quantize_queries(q)
        seed_d, seed_i = serve_seeds(state, q, qn, qc, qs, qsum, metric=metric, ef=ef,
                                     nprobe=nprobe, nseed=nseed)
    with span("turdb.serve.beam"):
        d, i, stats = hnsw_serve_beam(state.nbr_codes, state.nbr_meta, state.vectors,
                                      state.norms, q, qn, qc, qs, qsum, seed_i, seed_d, allowed,
                                      ef=ef, iters=iters, expand=expand, rerank=rerank, k=k,
                                      metric=metric.value)
        count_beam("turdb.serve.beam", stats, state.nbr_codes.shape[1], seed_i.shape[1])
        # the exact rows the rerank reads: min(rerank or ef, ef) a query
        count("turdb.serve.beam.reranked", q.shape[0] * min(rerank or ef, ef))
    return d, i


def serve_seeds(state: HnswServeState, q, qn, qc, qs, qsum, *, metric: Metric, ef: int,
                nprobe: int, nseed: int):
    """The beam's seeds: the `nprobe` nearest cells (K12, L2 for every
    metric, unclamped), then K4 over their members with the metric's
    epilogue, top min(nseed, ef, P·L). Returns ([B, s] distances, [B, s]
    int32 ids, -1 where +inf)."""
    p = min(nprobe, state.centroids.shape[0])
    count_select(q, state.centroids, p)
    _, top = cell_select(q, qn, state.centroids, state.cnorms, p)
    s = min(nseed, ef, p * state.cell_members.shape[1])
    return ivf_probe_sq8(qc, qs, qsum, qn, top, state.cell_codes, state.cell_mins,
                         state.cell_scales, state.cell_norms, state.cell_members,
                         state.cell_alive, None, k=s, m=s, replicated=False,
                         metric=metric.value)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _sq8_centered(x: torch.Tensor):
    """Per-row centred int8 encode: x ≈ base + scale·c, c ∈ [-128, 127],
    base ≈ min + 128·scale. Rounded as the reference's compiled program
    rounds it: XLA turns `(max − min) / 255` into a product with
    fl32(1/255), and `min + 128·scale` into one fused multiply-add
    `min + (max − min)·fl32(128/255)` (here in fp64, whose product is exact
    and whose sum rounds once before fp32), so the pack's codes and meta
    are the reference's bit for bit."""
    mins = torch.amin(x, dim=-1)
    span = torch.amax(x, dim=-1) - mins
    scales = span * _INV_255
    safe = torch.where(scales == 0, 1.0, scales)
    u = torch.clamp(torch.round((x - mins[:, None]) / safe[:, None]), 0, 255)
    base = (mins.double() + span.double() * _128_OVER_255).float()
    return (u.to(torch.int16) - 128).to(torch.int8), base, scales


def _pack_meta(base, scale, norm, ids):
    """(base, scale, norm) f32 as bits and the ids, in one int32 record."""
    f = torch.stack([base, scale, norm], dim=-1).contiguous().view(torch.int32)
    return torch.cat([f, ids[..., None].to(torch.int32)], dim=-1)


def pack_serving(vectors: torch.Tensor, norms: torch.Tensor, adj0: torch.Tensor, size: int,
                 metric: Metric, n_centroids: int | None = None, chunk: int = 1 << 16,
                 lane_cap: int | None = None, pack_m: int | None = None) -> HnswServeState:
    """Build the serving pack from a graph's level 0 and rows (see the
    module docstring). `pack_m` packs only each node's first pack_m level-0
    neighbours (diversity-selected first): the memory knob. The coarse
    quantizer draws its training rows and seeds from
    `np.random.default_rng(0)`, as the reference does."""
    from turdb_tpu_torch.models.ivf import _assign_all, _kmeans

    cap, d = vectors.shape
    dev = vectors.device
    if pack_m is not None and pack_m < adj0.shape[-1]:
        adj0 = adj0[:, :pack_m]
    m0 = adj0.shape[-1]
    codes, base, scale = _sq8_centered(vectors)

    nbr_codes = torch.zeros((cap, m0, d), dtype=torch.int8, device=dev)
    nbr_meta = torch.full((cap, m0, 4), -1, dtype=torch.int32, device=dev)
    for s in range(0, size, chunk):
        adj_rows = adj0[s:min(size, s + chunk)]
        safe = adj_rows.clamp_min(0).long()
        ok = adj_rows >= 0
        nbr_codes[s:s + len(adj_rows)] = codes[safe]
        nbr_meta[s:s + len(adj_rows)] = _pack_meta(
            torch.where(ok, base[safe], 0.0), torch.where(ok, scale[safe], 0.0),
            torch.where(ok, norms[safe], INF), adj_rows)

    # ---- coarse quantizer (seeding) --------------------------------------
    c = n_centroids or max(64, min(8192, size // 256))
    c = _pow2_at_least(min(c, max(1, size)), floor=64)
    rng = np.random.default_rng(0)
    n_train = min(size, max(c * 32, 65_536))
    tr = rng.choice(size, size=n_train, replace=False)
    seeds0 = rng.choice(n_train, size=min(c, n_train), replace=False)
    xt = vectors[torch.as_tensor(tr, device=dev)]
    init = torch.zeros((c, d), device=dev)
    init[:len(seeds0)] = xt[torch.as_tensor(seeds0, device=dev)]
    cents = _kmeans(xt, init, iters=6)
    del xt
    assign = _assign_all(vectors[:size], cents).cpu().numpy()
    # balanced cell packing: lane = rank within the cell's run; rows past
    # the lane cap are dropped (the beam reaches them through the graph)
    counts = np.bincount(assign, minlength=c)
    lcap = lane_cap or _pow2_at_least(max(int(2 * size / max(c, 1)), 8), floor=8)
    members = np.full((c, lcap), -1, np.int64)
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    first = np.zeros(size, bool)
    if size:
        first[0] = True
        first[1:] = sa[1:] != sa[:-1]
    run_start = np.flatnonzero(first)
    start_of = np.zeros(c, np.int64)
    start_of[sa[run_start]] = run_start
    lane = np.arange(size) - start_of[sa]
    ok = lane < lcap
    members[sa[ok], lane[ok]] = order[ok]
    cnorms = torch.where(torch.as_tensor(counts > 0, device=dev), prep_norms(cents), INF)
    mem = torch.as_tensor(members.astype(np.int32), device=dev)
    msafe = mem.clamp_min(0).long()
    mok = mem >= 0
    return HnswServeState(
        nbr_codes=nbr_codes,
        nbr_meta=nbr_meta,
        centroids=cents,
        cnorms=cnorms,
        cell_codes=torch.where(mok[..., None], codes[msafe], 0).to(torch.int8),
        cell_mins=torch.where(mok, base[msafe], 0.0),
        cell_scales=torch.where(mok, scale[msafe], 0.0),
        cell_norms=torch.where(mok, norms[msafe], INF),
        cell_members=mem,
        cell_alive=torch.ones((c, lcap), dtype=torch.bool, device=dev),
        vectors=vectors,
        norms=norms,
    )


def _pow2_at_least(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
