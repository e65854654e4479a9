"""Exact k-smallest selection, dedup and membership (port of
turdb_tpu/ops/topk.py). Selection runs kernel K2 (`topk_rows`) on CUDA
tensors and its plain version on CPU tensors; ties go to the lower
index, as `lax.top_k` does. `mask_duplicates` lives beside K1, whose
plain version uses it."""

from __future__ import annotations

import torch

from turdb_tpu_torch.kernels import mask_duplicates, topk_rows

INF = float("inf")


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest distances (with their ids) along the last axis.

    dists [..., n] f32 (inf = invalid), ids [..., n] int32.
    Returns ([..., k] dists, [..., k] ids), ascending."""
    lead = dists.shape[:-1]
    vals, pos = topk_rows(_rows(dists.float()), k)
    sel = torch.gather(_rows(ids), 1, pos.long())
    return vals.reshape(*lead, k), sel.reshape(*lead, k)


def topk_smallest_wide(dists: torch.Tensor, k: int):
    """EXACT k smallest over a wide last axis: ([..., k] values ascending,
    [..., k] int32 positions).

    The reference selects in two levels (bucket minima, then a re-scan of
    the winning buckets) because a full-row TPU sort was its probe's
    ceiling; K2 is exact in one pass over the row, so both are the same
    function here. Equal values in different buckets are the one place the
    two can order differently: the reference ranks them by bucket, K2
    always by position."""
    lead = dists.shape[:-1]
    vals, pos = topk_rows(_rows(dists.float()), k)
    return vals.reshape(*lead, k), pos.reshape(*lead, k)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two top-k buffers into one, keeping the k smallest."""
    return topk_smallest(torch.cat([d_a, d_b], dim=-1),
                         torch.cat([i_a, i_b], dim=-1), k)


def member_mask(ids: torch.Tensor, table: torch.Tensor, invalid_id: int = -1):
    """ids [..., n] vs table [..., m] -> bool [..., n]: True where ids[i]
    appears in table; invalid ids never match."""
    hit = torch.any(ids[..., :, None] == table[..., None, :], dim=-1)
    return hit & (ids != invalid_id)
