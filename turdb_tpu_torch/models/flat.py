"""Flat (exact) k-NN over a device-resident vector store (port of
turdb_tpu/models/flat.py) — the recall oracle of the IVF engine.

Each chunk of the store is one fp32 `[B, d] x [d, chunk]` matmul whose
dot matrix goes straight into kernel K2 (`topk_rows`) with the L2 /
cosine / IP epilogue and the valid mask fused in; a running merge keeps
the best k over chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.kernels import EPI_L2, topk_rows
from turdb_tpu_torch.ops.distance import Metric, normalize_rows, prep_norms
from turdb_tpu_torch.ops.topk import merge_topk

INVALID_ID = -1


def flat_search(
    queries: torch.Tensor,   # [B, d]
    vectors: torch.Tensor,   # [N, d]
    norms: torch.Tensor,     # [N] ‖x‖² (inf for padding rows)
    valid: torch.Tensor,     # [N] bool — False for padding/deleted rows
    k: int,
    metric: Metric = Metric.L2,
    chunk: int = 131072,
):
    """Exact k-NN. Returns ([B, k] dists ascending, [B, k] int32 ids,
    -1 where the distance is +inf)."""
    q = queries.float().contiguous()
    n = vectors.shape[0]
    b = q.shape[0]
    qn = prep_norms(q)
    best_d = torch.full((b, k), float("inf"), device=q.device)
    best_i = torch.full((b, k), INVALID_ID, dtype=torch.int32, device=q.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        dots = q @ vectors[s:e].T
        cd, cpos = topk_rows(dots, min(k, e - s), rown=qn, coln=norms[s:e],
                             colvalid=valid[s:e], epilogue=metric.value + EPI_L2,
                             clamp=True)
        best_d, best_i = merge_topk(best_d, best_i, cd, cpos + s, k)
    best_i = torch.where(torch.isinf(best_d), INVALID_ID, best_i)
    return best_d, best_i


class FlatIndex:
    """Append-only store with tombstone deletes; capacity grows by
    doubling from 1024. Runs on the card unless `device` says otherwise."""

    def __init__(self, dim: int, metric: Metric = Metric.L2, capacity: int = 4096,
                 *, device="cuda"):
        self.dim = dim
        self.metric = metric
        self.device = torch.device(device)
        self.capacity = _round_pow2(max(capacity, 1024))
        self.size = 0
        self._vectors = torch.zeros((self.capacity, dim), device=self.device)
        self._norms = torch.full((self.capacity,), float("inf"), device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)

    def __len__(self):
        return self.size

    def add(self, vecs) -> np.ndarray:
        """Append rows; returns their slot ids."""
        v = torch.as_tensor(np.atleast_2d(np.asarray(vecs, np.float32)),
                            device=self.device)
        n = v.shape[0]
        self._ensure(self.size + n)
        if self.metric is Metric.COSINE:
            v = normalize_rows(v)
        sl = slice(self.size, self.size + n)
        self._vectors[sl] = v
        self._norms[sl] = prep_norms(v)
        self._valid[sl] = True
        ids = np.arange(self.size, self.size + n)
        self.size += n
        return ids

    def delete(self, slot_ids) -> None:
        idx = torch.as_tensor(np.atleast_1d(np.asarray(slot_ids, np.int64)),
                              device=self.device)
        self._valid[idx] = False

    def search(self, queries, k: int, valid_mask=None):
        """Returns (dists [B, k], slot_ids [B, k]) as numpy arrays."""
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        if self.metric is Metric.COSINE:
            q = normalize_rows(q)
        valid = self._valid
        if valid_mask is not None:
            vm = torch.as_tensor(np.asarray(valid_mask, bool), device=self.device)
            m = torch.zeros_like(valid)
            m[: len(vm)] = vm
            valid = valid & m
        d, i = flat_search(q, self._vectors, self._norms, valid, k, self.metric,
                           min(131072, self.capacity))
        return d.cpu().numpy(), i.cpu().numpy()

    def get(self, slot_ids) -> np.ndarray:
        idx = torch.as_tensor(np.asarray(slot_ids, np.int64), device=self.device)
        return self._vectors[idx].cpu().numpy()

    def _ensure(self, need: int):
        if need <= self.capacity:
            return
        new_cap = _round_pow2(need)
        pad = new_cap - self.capacity
        dev = self.device
        self._vectors = torch.cat([self._vectors, torch.zeros((pad, self.dim), device=dev)])
        self._norms = torch.cat([self._norms, torch.full((pad,), float("inf"), device=dev)])
        self._valid = torch.cat([self._valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
        self.capacity = new_cap


def _round_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p
