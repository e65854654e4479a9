"""Batched vector distances (port of turdb_tpu/ops/distance.py).

Every metric is "smaller is closer", with the heavy term one fp32 matmul:

    L2²(q, x)  = ‖q‖² + ‖x‖² − 2·q·xᵀ
    cos(q, x)  = 1 − q̂·x̂ᵀ          (unit-normalized operands)
    ip(q, x)   = −q·xᵀ

Matmuls run in true fp32: the package turns TF32 off at import.
"""

from __future__ import annotations

import enum

import torch


class Metric(enum.Enum):
    """Distance metric; `.value`s equal the reference enum's."""

    L2 = 0          # squared euclidean
    COSINE = 1
    IP = 2          # inner product (negated dot)

    @classmethod
    def from_name(cls, name: str) -> "Metric":
        return {
            "l2": cls.L2,
            "euclidean": cls.L2,
            "cosine": cls.COSINE,
            "ip": cls.IP,
            "dot": cls.IP,
            "inner_product": cls.IP,
        }[name.lower()]


def prep_norms(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² per row, in fp32."""
    x = x.float()
    return torch.sum(x * x, dim=-1)


def chain_norms(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² per row as a fused multiply-add chain over the columns in
    order, one fp32 rounding a step: the order of the reference's jitted
    row norms (XLA:CPU, d = 32). `prep_norms` sums in the order of the
    device's vector kernels, which differs from one CPU to another. Each
    step is computed in float64 and rounded once, so the result is the
    same on every device. The k-means norms use it: a build's cells hang on
    near-ties of `‖x‖² + ‖c‖² − 2·x·c`, which a last-bit norm flips."""
    x = x.float()
    acc = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
    for j in range(x.shape[-1]):
        col = x[..., j].double()
        acc = (acc + col * col).float().double()
    return acc.float()


def normalize_rows(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(n, eps)


def _epilogue(dots, metric, qn, xn, clamp: bool):
    if metric is Metric.L2:
        d = qn + xn - 2.0 * dots
        return torch.clamp_min(d, 0.0) if clamp else d
    if metric is Metric.COSINE:
        return 1.0 - dots
    if metric is Metric.IP:
        return -dots
    raise ValueError(f"unknown metric {metric}")


def pairwise_distances(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric = Metric.L2,
    x_norms: torch.Tensor | None = None,
    q_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, d] x [N, d] -> [B, N] distance matrix (L2 clamped at 0)."""
    q = q.float()
    dots = q @ x.float().T
    if metric is not Metric.L2:
        return _epilogue(dots, metric, None, None, False)
    qn = prep_norms(q) if q_norms is None else q_norms
    xn = prep_norms(x) if x_norms is None else x_norms
    return _epilogue(dots, metric, qn[:, None], xn[None, :], True)


def gathered_distances(
    q: torch.Tensor,
    vecs: torch.Tensor,
    metric: Metric = Metric.L2,
    vec_norms: torch.Tensor | None = None,
    q_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-query gathered candidates: q [B, d], vecs [B, K, d] -> [B, K]."""
    q = q.float()
    vecs = vecs.float()
    dots = torch.einsum("bd,bkd->bk", q, vecs)
    if metric is not Metric.L2:
        return _epilogue(dots, metric, None, None, False)
    qn = prep_norms(q) if q_norms is None else q_norms
    vn = prep_norms(vecs) if vec_norms is None else vec_norms
    return _epilogue(dots, metric, qn[:, None], vn, True)


def self_distances(x: torch.Tensor, metric: Metric = Metric.L2) -> torch.Tensor:
    """All-pairs [N, N] distances."""
    return pairwise_distances(x, x, metric)
