"""Exact k nearest neighbours by squared L2, in plain PyTorch.

`exact_knn(..., precision="fp32")` is the reference: candidates by the
expansion ‖q‖² + ‖x‖² − 2q·x in fp32 with TF32 off, then the best `refine`
of each query recomputed as Σ(q − x)² in float64 and the k best of those
kept, so that the expansion's rounding cannot reorder the k-th neighbour.
`precision="tf32"` is the control: the same search with the product in
TF32 (on the card the library's TF32 path; on the CPU, which has none, the
inputs rounded to TF32's 10-bit mantissa) and its own distances returned,
no refinement. `row_dists` gives the exact distance of given pairs, which
judges the distances a search returns. Squared L2 is the only distance
implemented: `require_metric` refuses a configuration on any other before
a run does any work, rather than judge its answers against L2 truth.
"""

from __future__ import annotations

import contextlib

import torch

METRICS = ("l2",)


def require_metric(metric: str) -> None:
    """Raise unless the reference implements the configuration's `metric`."""
    if metric not in METRICS:
        raise ValueError(f"the reference implements {METRICS} only; a configuration on "
                         f"{metric!r} needs exact_knn, row_dists and the judge extended")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for fp32 products on or off within the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits, to nearest, ties to even),
    as the tensor cores read their fp32 inputs."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def row_dists(base: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Σ(q − x)² in float64 for each query's given base rows: [B, m] ids
    (each in range) -> [B, m] float64."""
    x = base[ids].double()
    return (queries.double()[:, None, :] - x).pow(2).sum(-1)


def exact_knn(base: torch.Tensor, queries: torch.Tensor, k: int, *, block: int = 1024,
              refine: int = 32, precision: str = "fp32"):
    """([B, k] distances ascending, [B, k] int64 ids) of the k base rows
    nearest each query. `base` [N, d] and `queries` [B, d] fp32 on one
    device; the work goes `block` queries at a time."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    control = precision == "tf32"
    emulate = control and base.device.type != "cuda"
    xb = round_tf32(base) if emulate else base.float()
    xn = base.float().pow(2).sum(1)
    out_d, out_i = [], []
    with tf32(control):
        for s in range(0, queries.shape[0], block):
            q = queries[s:s + block].float()
            qn = q.pow(2).sum(1)
            dist = (round_tf32(q) if emulate else q) @ xb.T
            dist.mul_(-2.0).add_(xn[None, :]).add_(qn[:, None])
            if control:
                d, i = torch.topk(dist, k, dim=1, largest=False)
            else:
                _, cand = torch.topk(dist, min(refine, base.shape[0]), dim=1, largest=False)
                exact = row_dists(base, q, cand)
                d, pos = torch.topk(exact, k, dim=1, largest=False)
                i = torch.gather(cand, 1, pos)
                d = d.float()
            del dist
            out_d.append(d)
            out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
