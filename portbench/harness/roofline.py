"""Peaks of one NVIDIA H100 SXM and the least time a kernel could take.

`bound` is a frozen copy of `chip_smoke.py`'s `_bound`. `probe_bound`
counts an IVF probe's work as `chip_smoke.py`'s `_probe_bound` does, but
over the benchmark's own partition of the rows (`plain_partition`), not
over the cells the program built: the yardstick lives here so that no
change to the program, its cell layout included, moves it. Peaks are
NVIDIA's published dense rates at the full 700 W (a card set below it
runs slower; the result line names the card)."""

from __future__ import annotations

import torch

from portbench.reference.knn import tf32

HBM_BPS = 3.35e12        # bytes/s
FP32_OPS = 67e12         # fp32 outside the tensor cores
BF16_OPS = 989e12
INT8_OPS = 1979e12


def bound(nbytes, ops, peak=None):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the unit's peak. `ops` may
    instead be a list of (operations, peak) for work on several units."""
    work = [(ops, peak)] if peak is not None else ops
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, sum(o / pk for o, pk in work) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": float(nbytes), "bound_ops": float(sum(o for o, _ in work))}


def plain_partition(base: torch.Tensor, cells: int, block: int = 16384):
    """The benchmark's own partition of the rows, which no change to the
    program moves: `cells` centroids, the rows at a stride of n // cells
    (the rows are drawn in random order), and each row's nearest of them
    in fp32 with TF32 off. Returns (centroids [cells, d], their squared
    norms [cells], rows a cell holds [cells])."""
    n = base.shape[0]
    cent = base[:: n // cells][:cells].float().contiguous()
    cn = cent.pow(2).sum(1)
    counts = torch.zeros(cells, dtype=torch.long, device=base.device)
    with tf32(False):
        for s in range(0, n, block):
            near = (cn[None, :] - 2.0 * (base[s:s + block].float() @ cent.T)).argmin(1)
            counts += torch.bincount(near, minlength=cells)
    return cent, cn, counts


def probed_cells(queries: torch.Tensor, cent: torch.Tensor, cn: torch.Tensor, nprobe: int):
    """[B, nprobe] ids of each query's nearest centroids (TF32 off)."""
    with tf32(False):
        dist = cn[None, :] - 2.0 * (queries.float() @ cent.T)
    return torch.topk(dist, nprobe, dim=1, largest=False).indices


def probe_bound(probes: torch.Tensor, sizes: torch.Tensor, d: int, k: int, peak=FP32_OPS):
    """Bound of an IVF probe of one call over a partition: `probes` [B, P]
    the cells each query probes, `sizes` [cells] the rows each holds. Each
    probed cell's rows are read once a call however many queries probe it
    (row, norm and id: 4d + 8 bytes a row), each query (row and norm), its
    cell list and its k (distance, id) outputs once; 2d operations a
    (query, row of a cell it probes)."""
    b, p = probes.shape
    rows = int(sizes[torch.unique(probes)].sum())
    nbytes = rows * (4 * d + 8) + b * (4 * d + 4) + b * p * 4 + b * k * 8
    return bound(nbytes, 2 * d * int(sizes[probes].sum()), peak)
