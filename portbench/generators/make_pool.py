"""The bench's clustered pool (`make_pool` of the reference bench and of
`turdb_tpu_torch/utils/datasets.py`), frozen here and drawn on the device.

`n_clusters` centres N(0, 16·I); each row is a centre picked uniformly plus
a radius U(0.3, 1.7) times N(0, I) noise: SIFT-like clustered structure,
not uniform. The store (the centres and the base rows) is drawn from the
configuration's `store_seed`, so every run indexes and searches the same
rows and the seed does not change the work; the queries are drawn from the
run's seed (`gen`) around the same centres, so each seed asks new
questions of that store. `store_seed` lies far above the run seeds, whose
streams it never shares; the queries are never base rows. A draw is a few
calls of a `torch.Generator` on the device, the stream of the card's
generator and not numpy's (so not the rows of the reference bench's
`default_rng`)."""

from __future__ import annotations

import torch


def _rows(gen: torch.Generator, centers: torch.Tensor, n: int) -> torch.Tensor:
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen, device=centers.device)
    radius = torch.rand(n, 1, generator=gen, device=centers.device) * 1.4 + 0.3
    x = torch.randn(n, centers.shape[1], generator=gen, device=centers.device)
    return x.mul_(radius).add_(centers[assign])


def generate(gen: torch.Generator, device, *, n_base: int, n_queries: int, dim: int,
             store_seed: int, n_clusters: int = 1024):
    store = torch.Generator(device=device).manual_seed(store_seed)
    centers = torch.randn(n_clusters, dim, generator=store, device=device) * 4.0
    return _rows(store, centers, n_base), _rows(gen, centers, n_queries)
