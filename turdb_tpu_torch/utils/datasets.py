"""Synthetic datasets (numpy only)."""

from __future__ import annotations

import numpy as np


def make_pool(rng, n, dim, n_clusters=1024):
    """Clustered synthetic embeddings (SIFT-like structure, not uniform),
    the bench's headline pool: the same `rng` state gives the same rows as
    `make_pool` in the reference bench. Base and queries split from ONE
    pool so both share the distribution."""
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    radius = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    x = centers[assign] + radius * rng.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32)


def recall_of(ids, truth) -> float:
    """Mean fraction of each truth row found among the returned ids."""
    return float(np.mean([len(set(p[p >= 0]) & set(t)) / len(t)
                          for p, t in zip(ids, truth)]))
