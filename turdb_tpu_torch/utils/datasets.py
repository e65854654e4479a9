"""Synthetic datasets (numpy only): the bench's `make_pool` and `hard_pool`."""

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


def hard_pool(rng, n, dim, n_queries=16384, n_clusters=512):
    """Imbalanced anisotropic mixture with held-out queries, the bench's
    `ivf_hard` pool: the same `rng` state gives the same arrays as
    `hard_pool` in the reference's utils/datasets.py.

    Cluster sizes follow a Zipf(1.3) law (the largest ~100x the median);
    each cluster has its own random rotation and log-uniform axis scales
    in [0.25, 2.5]. Queries are fresh draws from the same mixture, never
    base rows. Returns (base [n, dim], queries [n_queries, dim]) f32."""
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    w = 1.0 / np.arange(1, n_clusters + 1) ** 1.3
    w /= w.sum()
    rots, scales = [], []
    for _ in range(n_clusters):
        q, _ = np.linalg.qr(rng.standard_normal((dim, dim)).astype(np.float32))
        rots.append(q.astype(np.float32))
        scales.append(np.exp(rng.uniform(np.log(0.25), np.log(2.5), dim)).astype(np.float32))

    def draw(m):
        assign = rng.choice(n_clusters, size=m, p=w)
        out = np.empty((m, dim), np.float32)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        # one run per cluster present, in cluster order: the noise is drawn
        # run by run, as the reference draws it
        bounds = np.flatnonzero(np.diff(sa)) + 1
        for start, end in zip(np.r_[0, bounds], np.r_[bounds, m]):
            c = sa[start]
            z = rng.standard_normal((end - start, dim)).astype(np.float32)
            out[order[start:end]] = centers[c] + (z * scales[c]) @ rots[c]
        return out

    return draw(n), draw(n_queries)


def recall_of(ids, truth) -> float:
    """Mean fraction of each truth row found among the returned ids."""
    return float(np.mean([len(set(p[p >= 0]) & set(t)) / len(t)
                          for p, t in zip(ids, truth)]))
