"""Datasets (numpy only), copies of the reference's utils/datasets.py and
bench pools: the TexMex loaders (`load_fvecs`, `load_ivecs`,
`sift_dataset`), the bench's `make_pool`, `hard_pool`, `emb_pool` and
`pix_pool`, and `recall_of`. Each gives the reference's arrays from the
same generator state or files."""

from __future__ import annotations

import os

import numpy as np


def load_fvecs(path: str, max_n: int | None = None) -> np.ndarray:
    """TexMex .fvecs: [int32 d][d x float32] per row."""
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    row = d + 1
    n = len(raw) // row
    if max_n is not None:
        n = min(n, max_n)
    return raw[: n * row].reshape(n, row)[:, 1:].view(np.float32).copy()


def load_ivecs(path: str, max_n: int | None = None) -> np.ndarray:
    """TexMex .ivecs: [int32 d][d x int32] per row."""
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    row = d + 1
    n = len(raw) // row
    if max_n is not None:
        n = min(n, max_n)
    return raw[: n * row].reshape(n, row)[:, 1:].copy()


def sift_dataset(max_n: int | None = None):
    """(base, queries, ground truth or None) from $TURDB_SIFT_PATH, a
    directory of the TexMex layout (*base.fvecs, *query.fvecs,
    *groundtruth.ivecs); None when the variable or the files are missing.
    The ground truth is read only for the whole base (max_n None)."""
    root = os.environ.get("TURDB_SIFT_PATH")
    if not root or not os.path.isdir(root):
        return None
    names = sorted(os.listdir(root))

    def find(suffix):
        return next((os.path.join(root, n) for n in names if n.endswith(suffix)), None)

    base_p, query_p = find("base.fvecs"), find("query.fvecs")
    if base_p is None or query_p is None:
        return None
    gt_p = find("groundtruth.ivecs")
    truth = load_ivecs(gt_p) if gt_p is not None and max_n is None else None
    return load_fvecs(base_p, max_n), load_fvecs(query_p), truth


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


def pix_pool(n=1_000_000, n_queries=16384, path=None):
    """Natural-image patch vectors (the reference bench's external-data
    row): from the grayscale image at `path` (default $TURDB_PIX_PATH),
    dims 0-63 an 8x8 patch and dims 64-127 the 8x8 patch of the
    2x-downscaled image at the same centre, each mean-centred; patches
    whose native-scale std is below 1.0 gray level are dropped. Base
    patches from the even-even stride-2 grid, queries from the odd-odd
    stride-4 grid, each decimated evenly to at most n / n_queries. No RNG.
    Returns (base, queries), or None without PIL or the image; raises
    ValueError when fewer than 1024 patches are usable."""
    if path is None:
        path = os.environ.get("TURDB_PIX_PATH")
    if path is None or not os.path.exists(path):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    g = np.asarray(Image.open(path).convert("L"), np.float32)
    h, w = g.shape
    # the 2x-downscaled copy, upsampled back by pixel repeat so that one
    # centre indexes both scales
    g2 = g[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
    g2 = g2.mean(axis=(1, 3)).repeat(2, 0).repeat(2, 1)

    def extract(offy, offx, stride, m):
        win = np.lib.stride_tricks.sliding_window_view(g, (8, 8))
        win2 = np.lib.stride_tricks.sliding_window_view(g2[:h, :w], (8, 8))
        ys = np.arange(offy, win.shape[0], stride)
        xs = np.arange(offx, win.shape[1], stride)
        p1 = win[ys][:, xs].reshape(-1, 64)
        p2 = win2[ys][:, xs].reshape(-1, 64)
        p1 = p1 - p1.mean(axis=1, keepdims=True)
        keep = p1.std(axis=1) >= 1.0
        p2 = p2 - p2.mean(axis=1, keepdims=True)
        x = np.concatenate([p1[keep], p2[keep]], axis=1).astype(np.float32)
        if len(x) < 1024:
            raise ValueError(f"pix_pool: only {len(x)} usable patches")
        sel = np.linspace(0, len(x) - 1, min(m, len(x))).astype(np.int64)
        return np.ascontiguousarray(x[sel])

    return extract(0, 0, 2, n), extract(1, 1, 4, n_queries)


def emb_pool(rng, n, n_queries=16384, dim=384, n_topics=64):
    """Unit-norm embedding-like vectors (the reference bench's `emb`
    rows): a sparse mixture of 3 of `n_topics` random topics (Dirichlet
    0.7 weights) plus 0.35 noise, scaled by a lognormal(0, 0.4) norm,
    then normalized; cosine-ready. Returns (base [n, dim], held-out
    queries [n_queries, dim]) f32, the reference's from the same `rng`."""
    topics = rng.standard_normal((n_topics, dim)).astype(np.float32)

    def draw(m):
        idx = rng.integers(0, n_topics, size=(m, 3))
        wts = rng.dirichlet(np.ones(3) * 0.7, size=m).astype(np.float32)
        x = np.einsum("mk,mkd->md", wts, topics[idx])
        x += 0.35 * rng.standard_normal((m, dim)).astype(np.float32)
        x *= rng.lognormal(0.0, 0.4, size=(m, 1)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
        return x.astype(np.float32)

    return draw(n), draw(n_queries)


def recall_of(ids, truth) -> float:
    """Mean fraction of each truth row found among the returned ids."""
    return float(np.mean([len(set(p[p >= 0]) & set(t)) / len(t)
                          for p, t in zip(ids, truth)]))
