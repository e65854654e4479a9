"""Vectorized key factorization for the columnar executor.

The reference's hash-based operators (HashAggregate executor.rs:1373,
GraceHashJoinExecutor executor.rs:1140, hash semi/anti physical.rs:43)
build per-row hash tables in native code. A Python per-row loop cannot
match that, so the columnar engine normalizes every "group rows by key"
problem to FACTORIZATION: map each key column to dense int64 codes
(np.unique), combine multi-column codes through a void view, and express
join/group/distinct/set-op membership as integer sorting and
searchsorted — all C-speed kernels.

Equality semantics match the expression layer's comparisons: numerics
compare by value (1 == 1.0 — columns are promoted with np.result_type),
NULLs are grouped as one key for GROUP BY/DISTINCT and excluded by the
caller for joins.
"""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql.expr import Col, _py


def _canonical_values(col: Col) -> np.ndarray:
    """Null slots are replaced with a harmless in-dtype value so np.unique
    never compares None with real values; callers key nulls separately."""
    v = col.values
    if not col.nulls.any():
        return v
    v = v.copy()
    if v.dtype == object:
        v[col.nulls] = ""
    elif v.ndim == 2:
        v[col.nulls] = 0
    else:
        v[col.nulls] = v.dtype.type(0) if v.dtype.kind != "b" else False
    return v


def _unique_codes(v: np.ndarray) -> np.ndarray:
    """Dense codes per distinct value (order of codes is arbitrary)."""
    if v.ndim == 2:
        w = np.ascontiguousarray(v)
        void = w.view([("", w.dtype)] * w.shape[1]).ravel()
        _, inv = np.unique(void, return_inverse=True)
        return inv.astype(np.int64)
    if v.dtype == object:
        try:
            _, inv = np.unique(v, return_inverse=True)
            return inv.astype(np.int64)
        except TypeError:
            # mixed python types in one object column: dict fallback
            # (value-based: 1 and 1.0 share a code, like the fast paths)
            m: dict = {}
            inv = np.empty(len(v), np.int64)
            for i, x in enumerate(v):
                inv[i] = m.setdefault(_norm_obj(x), len(m))
            return inv
    _, inv = np.unique(v, return_inverse=True)
    return inv.astype(np.int64)


def factorize_col(col: Col) -> np.ndarray:
    """codes[i] == codes[j]  iff  rows i,j have equal values OR are both
    NULL (NULL forms its own group, SQL GROUP BY / DISTINCT semantics)."""
    codes = _unique_codes(_canonical_values(col))
    if col.nulls.any():
        codes = codes.copy()
        codes[col.nulls] = codes.max(initial=-1) + 1
    return codes


def combine_codes(code_list: list[np.ndarray]) -> np.ndarray:
    """Row codes for a composite key from per-column codes."""
    if len(code_list) == 1:
        return code_list[0]
    m = np.ascontiguousarray(np.column_stack(code_list))
    void = m.view([("", np.int64)] * m.shape[1]).ravel()
    _, inv = np.unique(void, return_inverse=True)
    return inv.astype(np.int64)


def row_codes(cols: list[Col]) -> np.ndarray:
    """Dense row codes over a composite key (NULLs group together)."""
    if not cols:
        return np.zeros(0, np.int64)
    return combine_codes([factorize_col(c) for c in cols])


def renumber_first_occurrence(codes: np.ndarray):
    """Renumber arbitrary dense codes so group ids follow first-encounter
    order (matches hash-table insertion order, which differential tests
    and unordered-SELECT expectations lean on).

    Returns (group_of, first_idx): group_of[i] in [0, ngroups),
    first_idx[g] = row index of group g's first occurrence (ascending)."""
    n = len(codes)
    if n == 0:
        return codes, np.zeros(0, np.int64)
    ncodes = int(codes.max()) + 1
    first = np.full(ncodes, n, np.int64)
    np.minimum.at(first, codes, np.arange(n))
    present = first < n
    order = np.argsort(first[present], kind="stable")
    old_ids = np.flatnonzero(present)[order]
    rank = np.empty(ncodes, np.int64)
    rank[old_ids] = np.arange(len(old_ids))
    return rank[codes], first[old_ids]


def _common_pair(a: Col, b: Col):
    """Normalize two key columns (join sides) to one comparable array
    pair. Returns (va, vb) or None when only the object fallback works."""
    va, vb = a.values, b.values
    if va.ndim == 2 and vb.ndim == 2 and va.shape[1] == vb.shape[1]:
        t = np.result_type(va, vb)
        return va.astype(t, copy=False), vb.astype(t, copy=False)
    if va.ndim != 1 or vb.ndim != 1:
        return None
    if va.dtype != object and vb.dtype != object:
        t = np.result_type(va, vb)
        return va.astype(t, copy=False), vb.astype(t, copy=False)
    return None


def joint_codes(lcols: list[Col], rcols: list[Col], null_matches: bool = False):
    """Shared-coding factorization across two batches' key columns: rows
    l,r satisfy `lkey == rkey` iff lcodes[l] == rcodes[r] (>= 0).
    NULL keys get code -1 (never join-matched, SQL equi-join semantics)
    unless null_matches=True (set ops: NULLs equal each other).
    Value-based, not representation-based: INT 1 matches FLOAT 1.0
    regardless of column dtype (the partition-vs-probe hash mismatch fix).
    """
    nl = len(lcols[0]) if lcols else 0
    nr = len(rcols[0]) if rcols else 0
    per_l, per_r = [], []
    for a, b in zip(lcols, rcols):
        pair = _common_pair(a, b)
        if pair is not None:
            va, vb = pair
            cat = np.concatenate([_canonical_values(Col(va, a.nulls)),
                                  _canonical_values(Col(vb, b.nulls))])
            codes = _unique_codes(cat)
        else:
            # heterogeneous: compare as canonical python values
            cat = np.empty(nl + nr, object)
            cat[:nl] = [_norm_obj(x) for x in a.values]
            cat[nl:] = [_norm_obj(x) for x in b.values]
            cat[np.concatenate([a.nulls, b.nulls])] = ""
            codes = _unique_codes(cat)
        nulls_cat = np.concatenate([a.nulls, b.nulls])
        if nulls_cat.any():
            # a fresh code for NULL: the canonical placeholder must not
            # collide with a real ""/0 value
            codes = codes.copy()
            codes[nulls_cat] = codes.max(initial=-1) + 1
        per_l.append(codes[:nl])
        per_r.append(codes[nl:])
    if len(per_l) == 1:
        lc, rc = per_l[0].copy(), per_r[0].copy()
    else:
        # composite keys: combine through the concatenation so the
        # combined coding stays shared across sides
        joined = combine_codes(
            [np.concatenate([l_, r_]) for l_, r_ in zip(per_l, per_r)]
        )
        lc, rc = joined[:nl].copy(), joined[nl:].copy()
    if not null_matches:
        for a in lcols:
            lc[a.nulls] = -1
        for b in rcols:
            rc[b.nulls] = -1
    return lc, rc


def _norm_obj(x):
    v = _py(x)
    if isinstance(v, bool):
        return ("num", float(v))
    if isinstance(v, (int, float)):
        return ("num", float(v))
    if isinstance(v, (list, np.ndarray)):
        return ("seq", tuple(np.asarray(v).ravel().tolist()))
    return (type(v).__name__, v)


def match_pairs(lcodes: np.ndarray, rcodes: np.ndarray):
    """All (li, ri) index pairs with lcodes[li] == rcodes[ri] >= 0, via
    sort + searchsorted (the C-speed hash-join probe)."""
    order_r = np.argsort(rcodes, kind="stable")
    sr = rcodes[order_r]
    valid_l = lcodes >= 0
    lo = np.searchsorted(sr, lcodes, side="left")
    hi = np.searchsorted(sr, lcodes, side="right")
    counts = np.where(valid_l, hi - lo, 0)
    total = int(counts.sum())
    li = np.repeat(np.arange(len(lcodes)), counts)
    if total == 0:
        return li, np.zeros(0, np.int64)
    # flatten the per-row [lo, hi) ranges into sr positions
    # right-side -1 codes sort first and are never inside a [lo, hi)
    # range for a valid left code, so no extra filtering is needed
    starts = np.repeat(lo, counts)
    offs = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    ri = order_r[starts + offs]
    return li, ri
