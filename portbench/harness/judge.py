"""Whether the timed path's answers are correct.

The answers of the checked calls (the first pass over the query sets and a
sample of the later calls drawn from the seed, `loop.checked_calls`) are
kept (`Answers`: once per distinct value, with a count) and, once the
window has closed and the program's state is freed, held to the plain
reference (`portbench/reference/knn.py`):

- `recall_at_10`: the share of each query's exact k nearest rows found
  among its k answers, over every checked answer; its floor is the
  traffic mix's `recall_floor`, the operating point the mix fixes.
- `dist_rel_err`: the widest gap |returned − exact| / exact between a
  returned distance and Σ(q − x)² of the row it names, in float64; its
  limit is the configuration's `checks.dist_rel_err`, set between the
  program's readings and the control's (PERF.md).
- `bad_rows`: answers that are no k distinct in-range ids with finite
  distances in ascending order; exact, limit 0.

In an ingest run (`harness/ingest.py`) the store grows under the calls:
each answer is keyed by (query set, rows acknowledged before its call),
judged against the exact k-NN of that prefix of the base, and each id it
returns is taken to the base row it was acknowledged for (`Acked`): an id
the index never returned, or returned only after the call, is out of
range. Such a run adds

- `readback`: the share of a sample of the acknowledged stream rows
  whose own id is among the k answers to their own vector; its floor is
  the mix's `readback_floor`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.knn import exact_knn, row_dists


@dataclass
class Answers:
    """The window's answers: per query set, [ids, dists, count] for each
    distinct answer, compared whole with those kept before."""

    by_set: dict = field(default_factory=dict)
    calls: int = 0

    def add(self, j: int, ids: np.ndarray, dists: np.ndarray) -> None:
        self.calls += 1
        kept = self.by_set.setdefault(j, [])
        for v in kept:
            if np.array_equal(v[0], ids) and np.array_equal(v[1], dists):
                v[2] += 1
                return
        kept.append([ids, dists, 1])


class Acked:
    """The ids each `add` returned, in order: the build's, then each
    wave's. Rows are acknowledged in the base's order, so the r-th row
    acknowledged is base row r."""

    def __init__(self):
        self._ids = []
        self.n = 0           # rows acknowledged so far
        self._table = None   # (sorted ids, the row of each), by device

    def add(self, ids, rows: int) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) != rows:
            raise ValueError(f"an add of {rows} rows acknowledged {len(ids)} ids")
        self._ids.append(ids)
        self.n += rows
        self._table = None

    def ids_of(self, rows: np.ndarray) -> np.ndarray:
        """The id acknowledged for each of the base's `rows`."""
        return np.concatenate(self._ids)[rows]

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The base row each id was acknowledged for; -1 where the index
        never returned the id, or returned it for two rows."""
        if self._table is None or self._table[0].device != ids.device:
            every = np.concatenate(self._ids)
            order = np.argsort(every, kind="stable")
            srt = every[order]
            same = srt[1:] == srt[:-1]
            twice = np.zeros(len(srt), bool)
            twice[1:] |= same
            twice[:-1] |= same
            self._table = (torch.as_tensor(srt, device=ids.device),
                           torch.as_tensor(np.where(twice, -1, order), device=ids.device))
        srt, row = self._table
        pos = torch.searchsorted(srt, ids).clamp(max=len(srt) - 1)
        return torch.where(srt[pos] == ids, row[pos], -1)


@dataclass
class Limits:
    recall_floor: float
    dist_rel_err: float
    bad_rows: int = 0
    readback_floor: float | None = None   # ingest runs


def truth_of(base: torch.Tensor, query_sets: list, sets, k: int) -> dict:
    """The reference's (dists, ids) for each query set in `sets`."""
    return {j: exact_knn(base, query_sets[j], k) for j in sorted(sets)}


def judge(answers: Answers, base: torch.Tensor, query_sets: list, truth: dict, k: int,
          acked: Acked | None = None) -> dict:
    """The compared numbers of `answers` against the reference's `truth`
    ({key: (dists, ids)}): recall_at_10, dist_rel_err, bad_rows. Keys are
    query sets, and ids base rows; with `acked` (an ingest run) keys are
    (query set, rows acknowledged before the call) and ids go through
    `acked.rows`."""
    hits = total = bad = 0
    worst = 0.0
    for key, kept in answers.by_set.items():
        j, n = key if acked is not None else (key, base.shape[0])
        q, t = query_sets[j], truth[key][1]
        b = q.shape[0]
        for ids, dists, count in kept:
            total += count * b * k
            if ids.shape != (b, k) or dists.shape != (b, k):
                bad += count * b
                continue
            i = torch.as_tensor(ids, device=base.device).long()
            d = torch.as_tensor(dists, device=base.device).float()
            if acked is not None:
                i = acked.rows(i)
            in_range = (i >= 0) & (i < n)
            fin = torch.isfinite(d)
            ascending = (d[:, 1:] >= d[:, :-1]).all(1)
            srt = i.sort(1).values
            distinct = ~(srt[:, 1:] == srt[:, :-1]).any(1)
            good = in_range.all(1) & fin.all(1) & ascending & distinct
            bad += count * int((~good).sum())
            hits += count * int((t[:, :, None] == i[:, None, :]).any(2).sum())
            ok = in_range & fin
            if bool(ok.any()):
                exact = row_dists(base, q, i.clamp(0, n - 1))
                gap = (d.double() - exact).abs() / exact.clamp_min(1e-30)
                worst = max(worst, float(gap[ok].max()))
    return {"recall_at_10": hits / total if total else 0.0, "dist_rel_err": worst,
            "bad_rows": bad}


def verdict(numbers: dict, limits: Limits) -> dict:
    """Each compared number beside its limit, and whether it holds."""
    checks = {
        "recall_at_10": (numbers["recall_at_10"], limits.recall_floor,
                         numbers["recall_at_10"] >= limits.recall_floor, ">="),
        "dist_rel_err": (numbers["dist_rel_err"], limits.dist_rel_err,
                         numbers["dist_rel_err"] <= limits.dist_rel_err, "<="),
        "bad_rows": (numbers["bad_rows"], limits.bad_rows,
                     numbers["bad_rows"] <= limits.bad_rows, "<="),
    }
    if limits.readback_floor is not None:
        checks["readback"] = (numbers["readback"], limits.readback_floor,
                              numbers["readback"] >= limits.readback_floor, ">=")
    return {name: {"value": v, "limit": lim, "holds": ok, "rule": rule}
            for name, (v, lim, ok, rule) in checks.items()}
