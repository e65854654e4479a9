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


@dataclass
class Limits:
    recall_floor: float
    dist_rel_err: float
    bad_rows: int = 0


def truth_of(base: torch.Tensor, query_sets: list, sets, k: int) -> dict:
    """The reference's (dists, ids) for each query set in `sets`."""
    return {j: exact_knn(base, query_sets[j], k) for j in sorted(sets)}


def judge(answers: Answers, base: torch.Tensor, query_sets: list, truth: dict, k: int) -> dict:
    """The compared numbers of `answers` against the reference's `truth`
    ({set: (dists, ids)}): recall_at_10, dist_rel_err, bad_rows."""
    n = base.shape[0]
    hits = total = bad = 0
    worst = 0.0
    for j, kept in answers.by_set.items():
        q, t = query_sets[j], truth[j][1]
        b = q.shape[0]
        for ids, dists, count in kept:
            total += count * b * k
            if ids.shape != (b, k) or dists.shape != (b, k):
                bad += count * b
                continue
            i = torch.as_tensor(ids, device=base.device).long()
            d = torch.as_tensor(dists, device=base.device).float()
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
    return {name: {"value": v, "limit": lim, "holds": ok, "rule": rule}
            for name, (v, lim, ok, rule) in checks.items()}
