"""The program's own trace, as the readers of its spans and counters see it.

The port opens host ranges named `turdb.<layer>` inside its search entries
(`turdb_tpu_torch/utils/timing.py` `span`) while the profiler runs, so a
traced run's `Trace.host` holds them, on the device trace's clock. Here:
exact interval arithmetic (unions, intersections, differences, lengths in
µs) of those spans against the device's idle time (the window less the
union of the device's spans), the device spans that ran inside a host
span, and the program's work counters (`timing.counters()`), which it
counts only while the profiler runs. A program that exports none (an older
port) gives no spans and empty counters, so its readers return None.
"""

from __future__ import annotations

import re

STAGING = ("turdb.stage_in", "turdb.stage_out")
ENTRY = re.compile(r"^turdb\.[a-z0-9_]+\.search")   # turdb.ivf.search, turdb.hnsw.search_serve


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    """`a` less `b`, both sorted disjoint interval lists."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def length(a: list) -> float:
    return sum(e - s for s, e in a)


def idle(trace) -> list:
    """The parts of the window in which no device activity ran."""
    lo, hi = trace.window
    return subtract([[lo, hi]], trace.busy_intervals())


def host_spans(trace, match) -> list:
    """The union of the host spans whose name `match(name)` accepts,
    clipped to the window."""
    lo, hi = trace.window
    return union((max(s, lo), min(e, hi)) for s, e, name in trace.host if match(name))


def is_staging(name: str) -> bool:
    return name in STAGING


def is_entry(name: str) -> bool:
    return ENTRY.match(name) is not None


def idle_pct(trace, spans: list) -> float:
    """100 × the idle time inside `spans` over the window."""
    lo, hi = trace.window
    return 100.0 * length(intersect(idle(trace), spans)) / (hi - lo)


def device_within(trace, match, patterns) -> list:
    """For each host span whose name `match(name)` accepts, in order, the
    (start, end) of the device spans whose name holds one of `patterns`
    (case apart) and that start inside it, sorted, clipped to the window.
    A search entry ends in a synchronous copy of its results, so every
    device span of a call starts and ends inside the call's entry span."""
    lo, hi = trace.window
    pats = [p.lower() for p in patterns]
    dev = sorted((s, e) for s, e, name in trace.device
                 if min(e, hi) > max(s, lo) and any(p in name.lower() for p in pats))
    return [[(max(s, lo), min(e, hi)) for s, e in dev if hs <= s < he]
            for hs, he, name in sorted(trace.host) if match(name)]


def program_counters() -> dict:
    """The program's work counters since its last reset, or {} where the
    program exports none."""
    try:
        from turdb_tpu_torch.utils import timing

        return timing.counters()
    except (ImportError, AttributeError):
        return {}


def counted(names: list) -> dict | None:
    """The counters `names` (each as a number), or None where the program
    counted any of them never."""
    counts = program_counters()
    if any(n not in counts for n in names):
        return None
    return {n: counts[n] for n in names}
