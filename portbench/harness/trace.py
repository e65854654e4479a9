"""The traced run: the same calls as the window, under `torch.profiler`.

`traced_loop` runs `TRACE_CALLS` calls inside a `portbench.window`
annotation (each call inside `portbench.call`, an ingest call's wave inside
`portbench.insert` within it, the client's bookkeeping inside
`portbench.client`) and keeps the trace's device spans (kernels, copies,
sets) and host spans. The idle share is taken over the host's
window, from the first call's start to the last call's end, not from the
device's first span to its last. A trace that keeps no device span in the
window (the profiler on the H100 now and then keeps none) is taken again,
up to `TRACE_TRIES` times, and then fails: no idle share or kernel time is ever
reported that the trace did not see.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass

WINDOW, CALL, CLIENT = "portbench.window", "portbench.call", "portbench.client"
INSERT = "portbench.insert"   # an ingest call's wave: its idle is named so, whatever runs in it
TRACE_CALLS = 100      # calls in a traced window
TRACE_TRIES = 3        # traces taken before a run without device spans fails


class NoDeviceSpans(RuntimeError):
    """A traced window in which the profiler kept no device span."""


@dataclass
class Trace:
    window: tuple        # (start, end) in µs on the trace's clock
    device: list         # (start, end, name) µs, device activity overlapping the window
    host: list           # (start, end, name) µs, host ops and annotations
    calls: int
    queries: int
    sets: list           # the query set of each traced call

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran (the
        union of the spans, clipped to the window)."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list:
        lo, hi = self.window
        out = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernel_ms(self, patterns) -> float:
        """Device ms of the spans whose name holds one of `patterns`
        (case apart), clipped to the window."""
        pats = [p.lower() for p in patterns]
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for s, e, name in self.device
                   if min(e, hi) > max(s, lo) and any(p in name.lower() for p in pats)) / 1e3

    def ms_per_kq(self, patterns) -> float | None:
        """`kernel_ms(patterns)` per 1,000 traced queries, or None where no
        such span was kept."""
        ms = self.kernel_ms(patterns)
        return ms / (self.queries / 1e3) if ms > 0 else None

    def idle_gaps(self, samples: int = 8) -> list:
        """(seconds, what the host was doing) for each part of the window
        in which no device activity ran: each gap is cut into `samples`
        equal parts, each named by the innermost host span over its
        midpoint (`host: outside any traced op` where none is), or
        `portbench.insert` where that span is among them."""
        lo, hi = self.window
        edges, prev = [], lo
        for s, e in self.busy_intervals():
            if s > prev:
                edges.append((prev, s))
            prev = e
        if hi > prev:
            edges.append((prev, hi))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        longest = max((h[1] - h[0] for h in host), default=0.0)
        out = []
        for s, e in edges:
            part = (e - s) / samples
            for n in range(samples):
                mid = s + (n + 0.5) * part
                cover, i = [], bisect_right(starts, mid) - 1
                while i >= 0 and host[i][0] >= mid - longest:
                    if host[i][1] >= mid:
                        cover.append(host[i])
                    i -= 1
                name = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                        else "host: outside any traced op")
                if any(h[2] == INSERT for h in cover):
                    name = INSERT
                out.append((part / 1e6, name))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, [[name, seconds], ...] each."""
        lo, hi = self.window
        ops = defaultdict(float)
        for s, e, name in self.device:
            if min(e, hi) > max(s, lo):
                ops[name[:160]] += (min(e, hi) - max(s, lo)) / 1e6
        gaps = defaultdict(float)
        for sec, name in self.idle_gaps():
            gaps[name[:160]] += sec
        def largest(d):
            return sorted(([n, v] for n, v in d.items()), key=lambda r: -r[1])[:top]

        return {"device_ops": largest(ops), "idle_gaps": largest(gaps)}


def from_events(events, calls: int, queries: int, sets: list) -> Trace:
    """A Trace from the profiler's events (`prof.events()`): device spans
    are those on the device that are no user annotation; the window is the
    `portbench.window` annotation on the host."""
    device, host, window = [], [], None
    for ev in events:
        s, e, name = ev.time_range.start, ev.time_range.end, ev.name
        on_device = str(ev.device_type).split(".")[-1] != "CPU"
        if on_device:
            if not getattr(ev, "is_user_annotation", False) and not name.startswith("portbench."):
                device.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        else:
            host.append((s, e, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    lo, hi = window
    device = [d for d in device if d[1] > lo and d[0] < hi]
    return Trace(window=window, device=device, host=host, calls=calls, queries=queries,
                 sets=sets)


def traced_loop(call, query_sets: list, answers, kept, key=None) -> Trace:
    """`TRACE_CALLS` calls of the entry under the profiler, cycling through
    the query sets from set 0; the answers of the calls `kept` names go
    into `answers` under `key(set)` (default the set), as in the window.
    An ingest run's `call` opens `INSERT` around its wave itself, so each
    try inserts `TRACE_CALLS` more waves."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sets = [c % len(query_sets) for c in range(TRACE_CALLS)]
    queries = sum(len(query_sets[j]) for j in sets)
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for c, j in enumerate(sets):
                    with record_function(CALL):
                        dists, ids = call(query_sets[j])
                    if kept[c]:
                        with record_function(CLIENT):
                            answers.add(j if key is None else key(j), ids, dists)
            torch.cuda.synchronize()
        trace = from_events(prof.events(), TRACE_CALLS, queries, sets)
        if trace.device:
            return trace
    raise NoDeviceSpans(f"{TRACE_TRIES} traces of {TRACE_CALLS} calls kept no device span in the window")
