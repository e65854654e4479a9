"""Host phase counters, spans and work counters on the profiler's clock,
and device timing with CUDA events.

The host half is the reference's (turdb_tpu/utils/timing.py): a dict of
nanosecond accumulators per phase with a context manager (switched off and
on by `enable`), read by PRAGMA timing_stats (the database's parse and
execute phases). `profile_trace` is the device-side counterpart: a
`torch.profiler` trace of a block, exported for Perfetto or
chrome://tracing.

Spans and counters (`span`, `count`) trace the search entries from the
inside. They are on while a `torch.profiler` session runs, and do nothing
but that one check otherwise. A span is a host range of the profiler's
own (a plain CPU op, so no annotation reaches the device's timeline): a
reader of the trace finds the device spans that ran inside it. A counter
keeps the sums it is handed and resolves them only when read
(`counters`), so counting adds no synchronize to a traced call.
`counters()` gives the totals since the last `reset()`.

PyTorch returns before the card finishes, so a host clock without a
synchronise measures the enqueue; events recorded on the stream measure
the device. There is no CPU fallback: timing a CPU run under a device
metric's name would be wrong.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch

TIMERS: dict[str, dict] = defaultdict(lambda: {"ns": 0, "count": 0})
_ENABLED = True

tracing = torch._C._autograd._profiler_enabled   # is a torch.profiler session running?
# the profiler's host-only range (`record_function` also puts an annotation
# on the device's timeline)
_Range = torch._C._profiler._RecordFunctionFast

_COUNTS: dict[str, list] = defaultdict(list)   # name -> ints, tensors, callables


def enable(on: bool = True):
    """Switch the phase counters of `timed` on or off."""
    global _ENABLED
    _ENABLED = on


def reset():
    """Clear the phase counters and the work counters."""
    TIMERS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def timed(name: str):
    """Add the block's host ns to TIMERS[name] (while `enable`d); while
    tracing, the block is also a span of that name."""
    with span(name):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t = TIMERS[name]
            t["ns"] += time.perf_counter_ns() - t0
            t["count"] += 1


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host range named `name` on the profiler's clock while tracing,
    else nothing."""
    return _Range(name) if tracing() else _NO_SPAN


def count(name: str, value) -> None:
    """Add `value` to the counter `name` while tracing (else nothing): an
    int, a tensor or a callable of no arguments that gives one of those
    when read. A tensor of more than one element is summed on its device
    now (one reduction, no synchronize) and only its sum is kept: kept
    whole, a traced run's per-query tensors made the caching allocator
    call cudaMalloc inside the traced calls."""
    if tracing():
        if isinstance(value, torch.Tensor) and value.numel() > 1:
            value = value.sum(dtype=torch.int64)
        _COUNTS[name].append(value)


def counters() -> dict[str, int]:
    """Each counter's total since the last `reset()`, resolved with one
    synchronize a device and kept as the total from then on."""
    totals, parts = {}, defaultdict(list)   # device -> [(name, tensor sum)]
    for name, values in _COUNTS.items():
        totals[name] = 0
        for v in values:
            v = v() if callable(v) else v
            if isinstance(v, torch.Tensor):
                parts[v.device].append((name, v.sum(dtype=torch.int64)))
            else:
                totals[name] += int(v)
    for pairs in parts.values():
        for (name, _), v in zip(pairs, torch.stack([t for _, t in pairs]).tolist()):
            totals[name] += v
    for name, total in totals.items():
        _COUNTS[name] = [total]
    return totals


def timing_stats() -> list[tuple]:
    """(phase, total_ms, count, avg_us) rows, sorted by total time."""
    rows = []
    for name, t in TIMERS.items():
        avg_us = (t["ns"] / t["count"] / 1e3) if t["count"] else 0.0
        rows.append((name, round(t["ns"] / 1e6, 3), t["count"], round(avg_us, 2)))
    return sorted(rows, key=lambda r: -r[1])


def cuda_times_ms(fn, *, reps: int = 5, warmup: int = 1) -> list[float]:
    """Milliseconds of each of `reps` timed calls of `fn()`, after
    `warmup` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_times_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def cuda_median_ms(fn, **kw) -> float:
    """Median of `cuda_times_ms`."""
    return statistics.median(cuda_times_ms(fn, **kw))


PROFILE_WINDOW = "turdb.device_profile"


def device_profile(fn, *, top: int = 8) -> dict:
    """Trace one call of `fn()` with `torch.profiler` and sum the device
    activity over the host's window of the call: a range around `fn()` and
    the synchronize after it, so that the host's gaps before, between and
    after the device's spans count as idle (`device_summary`). `traced:
    False` when the profiler kept no device activity or no such range
    (then nothing here is a device number)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_profile needs a CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _Range(PROFILE_WINDOW):
            fn()
            torch.cuda.synchronize()
    return device_summary(prof.events(), top=top)


def device_summary(events, *, top: int = 8) -> dict:
    """From a profiler's events: `window_ms`, the host range `PROFILE_WINDOW`;
    `busy_ms`, the union of the device's spans (annotations left out)
    clipped to it; `idle_share` = 1 − busy / window; and the `top` device
    operations by their time in the window."""
    lo = hi = None
    spans = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if str(e.device_type).split(".")[-1] != "CPU":
            if not getattr(e, "is_user_annotation", False):
                spans.append((s, t, e.name))
        elif e.name == PROFILE_WINDOW:
            lo, hi = s, t
    if lo is None:
        return {"traced": False}
    spans = sorted((max(s, lo), min(t, hi), n) for s, t, n in spans if min(t, hi) > max(s, lo))
    if not spans:
        return {"traced": False}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    per: dict[str, list] = {}
    for s, e, name in spans:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        acc = per.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    busy += cur_e - cur_s
    window_us = hi - lo
    kernels = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "traced": True,
        "busy_ms": busy / 1e3,
        "window_ms": window_us / 1e3,
        "idle_share": 1.0 - busy / window_us if window_us > 0 else 0.0,
        "top": [{"name": n[:80], "ms": t / 1e3, "calls": c} for n, (t, c) in kernels],
    }


class NoDeviceSpans(RuntimeError):
    """A `profile_trace` whose trace kept no device span."""


@contextlib.contextmanager
def profile_trace(logdir):
    """Trace the block with `torch.profiler` (host and CUDA activity) and
    export it as a Chrome trace under `logdir`. Yields a dict that holds,
    after the block, the trace's "path" and its "device_spans", and the
    block's "counters" (`counters`). A trace without a device span (the
    profiler on the H100 now and then keeps none of a trace) raises
    NoDeviceSpans instead of being written."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_trace needs a CUDA device")
    info: dict = {}
    torch.cuda.synchronize()
    counts0 = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield info
        torch.cuda.synchronize()
    info["counters"] = {k: v - counts0.get(k, 0) for k, v in counters().items()
                        if v != counts0.get(k, 0)}
    spans = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise NoDeviceSpans("profile_trace: the trace holds no device span; nothing was written")
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    info.update(path=str(path), device_spans=spans)
