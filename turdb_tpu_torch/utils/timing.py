"""Host phase counters, and device timing with CUDA events.

The host half is the reference's (turdb_tpu/utils/timing.py): a dict of
nanosecond accumulators per phase with a context manager (switched off and
on by `enable`), read by PRAGMA timing_stats (the database's parse and
execute phases). `profile_trace` is the device-side counterpart: a
`torch.profiler` trace of a block, exported for Perfetto or
chrome://tracing.

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


def enable(on: bool = True):
    """Switch the phase counters of `timed` on or off."""
    global _ENABLED
    _ENABLED = on


def reset():
    TIMERS.clear()


@contextlib.contextmanager
def timed(name: str):
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


def device_profile(fn, *, top: int = 8) -> dict:
    """Trace one call of `fn()` with `torch.profiler` and sum the device
    activity: `busy_ms` (union of device spans), `window_ms` (first device
    span start to last end), `idle_share` = 1 − busy / window, and the
    `top` kernels by device time. `traced: False` when the profiler saw no
    device activity (then nothing here is a device number)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_profile needs a CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
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
    window = max(e for _, e, _ in spans) - spans[0][0]
    kernels = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "traced": True,
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "top": [{"name": n[:80], "ms": t / 1e3, "calls": c} for n, (t, c) in kernels],
    }


class NoDeviceSpans(RuntimeError):
    """A `profile_trace` whose trace kept no device span."""


@contextlib.contextmanager
def profile_trace(logdir):
    """Trace the block with `torch.profiler` (host and CUDA activity) and
    export it as a Chrome trace under `logdir`. Yields a dict that holds,
    after the block, the trace's "path" and its "device_spans". A trace
    without a device span (the profiler on the H100 now and then keeps
    none of a trace) raises NoDeviceSpans instead of being written."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_trace needs a CUDA device")
    info: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield info
        torch.cuda.synchronize()
    spans = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise NoDeviceSpans("profile_trace: the trace holds no device span; nothing was written")
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    info.update(path=str(path), device_spans=spans)
