"""One run of one cell, in order: the data from the seed, the index through
the port's entry points, the warm-up, the measured window (or, traced,
`trace.TRACE_CALLS` calls under the profiler), then the check of the
checked calls' answers against the plain reference once the program's
state is freed. The mix's `loop` picks how calls are made and judged:
`closed` (`loop.Closed`, queries alone) or `ingest` (`ingest.Ingest`, a
wave inserted before each query and the acknowledged rows read back)."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import torch

from portbench.harness import ingest, judge, loop, spec, systems, trace
from portbench.harness.loop import WARMUP_CALLS
from portbench.reference.knn import require_metric

LOOPS = {"closed": loop.Closed, "ingest": ingest.Ingest}   # a mix's `loop`; `spec.find_cell` checks it


@dataclass
class RunContext:
    """What a metric's reader may look at: the cell, the benchmark's own
    rows and query sets (never the program's state), the set-up's build
    seconds, the window or the trace."""

    cell: spec.Cell
    base: object                # numpy [n, d]
    build_s: float
    query_sets: list            # numpy [batch, d] each
    window: loop.Window | None
    trace: trace.Trace | None


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read(metrics: list, ctx: RunContext, builtin: dict) -> dict:
    out = {}
    for m in metrics:
        value = builtin[m["name"]] if m["name"] in builtin else spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             wrap_call=None, wrap_insert=None) -> tuple[dict, dict]:
    """The result line's fields for one run, and `judge.verdict`'s checks.
    `t0` is the process's start on `time.perf_counter`'s clock;
    `wrap_call` and `wrap_insert` (tests) wrap the entry and an ingest
    mix's insert."""
    device = torch.device(device)
    _log(f"{cell.name} seed {seed}: started {time.perf_counter() - t0:.3f} s after the process")
    cfg, mix = cell.config, cell.traffic
    kind = LOOPS[mix.get("loop", "closed")]
    require_metric(cfg["metric"])
    k, batch = mix["k"], mix["batch"]
    data = cfg["data"]
    gen = torch.Generator(device=device).manual_seed(seed)
    base, queries = spec.generator(data["generator"])(gen, device, **data["params"])
    query_sets = [queries[s:s + batch].cpu().numpy()
                  for s in range(0, queries.shape[0] - batch + 1, batch)]
    base_np = base.cpu().numpy()
    feed = kind(mix, base_np)
    del base, queries, gen
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    _sync(device)
    t = time.perf_counter()
    _log(f"data drawn and staged {t - t0:.3f} s after the process")
    index, ids = systems.build_index(cfg, mix, feed.bulk, device)
    _sync(device)
    build_s = time.perf_counter() - t
    _log(f"index built in {build_s:.3f} s")
    call = systems.entry(index, mix)
    if wrap_call is not None:
        call = wrap_call(call)
    feed.built(index, ids, wrap_insert)
    warm = feed.steps(call)
    for w in range(WARMUP_CALLS):
        warm(query_sets[w % len(query_sets)])
    _sync(device)
    setup_s = time.perf_counter() - t0
    _log(f"warmed up: set-up {setup_s:.3f} s")

    answers = judge.Answers()
    kept = loop.checked_calls(seed, len(query_sets))
    window = tr = None
    if traced:
        tr = feed.traced(call, query_sets, answers, kept)
        sent = tr.queries
    else:
        window = feed.window(call, query_sets, seconds, answers, kept)
        sent = window.queries
        _log(f"window {window.seconds:.3f} s, {window.calls} calls, the client's bookkeeping "
             f"{window.client_s:.3f} s")
    _log(f"{sum(len(v) for v in answers.by_set.values())} distinct answers of the "
         f"{answers.calls} calls checked")
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    ctx = RunContext(cell=cell, base=base_np, build_s=build_s, query_sets=query_sets,
                     window=window, trace=tr)
    per_layer = _read(cell.per_layer, ctx, {}) if traced else {}
    readback = feed.readback(call, seed)

    # the program's state goes before the reference runs
    index = call = warm = feed.insert = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    base_t = torch.as_tensor(base_np, device=device)
    sets_t = [torch.as_tensor(q, device=device) for q in query_sets]
    truth = feed.truth(base_t, sets_t, answers.by_set.keys(), k)
    numbers = judge.judge(answers, base_t, sets_t, truth, k, feed.acked)
    _sync(device)
    _log(f"reference and judge {time.perf_counter() - t:.3f} s over {answers.calls} calls")
    if readback is not None:
        numbers["readback"] = readback
    checks = judge.verdict(numbers, judge.Limits(
        mix["recall_floor"], cfg["checks"]["dist_rel_err"],
        readback_floor=None if readback is None else mix["readback_floor"]))
    out = {"correct": answers.calls > 0 and all(c["holds"] for c in checks.values()),
           "attempted": sent, "failed": numbers["bad_rows"]}
    if traced:
        out["metrics"] = per_layer
        dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["device"] = dev_info
        out["breakdown"] = tr.breakdown()
    else:
        builtin = {"qps": window.qps(), "call_p95_ms": window.p95_ms(),
                   "recall_at_10": numbers["recall_at_10"], "setup_s": setup_s}
        out["metrics"] = _read(cell.end_to_end, ctx, builtin)
        out["device"] = dev_info
    out["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    return out, checks
