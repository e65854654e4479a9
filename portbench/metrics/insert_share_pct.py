"""insert_share_pct (ingest; moves qps): the share of the traced calls'
host time spent inserting their waves, in %: the harness's own
`portbench.insert` ranges (each call's `add` of its wave) over its
`portbench.call` ranges. None where the trace holds no wave (a closed
cell)."""

from portbench.harness import spans, trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = spans.host_spans(tr, lambda n: n == trace.CALL)
    waves = spans.host_spans(tr, lambda n: n == trace.INSERT)
    if not calls or not waves:
        return None
    return 100.0 * spans.length(spans.intersect(waves, calls)) / spans.length(calls)
