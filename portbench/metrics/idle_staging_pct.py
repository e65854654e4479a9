"""idle_staging_pct (entry staging; moves qps): the share of the traced
calls' window in which the device is idle while the entry stages numpy
queries onto the card or results back (the program's `turdb.stage_in` /
`turdb.stage_out` host spans), in %: exact interval arithmetic of the idle
time (the window less the union of the device's spans) against the union
of those spans. None where the trace holds no such span."""

from portbench.harness import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    staging = spans.host_spans(tr, spans.is_staging)
    return spans.idle_pct(tr, staging) if staging else None
