"""insert_idle_pct (ingest; moves qps): the share of the traced calls'
window in which the device is idle inside the program's
`turdb.hnsw.insert` spans, in %: the host's part of the insert waves (the
level masks, the syncs of the reverse edges' grouping, the launches).
None where the program opens no such span."""

from portbench.harness import spans

NAME = "turdb.hnsw.insert"


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    waves = spans.host_spans(tr, lambda n: n == NAME)
    if not waves:
        return None
    return spans.idle_pct(tr, waves)
