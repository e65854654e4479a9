"""idle_entry_pct (entry; moves qps): the share of the traced calls'
window in which the device is idle inside the entry's own span
(`turdb.ivf.search`, `turdb.hnsw.search`, `turdb.hnsw.search_serve`) but
outside its staging spans, in %: the entry's host work. `device_idle_pct`
less this and `idle_staging_pct` is the client's own share. None where
the trace holds no entry span."""

from portbench.harness import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    entry = spans.host_spans(tr, spans.is_entry)
    if not entry:
        return None
    return spans.idle_pct(tr, spans.subtract(entry, spans.host_spans(tr, spans.is_staging)))
