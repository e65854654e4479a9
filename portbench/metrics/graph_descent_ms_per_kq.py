"""graph_descent_ms_per_kq (HNSW graph beam; moves qps): the device ms of
the upper levels' descent per 1,000 queries, in the traced calls: the K8
launches (`graph_beam_ms_per_kq.PATTERNS`) of each call's entry span
(the program's `turdb.hnsw.search`) but its last, which is level 0's beam.
Beside `graph_beam_ms_per_kq`, which holds them all, it splits K8's time
between the descent and level 0. None where the trace holds no such span
(a graph whose descent is greedy launches one K8 a call and reads 0)."""

from portbench.harness import spans
from portbench.metrics.graph_beam_ms_per_kq import PATTERNS


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = [c for c in spans.device_within(tr, lambda n: n == "turdb.hnsw.search", PATTERNS)
             if c]
    if not calls:
        return None
    ms = sum(e - s for c in calls for s, e in c[:-1]) / 1e3
    return ms / (tr.queries / 1e3)
