"""graph_beam_roofline_pct (HNSW graph beam; moves qps): K8's bound over
K8's device time in the traced calls, in %.

The bound counts the work the program did, from its counters of every K8
launch of a search (the upper levels' descent and level 0), as
`chip_smoke.py`'s K8 check does: 4 bytes a neighbour-list entry read
(expanded nodes × the level's degree), a row and its norm (4·d + 4) a
neighbour scored, the query row and norm a launch, 8 bytes a seed; 2·d
fp32 operations a neighbour scored; the outputs (under 0.1 % of it) left
out; `harness/roofline.py`'s `bound`. The time is the K8 kernels'
(`graph_beam_ms_per_kq.PATTERNS`). The counters sum over every traced
window the run took (a trace that kept no device span is taken again), so
the work is taken a query, times the kept trace's queries. Beside
`graph_beam_rows_per_q`: that one shows less work, this one faster work."""

from portbench.harness import spans
from portbench.harness.roofline import FP32_OPS, bound
from portbench.metrics.graph_beam_ms_per_kq import PATTERNS

PARTS = ("turdb.hnsw.descent", "turdb.hnsw.beam")
UNITS = ("list_entries", "scored", "queries", "seeds")


def read(run):
    tr = run.trace
    ms = tr.kernel_ms(PATTERNS) if tr is not None else 0.0
    if ms <= 0:
        return None
    c = spans.counted([f"{p}.{u}" for p in PARTS for u in UNITS])
    if not c or not c["turdb.hnsw.beam.queries"]:
        return None
    d = run.cell.config["data"]["params"]["dim"]
    total = {u: sum(c[f"{p}.{u}"] for p in PARTS) for u in UNITS}
    nbytes = (4 * total["list_entries"] + (4 * d + 4) * total["scored"]
              + (4 * d + 4) * total["queries"] + 8 * total["seeds"])
    share = tr.queries / c["turdb.hnsw.beam.queries"]
    b = bound(nbytes * share, 2 * d * total["scored"] * share, FP32_OPS)
    return 100.0 * b["bound_ms"] / ms
