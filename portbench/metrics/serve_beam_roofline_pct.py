"""serve_beam_roofline_pct (HNSW serve beam; moves qps): K6's bound over
K6's device time in the traced calls, in %.

The bound counts the work the program did, from its counters of each K6
launch, as `chip_smoke.py`'s K6 check does: a 16-byte meta record a
neighbour-list entry read (expanded nodes × the pack's degree), d int8
code bytes a neighbour scored, a row and norm (4·d + 4) a reranked row,
the query (f32 row, int8 row, norm, scale, sum: 5·d + 12) a query, 8 bytes
a seed; 2·d int8 operations a neighbour scored and 2·d fp32 ones a
reranked row; the outputs left out; `harness/roofline.py`'s `bound`. The
time is `serve_beam_kernel`'s (or its wide form's) alone: K4's seeding is
not in it. As in `graph_beam_roofline_pct`, the work is taken a query,
times the kept trace's queries. Beside `serve_beam_rows_per_q`: that one
shows less work, this one faster work."""

from portbench.harness import spans
from portbench.harness.roofline import FP32_OPS, INT8_OPS, bound

PATTERNS = ("serve_beam_kernel", "serve_beam_wide_kernel")
UNITS = ("list_entries", "scored", "reranked", "queries", "seeds")


def read(run):
    tr = run.trace
    ms = tr.kernel_ms(PATTERNS) if tr is not None else 0.0
    if ms <= 0:
        return None
    c = spans.counted([f"turdb.serve.beam.{u}" for u in UNITS])
    if not c or not c["turdb.serve.beam.queries"]:
        return None
    n = {u: c[f"turdb.serve.beam.{u}"] for u in UNITS}
    d = run.cell.config["data"]["params"]["dim"]
    share = tr.queries / n["queries"]
    nbytes = (16 * n["list_entries"] + d * n["scored"] + (4 * d + 4) * n["reranked"]
              + (5 * d + 12) * n["queries"] + 8 * n["seeds"])
    b = bound(nbytes * share, [(2 * d * n["scored"] * share, INT8_OPS),
                               (2 * d * n["reranked"] * share, FP32_OPS)])
    return 100.0 * b["bound_ms"] / ms
