"""graph_beam_rows_per_q (HNSW graph beam; moves qps): the rows K8 scores a
query, in the upper levels' descent and the level-0 beam together (the
launches `graph_beam_ms_per_kq` times): the program's counters
`turdb.hnsw.descent.scored` + `turdb.hnsw.beam.scored` over
`turdb.hnsw.beam.queries`, counted in the traced calls."""

from portbench.harness import spans

NAMES = ["turdb.hnsw.descent.scored", "turdb.hnsw.beam.scored", "turdb.hnsw.beam.queries"]


def read(run):
    if run.trace is None:
        return None
    c = spans.counted(NAMES)
    if not c or not c["turdb.hnsw.beam.queries"]:
        return None
    return (c["turdb.hnsw.descent.scored"] + c["turdb.hnsw.beam.scored"]) \
        / c["turdb.hnsw.beam.queries"]
