"""serve_beam_rows_per_q (HNSW serve beam; moves qps): the neighbour rows
K6 scores a query in its int8 beam: the program's counters
`turdb.serve.beam.scored` over `turdb.serve.beam.queries`, counted in the
traced calls (at most the expansions × the pack's degree)."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    c = spans.counted(["turdb.serve.beam.scored", "turdb.serve.beam.queries"])
    if not c or not c["turdb.serve.beam.queries"]:
        return None
    return c["turdb.serve.beam.scored"] / c["turdb.serve.beam.queries"]
