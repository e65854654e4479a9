"""graph_beam_ms_per_kq (HNSW graph beam; moves qps): device ms of K8
`graph_beam_kernel` (or its wide form) per 1,000 queries, from the trace of
`HnswIndex.search`'s calls on the unpacked graph."""

PATTERNS = ("graph_beam_kernel", "graph_beam_wide_kernel")


def read(run):
    return run.trace.ms_per_kq(PATTERNS) if run.trace is not None else None
