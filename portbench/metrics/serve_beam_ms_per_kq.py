"""serve_beam_ms_per_kq (HNSW serve beam; moves qps): device ms of K4's
seeding over the pack's cells (`probe_chunk_kernel` on int8 codes and its
merge) and of K6 `serve_beam_kernel` (or its wide form) per 1,000 queries,
from the trace of `HnswIndex.search_serve`'s calls."""

PATTERNS = ("probe_chunk_kernel<Sq8", "probe_merge_kernel", "serve_beam_kernel",
            "serve_beam_wide_kernel")


def read(run):
    return run.trace.ms_per_kq(PATTERNS) if run.trace is not None else None
