"""cellsel_ms_per_kq (cell selection; moves qps): device ms of the
centroid product (the library's GEMM) and K2 `topk_rows` per 1,000
queries, from the trace of the IVF cells' calls."""

PATTERNS = ("gemm", "topk_short_kernel", "topk_seg_kernel", "topk_cluster_kernel",
            "topk_wide_kernel")


def read(run):
    return run.trace.ms_per_kq(PATTERNS) if run.trace is not None else None
