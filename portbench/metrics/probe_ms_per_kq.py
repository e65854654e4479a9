"""probe_ms_per_kq (probe; moves qps): K1's device ms per 1,000 queries:
the f32 probe's chunk and merge kernels (`ivf_probe.cu`), or its wide
form's distance pass and tail (`probe_wide.cu`), from the trace of the IVF
cells' calls."""

PATTERNS = ("probe_chunk_kernel<F32Scorer>", "probe_merge_kernel", "probe_dist_f32_kernel",
            "probe_tail_wide_kernel")


def read(run):
    return run.trace.ms_per_kq(PATTERNS) if run.trace is not None else None
