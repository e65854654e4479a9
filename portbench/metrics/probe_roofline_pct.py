"""probe_roofline_pct (probe; moves qps): K1's bound over K1's device time
in the traced calls, in %.

The bound counts the probe's work from the benchmark's own inputs, not from
the cells the program built (portbench/harness/roofline.py): the rows are
split by `plain_partition` into the configuration's
`yardstick.partition_cells` cells, and each traced call's queries probe
their `nprobe` nearest; each probed cell's rows are read once a call, each
query, cell list and output once; 2·d operations a (query, row of a probed
cell); the larger of the bytes at 3.35 TB/s and the operations at fp32's
67 TFLOP/s. A change to the program's layout (the cell count, the split,
the boundary replicas) moves K1's time and not the bound. A configuration
without `yardstick.partition_cells` fails the run."""

from collections import Counter

import torch

from portbench.harness.roofline import plain_partition, probe_bound, probed_cells

PATTERNS = ("probe_chunk_kernel<F32Scorer>", "probe_merge_kernel", "probe_dist_f32_kernel",
            "probe_tail_wide_kernel")


def read(run):
    tr = run.trace
    ms = tr.kernel_ms(PATTERNS) if tr is not None else 0.0
    if ms <= 0:
        return None
    cells = run.cell.config["yardstick"]["partition_cells"]
    nprobe, k = run.cell.traffic["kwargs"]["nprobe"], run.cell.traffic["k"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cent, cn, sizes = plain_partition(torch.as_tensor(run.base, device=device), cells)
    total = 0.0
    for j, calls in Counter(tr.sets).items():
        q = torch.as_tensor(run.query_sets[j], device=device)
        b = probe_bound(probed_cells(q, cent, cn, nprobe), sizes, q.shape[1], k)
        total += calls * b["bound_ms"]
    return 100.0 * total / ms
