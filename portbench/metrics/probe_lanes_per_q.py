"""probe_lanes_per_q (probe; moves qps): the live lanes K1 scores a query,
replicas included: the program's counters `turdb.ivf.probe.lanes` over
`turdb.ivf.probe.queries`, counted in the traced calls."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    c = spans.counted(["turdb.ivf.probe.lanes", "turdb.ivf.probe.queries"])
    if not c or not c["turdb.ivf.probe.queries"]:
        return None
    return c["turdb.ivf.probe.lanes"] / c["turdb.ivf.probe.queries"]
