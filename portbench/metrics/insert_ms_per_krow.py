"""insert_ms_per_krow (ingest; moves qps): the device ms of the insert
waves per 1,000 rows inserted, in the traced calls: every device span
that starts inside one of the program's `turdb.hnsw.insert` spans (one a
wave: the descent, the connecting beams and selections, the reverse
edges), over the rows of its counter `turdb.hnsw.insert.rows`. The
counters sum over every traced window the run took (a trace that kept no
device span is taken again), so the rows are taken a wave
(`turdb.hnsw.insert.waves`), times the kept trace's waves. A wave ends on
the host with a few small launches queued, which start after its span and
are left out. None where the program opens no such span (a closed cell,
or a program that does not trace its inserts)."""

from portbench.harness import spans

NAME = "turdb.hnsw.insert"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    waves = spans.device_within(tr, lambda n: n == NAME, [""])
    c = spans.counted([f"{NAME}.rows", f"{NAME}.waves"])
    if not waves or not c or not c[f"{NAME}.waves"]:
        return None
    rows = len(waves) * c[f"{NAME}.rows"] / c[f"{NAME}.waves"]
    ms = sum(spans.length(spans.union(w)) for w in waves) / 1e3
    return ms / (rows / 1e3)
