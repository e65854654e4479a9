"""An ingest run: the store takes writes between the query calls.

The mix's last `stream` rows of the configuration's base are held out of
the build; they arrive during the run, in order, `wave` rows at a time.
Each call of the closed loop (`loop.closed_loop`; traced,
`trace.traced_loop`) inserts the next wave through the index's `add`,
then answers one query set through the mix's `entry`: the call's latency
holds both, so a slower insert path shows in `qps` and `call_p95_ms`.
The warm-up's calls insert waves too, and those rows count as
acknowledged. The window ends at the first call that ends past
`--seconds`, or at the call that inserts the stream's last wave. Traced,
each wave runs inside a `portbench.insert` host range; a trace taken
again inserts its waves again, against the grown store, which is why
`spec.check_traffic` counts the waves of every try.

Every id an `add` returns is kept (`judge.Acked`); each checked call's
answers are keyed by (query set, rows acknowledged before its query) and
judged against the exact k-NN of that prefix of the base. After the
window, before the index is freed, `readback` asks the index for a sample
of the acknowledged stream rows' own vectors (min(`READBACK_ROWS`, those
rows), drawn from the seed, `batch` at a time, untimed): the share whose
own id is among their k answers.
"""

from __future__ import annotations

import contextlib

import numpy as np

from portbench.harness import judge, loop, trace
from portbench.reference.knn import exact_knn

READBACK_ROWS = 10_000


class Ingest:
    """The stream of one ingest run and the ids acknowledged so far."""

    def __init__(self, mix: dict, base: np.ndarray):
        self.mix = mix
        self.base = base
        self.n_bulk = base.shape[0] - int(mix["stream"])
        self.bulk = base[:self.n_bulk]
        wave = int(mix["wave"])
        self.waves = [base[s:s + wave] for s in range(self.n_bulk, base.shape[0], wave)]
        self.sent = 0           # waves inserted
        self.acked = judge.Acked()
        self.insert = None

    def built(self, index, ids, wrap_insert=None) -> None:
        """Take the build's ids; later waves go through the index's `add`."""
        self.acked.add(ids, self.n_bulk)
        self.insert = index.add
        if wrap_insert is not None:
            self.insert = wrap_insert(self.insert)

    def done(self) -> bool:
        return self.sent == len(self.waves)

    def key(self, j: int) -> tuple:
        return j, self.acked.n

    def steps(self, call, mark=None):
        """The cell's call with the next wave inserted before its query;
        `mark` (traced runs: `record_function`) opens `trace.INSERT`."""
        def step(queries):
            if self.done():
                raise RuntimeError(f"the stream's {len(self.waves)} waves are spent")
            wave = self.waves[self.sent]
            with mark(trace.INSERT) if mark is not None else contextlib.nullcontext():
                self.acked.add(self.insert(wave), len(wave))
            self.sent += 1
            return call(queries)
        return step

    def window(self, call, query_sets, seconds, answers, kept) -> loop.Window:
        return loop.closed_loop(self.steps(call), query_sets, seconds, answers, kept,
                                key=self.key, done=self.done)

    def traced(self, call, query_sets, answers, kept) -> trace.Trace:
        from torch.profiler import record_function

        return trace.traced_loop(self.steps(call, record_function), query_sets, answers,
                                 kept, key=self.key)

    def readback(self, call, seed: int) -> float:
        """The share of a sample of the acknowledged stream rows whose own
        id is among the k answers to their own vector."""
        streamed = self.acked.n - self.n_bulk
        m = min(READBACK_ROWS, streamed)
        rows = self.n_bulk + np.random.default_rng((seed % 2 ** 64, 1)).choice(
            streamed, m, replace=False)
        own = self.acked.ids_of(rows)
        batch = int(self.mix["batch"])
        found = 0
        for s in range(0, m, batch):
            _, ids = call(self.base[rows[s:s + batch]])
            found += int((np.asarray(ids) == own[s:s + batch, None]).any(1).sum())
        return found / m

    @staticmethod
    def truth(base, query_sets, keys, k: int) -> dict:
        """The reference's (dists, ids) for each (query set, prefix) key."""
        return {(j, n): exact_knn(base[:n], query_sets[j], k) for j, n in sorted(keys)}
