"""The client: one closed loop, one call in flight.

A call hands one query set (a numpy array) to the cell's entry and gets
its answers back in numpy, as a user of the index does. The loop cycles
through the query sets from set 0, so no call repeats the one before, and
runs until the first call that ends past `seconds` (or, in an ingest run,
the call that inserts the stream's last wave: `done`); the window is from
the first call's start to the last one's end. Every call's latency is
kept; the answers of the calls that `kept` names go to the check, under
`key(set)` (comparing 800 KB of answers with those kept before costs the
client ~0.2 ms, which every call would add to the window)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from portbench.harness import judge, trace
from portbench.harness.judge import Answers

CHECK_SHARE = 1 / 16   # of the calls after the first pass whose answers are checked
WARMUP_CALLS = 3       # the cell's own call, before the window


@dataclass
class Window:
    calls: int
    queries: int
    seconds: float
    latencies: list      # seconds, one a call, in order
    client_s: float = 0.0  # the client's own bookkeeping between calls

    def qps(self) -> float:
        """Queries answered over the whole window, over its seconds."""
        return self.queries / self.seconds

    def p95_ms(self) -> float:
        """The 95th percentile of every call's latency (linear between
        ranks), in milliseconds."""
        return float(np.percentile(np.asarray(self.latencies), 95)) * 1e3


def checked_calls(seed: int, n_sets: int, n: int = 1 << 20) -> np.ndarray:
    """Which calls' answers are checked: the first pass over the query
    sets, then each later call with probability `CHECK_SHARE`, drawn from
    the seed (the same seed checks the same calls)."""
    keep = np.random.default_rng(seed % 2 ** 64).random(n) < CHECK_SHARE
    keep[:n_sets] = True
    return keep


def closed_loop(call, query_sets: list, seconds: float, answers: Answers,
                kept: np.ndarray, key=None, done=None) -> Window:
    n = len(query_sets)
    lat = []
    queries = 0
    client = 0.0
    start = time.perf_counter()
    end = start + seconds
    while True:
        j = len(lat) % n
        t0 = time.perf_counter()
        dists, ids = call(query_sets[j])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        queries += len(query_sets[j])
        if kept[len(lat) - 1]:
            answers.add(j if key is None else key(j), ids, dists)
        client += time.perf_counter() - t1
        if t1 >= end or (done is not None and done()):
            break
    return Window(calls=len(lat), queries=queries, seconds=t1 - start, latencies=lat,
                  client_s=client)


class Closed:
    """A closed-loop run: queries alone, over the store the build made of
    the whole base (`harness/ingest.py` `Ingest` is the other kind, with
    the same methods)."""

    acked = None          # ids are base rows
    insert = None         # no writes

    def __init__(self, mix: dict, base: np.ndarray):
        self.bulk = base

    def built(self, index, ids, wrap_insert=None) -> None:
        pass

    def steps(self, call):
        return call

    def window(self, call, query_sets, seconds, answers, kept) -> Window:
        return closed_loop(call, query_sets, seconds, answers, kept)

    def traced(self, call, query_sets, answers, kept) -> trace.Trace:
        return trace.traced_loop(call, query_sets, answers, kept)

    def readback(self, call, seed: int) -> None:
        return None

    truth = staticmethod(judge.truth_of)
