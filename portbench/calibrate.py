#!/usr/bin/env python3
"""Readings that the cells' operating points and limits are set from.

    python3 portbench/calibrate.py --config <name> --seeds 0,1,2,... [--out FILE]

For each seed, in one process: the configuration's data and index (built
once for every cell of BENCHMARK.json on that configuration, with every
cell's `prepare` steps), then for each cell

- on the mix's `sweep.seeds`: recall@10 over all the query sets at each
  point of `sweep.points`;
- at the mix's operating point: the compared numbers (portbench/harness/
  judge.py) of one pass over the query sets through the cell's entry, the
  program's readings;
- the control's: the reference put in the program's place in the next
  precision down (exact k-NN with the product in TF32), on the same sets;
- the faults a cell can have, planted in the program's answers of that
  pass: a call that returns the previous call's answers (its state left
  unchanged), half of each call's queries left unanswered, one answer of
  each call altered where it is produced.

One JSON line a (seed, cell) goes to standard output and to `--out`. The
benchmark's own runs do not run this. It reads the closed-loop cells; an
ingest cell's index changes under its calls, so its numbers are read from
its runs' `checks`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def point_kwargs(mix: dict, point) -> dict:
    """The entry's keyword arguments at a sweep point (the mix's own keys)."""
    keys = list(mix["kwargs"])
    values = point if isinstance(point, (list, tuple)) else [point]
    return dict(zip(keys, values))


def one_pass(call, query_sets):
    from portbench.harness.judge import Answers

    answers = Answers()
    for j, q in enumerate(query_sets):
        dists, ids = call(q)
        answers.add(j, ids, dists)
    return answers


def planted_faults(answers, n_rows: int) -> dict:
    """Copies of one pass's answers with each fault planted."""
    from portbench.harness.judge import Answers

    sets = sorted(answers.by_set)
    first = {j: answers.by_set[j][0] for j in sets}
    stale, half, altered = Answers(), Answers(), Answers()
    for pos, j in enumerate(sets):
        ids, dists, _ = first[j]
        prev = first[sets[pos - 1]]   # set 0 gets the last set's
        stale.add(j, prev[0], prev[1])
        h_ids, h_d = ids.copy(), dists.copy()
        h_ids[len(ids) // 2:] = -1
        h_d[len(ids) // 2:] = np.inf
        half.add(j, h_ids, h_d)
        a_ids = ids.copy()
        a_ids[0, 0] = (a_ids[0, 0] + 1) % n_rows
        altered.add(j, a_ids, dists)
    return {"state_unchanged": stale, "half_unanswered": half, "answer_altered": altered}


def control_answers(base, sets_t, k: int):
    """The reference in the program's place, with its product in TF32."""
    from portbench.harness.judge import Answers
    from portbench.reference.knn import exact_knn

    answers = Answers()
    for j, q in enumerate(sets_t):
        d, i = exact_knn(base, q, k, precision="tf32")
        answers.add(j, i.cpu().numpy().astype(np.int32), d.cpu().numpy())
    return answers


def calibrate_seed(cells: list, seed: int, device, emit) -> None:
    import torch

    from portbench.harness import judge, spec, systems
    from portbench.reference.knn import require_metric

    cfg = cells[0].config
    require_metric(cfg["metric"])
    data = cfg["data"]
    gen = torch.Generator(device=device).manual_seed(seed)
    base, queries = spec.generator(data["generator"])(gen, device, **data["params"])
    batch = cells[0].traffic["batch"]
    sets_np = [queries[s:s + batch].cpu().numpy()
               for s in range(0, queries.shape[0] - batch + 1, batch)]
    base_np = base.cpu().numpy()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    steps = [s for c in cells for s in c.traffic.get("prepare", [])]
    index, _ = systems.build_index(cfg, {"prepare": steps}, base_np, device)
    sync()
    build_s = time.perf_counter() - t
    sets_t = [torch.as_tensor(q, device=device) for q in sets_np]
    k = cells[0].traffic["k"]
    t = time.perf_counter()
    truth = judge.truth_of(base, sets_t, range(len(sets_t)), k)
    sync()
    truth_s = time.perf_counter() - t
    for cell in cells:
        mix = cell.traffic
        limits = judge.Limits(mix["recall_floor"], cfg["checks"]["dist_rel_err"])
        row = {"seed": seed, "cell": cell.name, "build_s": build_s, "truth_s": truth_s}
        if seed in mix["sweep"]["seeds"]:
            sweep = []
            for point in mix["sweep"]["points"]:
                kw = point_kwargs(mix, point)
                ans = one_pass(systems.entry(index, {**mix, "kwargs": kw}), sets_np)
                r = judge.judge(ans, base, sets_t, truth, k)["recall_at_10"]
                sweep.append([point, r])
            row["sweep"] = sweep
        call = systems.entry(index, mix)
        call(sets_np[0])
        sync()
        t = time.perf_counter()
        ans = one_pass(call, sets_np)
        sync()
        row["pass_s"] = time.perf_counter() - t
        row["point"] = mix["kwargs"]
        nums = judge.judge(ans, base, sets_t, truth, k)
        row["program"] = {**nums, "correct": all(
            c["holds"] for c in judge.verdict(nums, limits).values())}
        row["faults"] = {}
        for name, bad in planted_faults(ans, base.shape[0]).items():
            fn = judge.judge(bad, base, sets_t, truth, k)
            row["faults"][name] = {**fn, "correct": all(
                c["holds"] for c in judge.verdict(fn, limits).values())}
        t = time.perf_counter()
        ctl = control_answers(base, sets_t, k)
        sync()
        row["control_s"] = time.perf_counter() - t
        cn = judge.judge(ctl, base, sets_t, truth, k)
        row["control"] = {**cn, "correct": all(
            c["holds"] for c in judge.verdict(cn, limits).values())}
        emit(row)
    del index


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import spec

    bench = spec.load_benchmark()
    cells = [spec.find_cell(bench, w["name"]) for w in bench["workloads"]
             if w["config"] == args.config]
    cells = [c for c in cells if c.traffic.get("loop", "closed") == "closed"]
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            calibrate_seed(cells, seed, device, emit)
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
