"""What decides `correct`: the reference against brute force, a sound run
of the port on the CPU, the control (the reference in TF32 put in the
program's place), and a run with the timed path broken underneath in each
way a cell can break, which has to come out not correct."""

import json

import numpy as np
import pytest
import torch
from portbench_helpers import tiny_cell

from portbench.calibrate import control_answers, one_pass
from portbench.harness import judge
from portbench.harness.cell_run import run_cell
from portbench.reference.knn import exact_knn, round_tf32

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_reference_equals_brute_force():
    g = torch.Generator().manual_seed(3)
    base = torch.randn(700, 24, generator=g)
    queries = torch.randn(60, 24, generator=g)
    d, i = exact_knn(base, queries, 10, block=16)
    full = ((queries.double()[:, None, :] - base.double()[None]) ** 2).sum(-1)
    want_d, want_i = torch.topk(full, 10, dim=1, largest=False)
    assert torch.equal(i, want_i)
    assert torch.allclose(d.double(), want_d, rtol=1e-6)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]


@pytest.fixture(scope="module")
def sound():
    cell = tiny_cell("sift1m-ivf.r95-b10k")
    return cell, run_cell(cell, 2 ** 33 + 5, 0.5, False, "cpu", 0.0)


def test_sound_run_is_correct_and_its_line_has_the_contract_keys(sound):
    cell, (out, checks) = sound
    assert list(out) == KEYS and out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] % cell.traffic["batch"] == 0
    assert set(out["metrics"]) == {"qps", "call_p95_ms", "recall_at_10", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(out["checks"]) == ["recall_at_10", "dist_rel_err", "bad_rows"]
    assert all(c["holds"] for c in checks.values())
    json.dumps(out)


def _broken(kind):
    def wrap(call):
        prev = {}

        def broken(q):
            d, i = call(q)
            if kind == "state_unchanged":       # the previous call's answers again
                out = prev.get("last", (d, i))
                prev["last"] = (d, i)
                return out
            d, i = d.copy(), i.copy()
            if kind == "half_unanswered":
                i[len(i) // 2:] = -1
                d[len(d) // 2:] = np.inf
            elif kind == "answer_altered":      # one row's nearest id, off by one
                i[0, 0] = i[0, 0] + 1
            return d, i
        return broken
    return wrap


@pytest.mark.parametrize("kind", ["state_unchanged", "half_unanswered", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(kind):
    cell = tiny_cell("sift1m-ivf.r95-b10k")
    out, checks = run_cell(cell, 77, 0.3, False, "cpu", 0.0, wrap_call=_broken(kind))
    assert out["correct"] is False
    assert not all(c["holds"] for c in checks.values())


def test_a_configuration_on_another_distance_is_refused_before_any_work():
    """The reference implements squared L2 only: a cosine configuration
    would be judged against L2 truth, so the run stops at once."""
    cell = tiny_cell("sift1m-ivf.r95-b10k")
    cell.config["metric"] = "cosine"

    def never(call):
        raise AssertionError("the entry was reached")
    with pytest.raises(ValueError, match="cosine"):
        run_cell(cell, 5, 0.1, False, "cpu", 0.0, wrap_call=never)


def test_the_control_fails_and_the_program_holds():
    """The reference with its product in TF32, in the program's place, fails
    the configuration's distance limit; the port's own answers hold it."""
    cell = tiny_cell("sift1m-ivf.r95-b10k", n_base=6000)
    from portbench.harness import spec, systems

    p = cell.config["data"]["params"]
    base, queries = spec.generator("make_pool")(torch.Generator().manual_seed(11), "cpu", **p)
    sets = [queries[s:s + 500] for s in range(0, len(queries), 500)]
    truth = judge.truth_of(base, sets, range(len(sets)), 10)
    limit = cell.config["checks"]["dist_rel_err"]
    ctl = judge.judge(control_answers(base, sets, 10), base, sets, truth, 10)
    assert ctl["dist_rel_err"] > limit
    index, _ = systems.build_index(cell.config, cell.traffic, base.numpy(), "cpu")
    prog = judge.judge(one_pass(systems.entry(index, cell.traffic), [s.numpy() for s in sets]),
                       base, sets, truth, 10)
    assert prog["dist_rel_err"] <= limit and prog["bad_rows"] == 0
    assert prog["recall_at_10"] >= cell.traffic["recall_floor"]
