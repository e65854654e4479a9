"""The port's examples (examples/torch_*.py) at a small size on the CPU,
and the timing module's `enable` / `profile_trace`.

Each example runs its `main` with `--device cpu` and a size argument (on
the card by default): the vector-serving one answers from FlatIndex,
IvfIndex, HnswIndex and a 4-shard ShardedIvfIndex over copies of the
device, the quickstart's SQL statement takes the ANN path, and the
insert profiler inserts every row.
"""

import importlib
import sys
from pathlib import Path

import pytest
import torch

from turdb_tpu_torch.utils import timing

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

torch.set_num_threads(1)


def test_vector_serving_example(capsys):
    example = importlib.import_module("torch_vector_serving")
    out = example.main(["--device", "cpu", "--n", "400"])
    assert set(out) == {"ivf", "hnsw", "mesh"}
    assert min(out.values()) >= 0.9, out
    assert "4 shards x 2-way query parallel" in capsys.readouterr().out


def test_quickstart_example():
    example = importlib.import_module("torch_quickstart")
    rows, plan = example.main(["--device", "cpu", "--rows", "200"])
    assert len(rows) == 5
    assert [r[2] for r in rows] == sorted(r[2] for r in rows)
    assert any("AnnIndexScan" in line for line in plan)


def test_profile_insert_example():
    example = importlib.import_module("torch_profile_insert")
    count, _ = example.main(["--device", "cpu", "500"])
    assert count == 2500


def test_timed_follows_enable():
    """`enable(False)` stops the phase counters, as the reference's does."""
    timing.reset()
    try:
        timing.enable(False)
        with timing.timed("off"):
            pass
        assert "off" not in timing.TIMERS
        timing.enable(True)
        with timing.timed("on"):
            pass
        assert timing.TIMERS["on"]["count"] == 1
    finally:
        timing.enable(True)
        timing.reset()


def test_profile_trace_needs_a_card(tmp_path, monkeypatch):
    """Without CUDA `profile_trace` raises and writes nothing: no trace of
    the host alone stands in for a device trace."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with timing.profile_trace(tmp_path / "trace"):
            pass
    assert not (tmp_path / "trace").exists()
