"""On the card: every cell end to end at a reduced size, untraced and
traced, and ingest cells that a later change would add as files alone
(the traced ingest run needs the card's profiler). Marked `cuda`; skips
where there is no CUDA device (decided in the fixture, never at import).
On a machine with the card:

    python3 -m pytest --noconftest -q portbench/tests/test_portbench_card.py
"""

import pytest
import torch
from portbench_helpers import grow, ingest_mix, spec, store, tiny_cell

from portbench.harness.cell_run import run_cell

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name):
    cell = tiny_cell(name, batch=2000, n_base=60_000, n_queries=20_000, n_clusters=256)
    out, _ = run_cell(cell, 2 ** 32 + 17, 1.0, False, cuda, 0.0)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    traced, _ = run_cell(cell, 2 ** 32 + 17, 1.0, True, cuda, 0.0)
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert traced["breakdown"]["device_ops"]


def test_an_ingest_cell_on_the_card(cuda, tmp_path):
    """The exact index, which keeps every acknowledged row where a search
    finds it. (An IVF index, where a stream grows the store by a third,
    puts rows its full cells cannot take in cells that their own vector
    does not probe: PERF.md §7.)"""
    config = store({"class": "FlatIndex", "kwargs": {}}, n_base=60_000, n_queries=20_000,
                   dim=128, n_clusters=256)
    root = grow(tmp_path, configs={"card": config},
                mixes={"card-ingest": ingest_mix({}, batch=2000, stream=16_384, wave=32)},
                cells={"card.ingest": ("card", "card-ingest")})
    cell = spec.find_cell(spec.load_benchmark(root), "card.ingest", root=root)
    out, _ = run_cell(cell, 2 ** 32 + 19, 1.0, False, cuda, 0.0)
    assert out["correct"], out["checks"]
    traced, _ = run_cell(cell, 2 ** 32 + 19, 1.0, True, cuda, 0.0)
    assert traced["correct"] and traced["device"]["busy_s"] > 0
