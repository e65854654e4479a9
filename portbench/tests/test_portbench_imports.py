"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: `turdb_tpu_torch` begins with `turdb_tpu`), and the
command refuses a machine without the card it needs."""

import subprocess
import sys
import textwrap

import pytest
from portbench_helpers import ROOT

sys.path.insert(0, str(ROOT / "portbench"))
import run as portbench_run  # noqa: E402


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("turdb_tpu_torch", "turdb_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules["sys"])
    monkeypatch.setitem(sys.modules, "turdb_tpu.models", sys.modules["sys"])
    found = portbench_run.forbidden_modules()
    assert "turdb_tpu.models" in found
    assert not {"turdb_tpu_torch", "turdb_tpu_torch.models", "jaxtyping", "flaxen"} & set(found)


def test_a_run_and_its_reference_load_no_jax():
    """A whole run of a cell on the CPU, with every metric reader and the
    calibration's control loaded too, in a fresh process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'portbench' / 'tests')!r}, {str(ROOT / 'portbench')!r}]
        from portbench_helpers import tiny_cell, spec
        import run, calibrate
        from portbench.harness.cell_run import run_cell
        cell = tiny_cell("sift1m-ivf.r95-b10k")
        out, _ = run_cell(cell, 5, 0.2, False, "cpu", 0.0)
        assert out["correct"], out
        for m in spec.load_benchmark()["per_layer"]:
            spec.metric_reader(m["name"])
        print("FOUND", run.forbidden_modules(), "PORT", "turdb_tpu_torch.models" in sys.modules)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND [] PORT True" in res.stdout


def test_the_command_exits_without_a_result_where_the_card_is_missing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "sift1m-ivf.r95-b10k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 2 and res.stdout.strip() == ""
