#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from BENCHMARK.json (portbench/README.md).
With `--trace 0` the line holds the cell's end-to-end metrics, measured
over a closed loop of `--seconds`; with `--trace 1` its per-layer metrics,
read from a `torch.profiler` trace of the mix's `trace_calls` calls, and a
`breakdown`. Either way every answer is held to the plain reference
afterwards, and each compared number is printed beside its limit, as the
last lines of standard error and under `checks`, the line's last key.

Exits 2 without a result where CUDA is missing or has fewer cards than the
cell asks for, and 3 where a module of JAX or of the JAX package is loaded
once the run is over. Kernel and compiler caches stay in fixed directories
under the checkout's `build/`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "turdb_tpu")


def pin_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache a run may fill, at a fixed path inside
    the checkout (the port's own kernels build into build/turdb_kernels)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import spec

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    from portbench.harness.cell_run import run_cell

    out, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"), T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'holds' if c['holds'] else 'FAILS'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
