"""The HNSW insert paths and the SQ graph search of two checkouts on one
card, in turns.

Runs chip_smoke.py's `hnsw_insert_phase` (a bulk graph of N - 65,536
make_pool rows, 256 single-row adds, 65,280 rows in waves of 512, a
traced copy of the waves, the serve sweep, then `search` at ef 64 over the
f32, SQ16 and SQ8 stores) and `hnsw_wave_phase` (65,536 rows in waves from
empty, then a vacuum) from each checkout's own chip_smoke.py, each run in
a process of its own, A B B A: A another checkout (an older commit
unpacked with `git archive`), B this one. Prints, per run, the waves'
rows/s and the device's idle share in their trace, the single-row p50 /
p99 ms, the three stores' graph-search QPS and the waves from empty.

Run on a CUDA card (about five minutes on an H100):

    python3 scripts/exp_torch_insert_ab.py OTHER_CHECKOUT

It prints one JSON object and writes it to
chiprun_out/exp_torch_insert_ab.json.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import json, numpy as np, torch
import chip_smoke as cs
from turdb_tpu_torch.utils.datasets import make_pool
dev = torch.device("cuda")
pool = make_pool(np.random.default_rng(0), cs.N + cs.N_QUERIES, cs.DIM)
x, queries = pool[:cs.N], pool[cs.N:]
truth, _ = cs._oracle(dev, x, queries)
ins, idx = cs.hnsw_insert_phase(dev, x, queries, truth)
del idx
torch.cuda.empty_cache()
wave, idx = cs.hnsw_wave_phase(dev, x, queries)
prof = ins["waves"]["profile"]
print("RESULT " + json.dumps({
    "waves_rows_per_s": ins["waves"]["rows_per_s"], "waves_idle": prof.get("idle_share"),
    "waves_busy_ms": prof.get("busy_ms"), "single_p50_ms": ins["single"]["p50_ms"],
    "single_p99_ms": ins["single"]["p99_ms"],
    **{f"{s}_qps": ins[s]["qps"] for s in ("f32", "sq16", "sq8")},
    **{f"{s}_recall": ins[s]["recall@10"] for s in ("f32", "sq16", "sq8")},
    "from_empty_rows_per_s": wave["rows_per_s"], "from_empty_recall": wave["recall@10"]}))
"""


def run(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True, text=True)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode or not lines:
        raise RuntimeError(f"run in {root} failed ({out.returncode}):\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    runs = [(name, run({"A": other, "B": ROOT}[name])) for name in ("A", "B", "B", "A")]
    out = {"card": card, "other": str(other),
           "ab": {k: {n: [r[k] for m, r in runs if m == n] for n in ("A", "B")}
                  for k in runs[0][1]}}
    print(json.dumps(out))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "exp_torch_insert_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
