"""The HNSW graph kernels on one card: two builds side by side, and where
K8's steps spend their cycles.

Builds the bench's hnsw index (make_pool 1M x 128, the bulk build, as
chip_smoke.py does), then:

1. times K6, K7 and K8 at chip_smoke's shapes (chip_smoke.k6_check,
   k7_check, k8_check, which also hold each kernel against its plain
   version) with two kernel libraries in turn, A B B A: A compiled from
   the `csrc/` of another checkout of the repository (an older commit,
   unpacked with `git archive`), B from this one. The C entry points keep
   their signatures from one commit to the next, so both libraries run
   under the same wrappers. Each time is `ms` (one call between CUDA
   events, the host's launch path included) and `loop_ms` (ten calls back
   to back, a tenth of the time);
2. compiles this checkout's hnsw_beam.cu once more with
   -DBEAM_PHASE_CLOCKS and runs K8 at the search (ef 64), descent (ef 32,
   expand 2) and refine (ef 32, 4096 rows) shapes: the cycles of each
   phase of a step, summed over blocks, per step.

Run on a CUDA card (about four minutes on an H100):

    python3 scripts/exp_torch_graph_kernels.py OTHER_CHECKOUT

It prints one JSON object and writes it to
chiprun_out/exp_torch_graph_kernels.json.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from turdb_tpu_torch import kernels  # noqa: E402
from turdb_tpu_torch.kernels import build  # noqa: E402
from turdb_tpu_torch.models.hnsw import _beam_level, _seed_from_entry  # noqa: E402
from turdb_tpu_torch.ops.distance import Metric  # noqa: E402
from turdb_tpu_torch.utils.datasets import make_pool  # noqa: E402

PHASES = ("seeds", "select+members", "claims", "score+runs", "merge")


def load(csrc: Path):
    """The kernel library compiled from `csrc`."""
    build.CSRC, build._lib = csrc, None
    return build.library()


def use(lib):
    build._lib = lib
    kernels._entry.clear()


def timings(idx, batch, gate):
    gen = torch.Generator(device=batch.device)
    gen.manual_seed(1)
    out = {}
    for name, res in (("K6", cs.k6_check(idx, batch, gate)), ("K8", cs.k8_check(idx, batch)),
                      ("K7", cs.k7_check(idx, gen))):
        for shape, v in res.items():
            out[f"{name} {shape}"] = {"ms": v["ms"], "loop_ms": v["loop_ms"]}
    return out


def phase_library():
    """hnsw_beam.cu alone, with the phase clocks."""
    out = build.BUILD_DIR / "beam_phase_clocks.so"
    src = build.CSRC / "hnsw_beam.cu"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DBEAM_PHASE_CLOCKS", "-I",
                    str(build.CSRC), "-shared", "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.hnsw_graph_beam.argtypes = build.SIGNATURES["hnsw_graph_beam"]
    lib.hnsw_graph_beam.restype = ctypes.c_int
    lib.hnsw_beam_clocks.argtypes = [ctypes.c_void_p]
    lib.hnsw_beam_clocks.restype = ctypes.c_int
    return lib


def phases(idx, batch):
    """Cycles a step of each phase (summed over blocks, over the steps all
    blocks took) at the search, descent and refine shapes."""
    lib = phase_library()
    use(lib)
    st = idx.state
    clocks = (ctypes.c_ulonglong * 8)()

    def read():
        torch.cuda.synchronize()
        assert lib.hnsw_beam_clocks(clocks) == 0
        c = list(clocks)
        return {"steps": c[5], **{p: c[i] / max(c[5], 1) for i, p in enumerate(PHASES)}}

    qb = batch.float().contiguous()
    qbn = (qb * qb).sum(1)
    si, sd = _seed_from_entry(st.vectors, st.norms, qb, qbn, st.entry, Metric.L2)
    si, sd = si[:, None], sd[:, None]
    for lvl in range(len(st.adj_hi), 1, -1):
        sd, si = _beam_level(st.adj_hi[lvl - 1], st.vectors, st.norms, qb, qbn, si, sd, 32, 64,
                             Metric.L2, expand=2)
    read()
    out = {}
    sd1, si1 = _beam_level(st.adj_hi[0], st.vectors, st.norms, qb, qbn, si, sd, 32, 64,
                           Metric.L2, expand=2)
    out["descent"] = read()
    _beam_level(st.adj0, st.vectors, st.norms, qb, qbn, si1, sd1, 64, 96, Metric.L2)
    out["search"] = read()
    rows = torch.nonzero(st.levels[:idx.size] >= 1)[:4096, 0]
    q1, q1n = st.vectors[rows], st.norms[rows]
    s1, d1 = _seed_from_entry(st.vectors, st.norms, q1, q1n, st.entry, Metric.L2)
    _beam_level(st.adj_hi[0], st.vectors, st.norms, q1, q1n, s1, d1, 32, 48, Metric.L2,
                return_expanded=True)
    out["refine"] = read()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve() / "turdb_tpu_torch" / "kernels" / "csrc"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    mine = build.CSRC
    libs = {"A": load(other), "B": load(mine)}
    pool = make_pool(np.random.default_rng(0), cs.N + cs.N_QUERIES, cs.DIM)
    x, queries = pool[:cs.N], pool[cs.N:]
    t = time.perf_counter()
    idx = cs._hnsw_index(dev)
    idx.add(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    idx.pack_serving()
    batch = torch.as_tensor(queries[:cs.BATCH], device=dev)
    runs = []
    for name in ("A", "B", "B", "A"):
        use(libs[name])
        runs.append((name, timings(idx, batch, (32, 24))))
    out = {"card": card, "other": str(other), "build_s": build_s,
           "ab": {k: {n: [r[k] for m, r in runs if m == n] for n in ("A", "B")}
                  for k in runs[0][1]},
           "k8_phase_cycles_per_step": phases(idx, batch)}
    print(json.dumps(out))
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "exp_torch_graph_kernels.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
