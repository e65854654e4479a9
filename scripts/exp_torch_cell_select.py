"""K12 `cell_select` against the GEMM + K2 pair it replaces, on one card.

At the main paths' cell-selection shapes (the IVF cells' B = 10,000 over
~20,400 centroids at P = 5 and 8, serve's seeding over 3,906 at P = 2, a
bulk build's self-probe chunk of 4,096, and the SQL path's B = 1, 16 and
256), on clustered queries and centroids:

1. the pair (`q @ C.T`, the library's fp32 GEMM, then K2 `topk_rows`) and
   K12, which must choose the same cells but at near-ties (the share of
   ids apart, the largest distance difference);
2. times each in turns A B B A (A the pair, B K12): `ms` (a median of one
   call between CUDA events), `loop_ms` (ten calls back to back, a tenth
   of the time) and `device_ms` (a call's device time in a trace, with its
   kernels); beside them K12's bound (2·B·C·d FLOP at 67 TFLOP/s) and
   `library_ms` (`torch.mm` of the distances' product, then `torch.topk`;
   a yardstick only).

3. with `--variant NAME=FLAGS` (flags split on commas, e.g.
   `clk=-DCS_CLOCKS`, which adds each phase's share of the warps' cycles;
   `mi=M` and `sm=N` among them launch that variant with a query tile of
   16·M planned at N blocks an SM), builds `csrc/cell_select.cu` alone with each set
   of extra nvcc flags (its ptxas report kept), holds each variant's
   outputs equal to the built library's and times them all in turns
   (K12, the variants, then back): `loop_ms` of ten calls.

Run on a CUDA card:

    python3 scripts/exp_torch_cell_select.py [--quick] [--real] [--variant NAME=FLAGS ...]

`--quick` times the r95 shape alone; `--real` times the variants on the
IVF cells' own index and queries (portbench's store) at nprobe 5 and 8 too. It prints one JSON object and writes
it to exp_torch_cell_select.json in chip_smoke.py's output directory.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import FP32_OPS, OUT, _bound, _loop_ms, _median_ms, _traced  # noqa: E402
from turdb_tpu_torch import kernels  # noqa: E402
from turdb_tpu_torch.kernels import EPI_L2, build, cell_select_kernel, topk_rows  # noqa: E402

SHAPES = {   # name: (B, C, d, P)
    "r95": (10_000, 20_429, 128, 5),
    "r99": (10_000, 20_429, 128, 8),
    "serve_seed": (10_000, 3_906, 128, 2),
    "self_probe": (4_096, 20_429, 128, 8),
    "b2048": (2_048, 20_429, 128, 8),
    "b1024": (1_024, 20_429, 128, 8),
    "b512": (512, 20_429, 128, 8),
    "b256": (256, 20_429, 128, 8),
    "b16": (16, 20_429, 128, 8),
    "b1": (1, 20_429, 128, 8),
}


def _data(b, c, d, gen, dev):
    """Clustered centroids and queries near them, as an index's are."""
    centres = torch.randn(1024, d, device=dev, generator=gen) * 4
    cents = centres[torch.randint(0, 1024, (c,), device=dev, generator=gen)]
    cents = cents + torch.randn(c, d, device=dev, generator=gen)
    q = centres[torch.randint(0, 1024, (b,), device=dev, generator=gen)]
    q = q + torch.randn(b, d, device=dev, generator=gen)
    return q, (q * q).sum(1), cents, (cents * cents).sum(1)


def pair(q, qn, cents, cn, p):
    return topk_rows(q @ cents.T, p, rown=qn, coln=cn, epilogue=EPI_L2)


def _device(fn, calls=20):
    prof = _traced(fn, calls, top=6)
    return {"device_ms": prof["busy_ms"] / calls,
            "kernels": {t["name"][:60]: t["ms"] / calls for t in prof["top"]}}


def case(name, shape, gen, dev):
    b, c, d, p = shape
    q, qn, cents, cn = _data(b, c, d, gen, dev)
    plan = kernels.cell_select_plan(b, c, d, p, kernels._sm_count(dev))
    dk, ik = cell_select_kernel(q, qn, cents, cn, p)
    dp, ip = pair(q, qn, cents, cn, p)
    torch.cuda.synchronize()
    out = {"shape": [b, c, d, p], "plan": plan,
           "ids_apart": float((ik != ip).float().mean()),
           "max_abs_diff": float((dk - dp).abs().max()),
           "max_rel_diff": float(((dk - dp).abs() / dp.abs().clamp_min(1e-6)).max())}
    runs = {"A": lambda: pair(q, qn, cents, cn, p), "B": lambda: cell_select_kernel(q, qn, cents, cn, p)}
    for side in "ABBA":
        fn = runs[side]
        got = {"ms": _median_ms(fn), "loop_ms": _loop_ms(fn), **_device(fn)}
        for k, v in got.items():
            out.setdefault(side, {}).setdefault(k, []).append(v)
    out["library_ms"] = _median_ms(lambda: torch.topk(
        (qn[:, None] + cn[None, :]) - 2.0 * torch.mm(q, cents.T), p, largest=False))
    out.update(_bound(4 * (b * d + c * d + b + c) + 8 * b * p, 2 * b * c * d, FP32_OPS))
    return out


def variant(name, flags):
    """Start nvcc on csrc/cell_select.cu alone with extra flags."""
    out = build.BUILD_DIR / f"cellsel_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC), "-shared",
           "-o", str(out), str(build.CSRC / "cell_select.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(out, proc):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(log)
    lib = ctypes.CDLL(str(out))
    lib.cell_select.argtypes, lib.cell_select.restype = build.SIGNATURES["cell_select"], ctypes.c_int
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines) if "cellsel" in ln and "Compiling entry" in ln]
    return lib, [ln.strip() for i in at for ln in lines[i:i + 4]]


def forced_plan(b, c, mi, per_sm, sms):
    """The plan's segments for a query tile of 16·mi at `per_sm` blocks an SM."""
    qt, nt = -(-b // (16 * mi)), -(-c // kernels.CELLSEL_TC)
    best = None
    for s in range(1, nt + 1):
        tps = -(-nt // s)
        if (s - 1) * tps >= nt:
            continue
        cost = -(-qt * s // (sms * per_sm)) * (tps + kernels._CELLSEL_BLOCK_TILES)
        if best is None or cost < best[0]:
            best = (cost, s)
    return mi, best[1]


def launcher(lib, q, qn, cents, cn, p, force=None):
    """K12 through `lib`'s entry point, as `kernels.cell_select` launches it
    (`force`: (mi, blocks an SM) in place of the plan's query tile)."""
    b, d = q.shape
    c = cents.shape[0]
    sms = kernels._sm_count(q.device)
    mi, s = (kernels.cell_select_plan(b, c, d, p, sms) if force is None
             else forced_plan(b, c, *force, sms))
    out_d = torch.empty((b, p), device=q.device)
    out_i = torch.empty((b, p), dtype=torch.int32, device=q.device)
    part = torch.empty((b, s, p), dtype=torch.int64, device=q.device) if s > 1 else None
    counters = kernels._counters(q.device, -(-b // (16 * mi))) if s > 1 else None
    args = [q.data_ptr(), qn.data_ptr(), cents.data_ptr(), cn.data_ptr(), b, c, d, p, mi, s,
            out_d.data_ptr(), out_i.data_ptr(), kernels._ptr(part), kernels._ptr(counters)]

    def run():
        err = lib.cell_select(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cell_select variant failed: {err}")
        return out_d, out_i
    return run


def real_store(dev):
    """The IVF cells' store and one query set as portbench builds them
    (generators/make_pool.py at configs/sift1m-ivf.json's sizes, IvfIndex's
    defaults): the index's centroids and norms, and 10,000 queries."""
    from portbench.generators.make_pool import generate
    from turdb_tpu_torch.models.ivf import IvfIndex

    gen = torch.Generator(device=dev).manual_seed(2_100_000_017)
    base, queries = generate(gen, dev, n_base=1_000_000, n_queries=10_000, dim=128,
                             store_seed=1_000_000_000_000)
    idx = IvfIndex(dim=128, device=dev)
    idx.add(base.cpu().numpy())
    return idx.state.centroids, idx.state.cnorms, queries.contiguous()


def variants_case(shape, libs, gen, dev, real=None):
    b, c, d, p = shape
    if real is None:
        q, qn, cents, cn = _data(b, c, d, gen, dev)
    else:
        cents, cn, q = real
        qn = (q * q).sum(1)
    runs = {"K12": lambda: cell_select_kernel(q, qn, cents, cn, p)}
    want = runs["K12"]()
    for name, (lib, force) in libs.items():
        runs[name] = launcher(lib, q, qn, cents, cn, p, force)
        got = runs[name]()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    order = [*runs, *reversed(list(runs))]
    out = {}
    for name in order:
        out.setdefault(name, []).append(_loop_ms(runs[name]))
    for name, (lib, _) in libs.items():
        # a variant built with -DCS_CLOCKS: each phase's share of its warps' cycles
        clocks = getattr(lib, "cell_select_clocks", None)
        if clocks is None:
            continue
        clocks.argtypes, clocks.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_ulonglong * 7)()
        clocks(buf)
        runs[name]()
        torch.cuda.synchronize()
        clocks(buf)
        tot = sum(buf[:6]) or 1
        out[f"{name}_phases"] = {
            **{ph: buf[k] / tot for k, ph in enumerate(("wait", "products", "tests", "stores",
                                                        "groups", "emit"))},
            "cycles_a_warp": tot / max(buf[6], 1)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--real", action="store_true",
                    help="time the variants on the IVF cells' own index (nprobe 5 and 8)")
    args = ap.parse_args()
    started, forced = [], {}
    for v in args.variant:
        name, flags = v.split("=", 1)
        flags = flags.split(",")
        # mi=M,sm=N: launch with a query tile of 16·M at N blocks an SM
        opt = dict(f.split("=") for f in flags if f.startswith(("mi=", "sm=")))
        if opt:
            forced[name] = (int(opt["mi"]), int(opt.get("sm", 1)))
        started.append((name, variant(name, [f for f in flags if not f.startswith(("mi=", "sm="))])))
    dev = torch.device("cuda")
    t = time.perf_counter()
    build.library()
    lines = build.build_log.splitlines()
    at = [i for i, ln in enumerate(lines) if "cellsel" in ln and "Compiling entry" in ln]
    report = {"card": torch.cuda.get_device_name(0), "build_s": time.perf_counter() - t,
              "ptxas": [ln.strip() for i in at for ln in lines[i:i + 4]]}
    gen = torch.Generator(device=dev).manual_seed(0)
    if started:
        libs = {}
        for name, (out, proc) in started:
            lib, report[f"ptxas_{name}"] = load(out, proc)
            libs[name] = (lib, forced.get(name))
        if args.real:
            real = real_store(dev)
            for p in (5, 8):
                report[f"variants_real_p{p}"] = variants_case((0, 0, 0, p), libs, gen, dev, real)
                print(json.dumps({f"variants_real_p{p}": report[f"variants_real_p{p}"]}),
                      flush=True)
            del real
            torch.cuda.empty_cache()
        for name in ("r95", "serve_seed", "b256", "b1"):
            report[f"variants_{name}"] = variants_case(SHAPES[name], libs, gen, dev)
            print(json.dumps({f"variants_{name}": report[f"variants_{name}"]}), flush=True)
        print(json.dumps({k: v for k, v in report.items() if k.startswith("ptxas")}), flush=True)
    names = ["r95"] if args.quick else list(SHAPES)
    for name in names:
        report[name] = case(name, SHAPES[name], gen, dev)
        print(json.dumps({name: report[name]}), flush=True)
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "exp_torch_cell_select.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("card", "build_s", "ptxas")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
