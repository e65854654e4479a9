#!/usr/bin/env python3
"""Drive the port's IVF-Flat build-and-query path once on one CUDA card.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit); exits non-zero at
   once without CUDA;
2. builds the hand-written kernels (K1 ivf_probe_f32, K2 topk_rows,
   K3 kmeans_assign) from `turdb_tpu_torch/kernels/csrc` and prints the
   build seconds;
3. kernel phase: each kernel against its plain PyTorch version on the same
   CUDA tensors at the headline shapes, with CUDA-event times;
4. headline phase: the bench's 1M x 128 `make_pool`, the FlatIndex oracle,
   `IvfIndex.add` (auto-train), a second traced build that must equal the
   first bit for bit, a recall@10 sweep over nprobe up to the 0.95 gate,
   and QPS at the gate on batches of 1024 held-out queries;
5. maintenance phase on the 1M index: delete, `allowed` mask, append;
6. checks that the main path launched every kernel; then, outside the
   counted run, traces the search over every batch (device time per
   kernel, device idle share);
7. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failure exits non-zero without the last line. The full report goes to
chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, N_QUERIES, DIM, K = 1_000_000, 16_384, 128, 10
N_ORACLE = 256
BATCH = 1024
PROBES = (2, 4, 5, 6, 8, 16, 32, 64)
RECALL_GATE = 0.95
# headline shapes of the kernels (C after the 1M split cascade, L = cap)
CELLS, LANES = 24_576, 256
K1_PROBE = 5                 # the gate's nprobe in the headline: kernel timings there
FLAT_CHUNK = 131_072
K3_ROWS, K3_CELLS = 1_000_000, 7_812   # 1M rows, n//128 cells (Lloyd's)
# Tolerances. K2 and the epilogues round exactly as the plain version, so
# its values should be bit-equal; 1e-6 relative leaves room for nothing
# else. K1 and K3 sum the d=128 products in another order than cuBLAS:
# fp32 keeps that within 1e-5 of the distance scale (the largest |distance|
# for K1, xn + cn for K3), and ids may differ only inside that band.
K2_RTOL = 1e-6
DOT_RTOL = 1e-5
K3_AGREE = 0.995

OUT = Path("chiprun_out")
REPORT: dict = {}


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def _median_ms(fn, reps=5):
    from turdb_tpu_torch.utils.timing import cuda_median_ms

    return cuda_median_ms(fn, reps=reps, warmup=1)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _selection_error(vals_k, pos_k, vals_p, pos_p, vals_at_pos, rtol, what):
    """Kernel vs plain selection: same values (within rtol of the scale),
    the kernel's positions hold the values it reports, and positions differ
    only where the two values tie exactly. Returns (max abs error, share
    of positions that differ at a tie)."""
    fin = torch.isfinite(vals_p)
    check(torch.equal(fin, torch.isfinite(vals_k)), f"{what}: +inf entries differ")
    scale = float(vals_p[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((vals_k[fin] - vals_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err <= rtol * max(scale, 1.0), f"{what}: max abs err {err} (scale {scale})")
    at = vals_at_pos(pos_k)
    check(bool(((at == vals_k) | ~fin).all()), f"{what}: a position does not hold its value")
    diff = pos_k != pos_p
    check(bool((vals_k[diff] == vals_p[diff]).all()), f"{what}: ids differ away from a tie")
    return err, float(diff.float().mean())


def k2_phase(dev, gen, cells=CELLS, flat_chunk=FLAT_CHUNK):
    from turdb_tpu_torch.kernels import EPI_L2, _row_values, topk_rows, topk_rows_plain

    def compare(x, k, what, **kw):
        vk, pk = topk_rows(x, k, **kw)
        vp, pp = topk_rows_plain(x, k, **kw)
        full = _row_values(x, kw.get("rown"), kw.get("coln"), kw.get("colvalid"),
                           kw.get("epilogue", 0), kw.get("clamp", False))
        return _selection_error(vk, pk, vp, pp, lambda p: torch.gather(full, 1, p.long()),
                                K2_RTOL, what)

    def timed(x, k, **kw):
        return {"ms": _median_ms(lambda: topk_rows(x, k, **kw)),
                "plain_ms": _median_ms(lambda: topk_rows_plain(x, k, **kw))}

    out = {}
    # cell selection: [1024, C] dot matrix, top-nprobe with the unclamped
    # L2 epilogue, at every nprobe of the sweep
    q = torch.randn(BATCH, DIM, device=dev, generator=gen) * 4
    c = torch.randn(cells, DIM, device=dev, generator=gen) * 4
    # a few exact duplicate centroids plant exact ties
    c[1::97] = c[0::97][: c[1::97].shape[0]]
    qn, cn = (q * q).sum(1), (c * c).sum(1)
    dots = q @ c.T
    kw = dict(rown=qn, coln=cn, epilogue=EPI_L2)
    for p in PROBES:
        err, tie_frac = compare(dots, p, f"K2 cell select k={p}", **kw)
        if p in (K1_PROBE, PROBES[-1]):
            out[f"cell_select_k{p}"] = {"shape": [BATCH, cells], "k": p, "max_abs_err": err,
                                        "tie_id_diff": tie_frac, **timed(dots, p, **kw)}
    # flat oracle chunk: [256, 131072], clamped L2 + valid mask, at the
    # oracle's k=10 and at k=50
    qf = q[:N_ORACLE].contiguous()
    xf = torch.randn(flat_chunk, DIM, device=dev, generator=gen) * 4
    valid = torch.rand(flat_chunk, device=dev, generator=gen) < 0.9
    dots = qf @ xf.T
    kw = dict(rown=(qf * qf).sum(1), coln=(xf * xf).sum(1), colvalid=valid,
              epilogue=EPI_L2, clamp=True)
    for kk in (K, 50):
        err, _ = compare(dots, kk, f"K2 flat chunk k={kk}", **kw)
        out[f"flat_chunk_k{kk}"] = {"shape": [N_ORACLE, flat_chunk], "k": kk,
                                    "max_abs_err": err, **timed(dots, kk, **kw)}
    # the oracle's running merge: [256, 2k] -> k. Merging a buffer with
    # itself makes every value an exact tie of two positions.
    best, _ = topk_rows(dots, K, **kw)
    merged = torch.cat([best, best], dim=1)
    err, tie_frac = compare(merged, K, "K2 merge")
    out["merge"] = {"shape": [N_ORACLE, 2 * K], "k": K, "max_abs_err": err,
                    "tie_id_diff": tie_frac, **timed(merged, K)}
    return out


def k1_phase(dev, gen, cells=CELLS, lanes=LANES):
    from turdb_tpu_torch.kernels import ivf_probe_f32, ivf_probe_f32_plain

    # a synthetic packed store at the headline geometry: cells 40-100% full,
    # ids drawn from 4096 values so that copies of an id meet in one probe
    # (as replicas do), 1% tombstones, a 50% allowed mask
    pvecs = torch.randn(cells, lanes, DIM, device=dev, generator=gen)
    occ = torch.randint(lanes * 2 // 5, lanes + 1, (cells, 1), device=dev, generator=gen)
    lane = torch.arange(lanes, device=dev)[None, :]
    members = torch.randint(0, 1 << 12, (cells, lanes), device=dev,
                            generator=gen, dtype=torch.int32)
    members = torch.where(lane < occ, members, -1).to(torch.int32)
    pnorms = torch.where(members >= 0, (pvecs * pvecs).sum(-1), float("inf"))
    alive = torch.rand(cells, lanes, device=dev, generator=gen) < 0.99
    allowed = torch.rand(cells, lanes, device=dev, generator=gen) < 0.5
    q = torch.randn(BATCH, DIM, device=dev, generator=gen)
    qn = (q * q).sum(1)
    out = {}
    for p in (K1_PROBE, 64):
        top = torch.rand(BATCH, cells, device=dev, generator=gen).topk(p).indices.to(torch.int32)
        for metric in (0, 1, 2):
            for replicated, allow in ((True, None), (False, None), (True, allowed)):
                m = min(2 * K, p * lanes) if replicated else K
                args = (q, qn, top, pvecs, pnorms, members, alive, allow)
                kw = dict(metric=metric, k=K, m=m, replicated=replicated)
                dk, ik = ivf_probe_f32(*args, **kw)
                dp, ip = ivf_probe_f32_plain(*args, **kw)
                what = f"K1 P={p} metric={metric} replicated={replicated} allowed={allow is not None}"
                fin = torch.isfinite(dp)
                check(torch.equal(fin, torch.isfinite(dk)), f"{what}: +inf entries differ")
                scale = max(float(dp[fin].abs().max()), 1.0)
                err = float((dk[fin] - dp[fin]).abs().max())
                check(err <= DOT_RTOL * scale, f"{what}: max abs err {err}")
                # ids may differ only where the two distances are within
                # the summation-order tolerance (near ties)
                close = (dk - dp).abs() <= DOT_RTOL * scale
                check(bool(((ik == ip) | close | ~fin).all()), f"{what}: ids differ")
                if p == K1_PROBE and metric == 0 and replicated and allow is None:
                    out.update(
                        shape={"B": BATCH, "P": p, "L": lanes, "d": DIM, "C": cells},
                        k=K, m=m, max_abs_err=err,
                        id_diff=float(((ik != ip) & fin).float().mean()),
                        ms=_median_ms(lambda: ivf_probe_f32(*args, **kw)),
                        plain_ms=_median_ms(lambda: ivf_probe_f32_plain(*args, **kw)),
                    )
    return out


def k3_phase(dev, gen, rows=K3_ROWS, cells=K3_CELLS, cells_r2=CELLS):
    from turdb_tpu_torch.kernels import kmeans_assign, kmeans_assign_plain

    centers = torch.randn(1024, DIM, device=dev, generator=gen) * 4
    pick = torch.randint(0, 1024, (rows,), device=dev, generator=gen)
    x = centers[pick] + torch.randn(rows, DIM, device=dev, generator=gen)
    xn = (x * x).sum(1)

    def agree(n_cells, r):
        cents = x[torch.randperm(rows, device=dev, generator=gen)[:n_cells]].contiguous()
        cn = (cents * cents).sum(1)
        args = (x, cents, xn, cn, r)
        ik, dk = kmeans_assign(*args)
        ip, dp = kmeans_assign_plain(*args)
        same = (ik == ip).all(1)
        frac = float(same.float().mean())
        check(frac >= K3_AGREE, f"K3 r={r} C={n_cells}: agreement {frac}")
        # every disagreement is a near tie: the plain distance of the
        # kernel's pick is within tolerance of the plain best
        xb, cb = x.bfloat16().float(), cents.bfloat16().float()
        at = (xn[:, None] + cn[ik.long()]) - 2.0 * torch.einsum(
            "nd,nrd->nr", xb, cb[ik.long()])
        tol = DOT_RTOL * (xn[:, None] + cn[ip.long()]).abs()
        check(bool(((at - dp).abs() <= tol).all()), f"K3 r={r}: a disagreement is no near tie")
        del at, xb, cb
        return {
            "shape": {"n": rows, "C": n_cells, "d": DIM, "r": r}, "agreement": frac,
            "max_abs_err": float((dk[same] - dp[same]).abs().max()),
            "ms": _median_ms(lambda: kmeans_assign(*args)),
            "plain_ms": _median_ms(lambda: kmeans_assign_plain(*args)),
        }

    # Lloyd's first pass (r=1, C = 8192) and the replica placement's top-2
    # over every row at the post-split cell count
    out = agree(cells, 1)
    out["top2"] = agree(cells_r2, 2)
    return out


# ---------------------------------------------------------------------------
# headline and maintenance phases
# ---------------------------------------------------------------------------

def headline_phase(dev, n=N, n_queries=N_QUERIES):
    from turdb_tpu_torch.models.flat import FlatIndex
    from turdb_tpu_torch.models.ivf import IvfIndex
    from turdb_tpu_torch.utils.datasets import make_pool, recall_of

    t = time.perf_counter()
    pool = make_pool(np.random.default_rng(0), n + n_queries, DIM)
    x, queries = pool[:n], pool[n:]
    out = {"pool_s": time.perf_counter() - t}

    t = time.perf_counter()
    flat = FlatIndex(dim=DIM, capacity=len(x), device=dev)
    flat.add(x)
    _, truth = flat.search(queries[:N_ORACLE], k=K)
    out["oracle_s"] = time.perf_counter() - t
    del flat
    check(bool((truth >= 0).all()), "oracle returned empty slots")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = IvfIndex(dim=DIM, device=dev)
    idx.add(x)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    out["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["C"], out["L"] = idx.cfg.n_clusters, idx.cfg.cluster_cap
    out["replicated"] = idx.cfg.replicated
    log(f"build: {out['build_s']:.3f} s  C={out['C']} L={out['L']}  "
        f"peak {out['build_peak_gib']:.3f} GiB")

    # the same seed builds the same index: a second build, traced, must
    # equal the first bit for bit
    from turdb_tpu_torch.utils.timing import device_profile

    again = IvfIndex(dim=DIM, device=dev)
    out["build_profile"] = device_profile(lambda: again.add(x))
    same = again.cfg == idx.cfg and all(
        torch.equal(a, b) for a, b in zip(again.state, idx.state))
    out["rebuild_identical"] = same
    log(f"rebuild: C={again.cfg.n_clusters} identical={same}; "
        f"device profile {json.dumps(out['build_profile'])}")
    check(same, "a second build from the same seed differs from the first")
    del again
    torch.cuda.empty_cache()

    sweep, gate = [], None
    for p in PROBES:
        _, ids = idx.search(queries[:N_ORACLE], K, nprobe=p)
        r = recall_of(ids, truth)
        sweep.append({"nprobe": p, "recall@10": r})
        log(f"  nprobe={p:3d} recall@10={r:.4f}")
        if r >= RECALL_GATE:
            gate = p
            break
    out["sweep"] = sweep
    check(gate is not None, f"recall gate {RECALL_GATE} not reached by nprobe {PROBES[-1]}")
    out["gate_nprobe"] = gate

    qd = torch.as_tensor(queries, device=dev)
    batches = [qd[s:s + BATCH] for s in range(0, len(qd) - BATCH + 1, BATCH)]
    d, i = idx.search(batches[0], K, nprobe=gate, out="torch")
    check(tuple(d.shape) == (BATCH, K) and tuple(i.shape) == (BATCH, K), "search shape")
    check(bool(torch.isfinite(d).all()) and bool(((i >= 0) & (i < n)).all()),
          "search returned non-finite distances or out-of-range ids")

    def run():
        for b in batches:
            idx.search(b, K, nprobe=gate, out="torch")

    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(run)
    out["search_ms_per_batch"] = ms / len(batches)
    out["qps"] = len(batches) * BATCH / (ms / 1e3)
    out["search_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"search at nprobe={gate}: {out['qps']:.1f} QPS "
        f"({out['search_ms_per_batch']:.4f} ms / batch of {BATCH}), "
        f"peak {out['search_peak_gib']:.3f} GiB")
    return out, idx, queries, batches


def maintenance_phase(idx, queries, gate, n=N, n_append=10_000):
    rng = np.random.default_rng(1)
    out = {}
    # delete: the top hits of 1000 held-out queries, topped up to 1000 slots
    _, ids0 = idx.search(queries[:1000], K, nprobe=gate)
    dele = np.unique(ids0[:, 0][ids0[:, 0] >= 0])
    extra = rng.choice(np.setdiff1d(np.arange(n), dele), 1000 - len(dele), replace=False)
    dele = np.concatenate([dele, extra])
    idx.delete(dele)
    _, ids1 = idx.search(queries[:1000], K, nprobe=gate)
    check(not np.isin(ids1, dele).any(), "a deleted slot came back")
    out["deleted"] = len(dele)

    allowed = rng.random(n) < 0.5
    _, ids2 = idx.search(queries[:N_ORACLE], K, nprobe=gate, allowed=allowed)
    got = ids2[ids2 >= 0]
    check(len(got) > 0, "allowed search returned nothing")
    check(bool(allowed[got].all()), "a slot outside the allowed mask came back")
    check(not np.isin(got, dele).any(), "a deleted slot came back under a mask")
    out["allowed_hits"] = int(len(got))

    new = queries[-n_append:]
    slots = idx.add(new)
    _, ids3 = idx.search(new, K, nprobe=gate)
    found = float((ids3 == slots[:, None]).any(1).mean())
    out["appended"], out["append_found"] = len(slots), found
    check(found >= 0.999, f"only {found} of the appended rows found by their own query")
    log(f"maintenance: deleted {len(dele)} (none returned), allowed-only hits "
        f"{len(got)}, appended {len(slots)} found {found}")
    return out


# ---------------------------------------------------------------------------

KERNELS = {
    "ivf_probe_f32": ("turdb_tpu_torch/kernels/csrc/ivf_probe.cu",
                      "turdb_tpu/models/ivf.py:286"),
    "topk_rows": ("turdb_tpu_torch/kernels/csrc/topk_rows.cu",
                  "turdb_tpu/ops/topk.py:45"),
    "kmeans_assign": ("turdb_tpu_torch/kernels/csrc/kmeans_assign.cu",
                      "turdb_tpu/models/ivf.py:117"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(card)
    REPORT["card"] = card
    OUT.mkdir(exist_ok=True)

    from turdb_tpu_torch import kernels
    from turdb_tpu_torch.kernels import build

    t = time.perf_counter()
    build.library()
    REPORT["build_kernels_s"] = time.perf_counter() - t
    (OUT / "ptxas.txt").write_text(build.build_log)
    log(f"kernels built in {REPORT['build_kernels_s']:.3f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    try:
        REPORT["k2"] = k2_phase(dev, gen)
        REPORT["k1"] = k1_phase(dev, gen)
        REPORT["k3"] = k3_phase(dev, gen)
        for name in ("k1", "k2", "k3"):
            log(f"{name}: {json.dumps(REPORT[name])}")
        torch.cuda.empty_cache()

        kernels.reset_launches()
        REPORT["headline"], idx, queries, batches = headline_phase(dev)
        gate = REPORT["headline"]["gate_nprobe"]
        REPORT["maintenance"] = maintenance_phase(idx, queries, gate)
        launches = dict(kernels.launches)
        REPORT["launches"] = launches
        log(f"launches on the main path: {json.dumps(launches)}")
        check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
        # after the counts: the trace of a run over every search batch
        # calls the kernels outside the main path (on the index after
        # maintenance)
        from turdb_tpu_torch.utils.timing import device_profile

        REPORT["search_profile"] = device_profile(
            lambda: [idx.search(b, K, nprobe=gate, out="torch") for b in batches])
        log(f"search profile: {json.dumps(REPORT['search_profile'])}")
    except SmokeFailure as e:
        REPORT["failure"] = str(e)
        (OUT / "chip_smoke_report.json").write_text(json.dumps(REPORT, indent=1))
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    (OUT / "chip_smoke_report.json").write_text(json.dumps(REPORT, indent=1))
    log(f"headline: {json.dumps(REPORT['headline'])}")

    timed = {
        "ivf_probe_f32": REPORT["k1"],
        "topk_rows": REPORT["k2"][f"cell_select_k{K1_PROBE}"],
        "kmeans_assign": REPORT["k3"],
    }
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": timed[name]["max_abs_err"],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
