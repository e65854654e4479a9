"""`replica_rank = 2` (each row may replicate into its two runner-up
cells; `copies` = 3 a slot), the port's IvfIndex against the reference's
on the CPU.

Both build on the same clustered pool (make_pool 20k x 32, as
tests/test_torch_slice.py) at rank 2 and must agree as the slice test holds
rank 1: recall@10 at nprobe 3 and 8 within 0.02, real cell counts within
10 %.
The replica waves fill the cells' spare lanes with runner-up copies
(docs/PERF.md, "SOAR multi-rank replicas": lane-fill 0.356 at rank 1,
0.397 at rank 2 on the 1M headline): the lane-fill, the copies a slot
holds and each index's gain over its own rank-1 build agree within the
same bounds. On one exported reference state the port's search answers
as the reference's (ids equal up to exact-tie order), where a slot's three
copies meet in one probe and the dedup widens to copies * k.
"""

import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_ivf

import jax.numpy as jnp

from turdb_tpu.models import ivf as jivf
from turdb_tpu.models.ivf import IvfIndex as JaxIvf
from turdb_tpu_torch.convert import ivf_state_from_numpy
from turdb_tpu_torch.models import ivf as tivf
from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.utils.datasets import make_pool, recall_of as recall

torch.set_num_threads(1)

N, NQ, DIM, K, NPROBE = 20_000, 256, 32, 10, 8


@pytest.fixture(scope="module")
def built():
    pool = make_pool(np.random.default_rng(0), N + NQ, DIM, n_clusters=64)
    x, q = pool[:N], pool[N:]
    flat = FlatIndex(dim=DIM, capacity=N, device="cpu")
    flat.add(x)
    _, truth = flat.search(q, k=K)
    out = {}
    for rank in (1, 2):
        ref = JaxIvf(dim=DIM, replica_rank=rank)
        ref.add(x)
        port = IvfIndex(dim=DIM, replica_rank=rank, device="cpu")
        port.add(x)
        out[rank] = ref, port
    return out, q, truth


def _copies(members, n):
    """Physical copies of each of the n slots in a [C, L] members array."""
    m = np.asarray(members).reshape(-1)
    return np.bincount(m[m >= 0], minlength=n)


def test_rank2_builds_and_answers_as_the_reference(built):
    out, q, truth = built
    ref, port = out[2]
    assert ref.cfg.replicated and port.cfg.replicated
    assert port.cfg.copies == ref.cfg.copies == 3
    assert port.cfg.cluster_cap == ref.cfg.cluster_cap
    ref_cells = int(np.isfinite(np.asarray(ref.state.cnorms)).sum())
    assert abs(port.cfg.n_clusters - ref_cells) <= 0.1 * ref_cells
    rec = {}
    for nprobe in (3, NPROBE):
        for rank in (1, 2):
            r, p = out[rank]
            rec[rank, nprobe] = (recall(r.search(q, k=K, nprobe=nprobe)[1], truth),
                                 recall(p.search(q, k=K, nprobe=nprobe)[1], truth))
            assert abs(rec[rank, nprobe][1] - rec[rank, nprobe][0]) <= 0.02, rec
    # at nprobe 3 (recall under 1) each index's own gain from the second
    # rank agrees too
    gain = [rec[2, 3][i] - rec[1, 3][i] for i in (0, 1)]
    assert abs(gain[1] - gain[0]) <= 0.02, rec


def test_rank2_occupancy_and_copies_match_the_reference(built):
    out, _, _ = built
    stats = {}
    for rank in (1, 2):
        for side, idx in zip(("ref", "port"), out[rank]):
            # the real cells (the reference pads its cell count with empty
            # cells, cnorms +inf)
            real = np.isfinite(np.asarray(idx.state.cnorms))
            members = np.asarray(idx.state.members)[real]
            copies = _copies(members, N)
            stats[rank, side] = {"fill": float((members >= 0).mean()),
                                 "copies": float(copies.mean()), "max": int(copies.max()),
                                 "slots": int((copies > 0).sum())}
    for side in ("ref", "port"):
        assert stats[2, side]["slots"] == N                    # every row kept
        assert stats[2, side]["max"] <= 3                      # 1 + replica_rank
        # the runner-up waves add copies, and so lane-fill
        assert stats[2, side]["copies"] > stats[1, side]["copies"]
        assert stats[2, side]["fill"] > stats[1, side]["fill"]
    for rank in (1, 2):
        r, p = stats[rank, "ref"], stats[rank, "port"]
        assert abs(p["fill"] - r["fill"]) <= 0.1 * r["fill"], stats
        assert abs(p["copies"] - r["copies"]) <= 0.1 * r["copies"], stats


def test_rank2_search_on_one_exported_state(built):
    out, q, _ = built
    ref, _ = out[2]
    arrays, conf = export_ivf(ref.state, ref.cfg)
    assert conf["copies"] == 3
    state, cfg = ivf_state_from_numpy(arrays, conf, "cpu")
    for nprobe in (4, NPROBE):
        want = jivf.ivf_search_impl(ref.state, jnp.asarray(q), None, cfg=ref.cfg, k=K,
                                    nprobe=nprobe)
        got = tivf.ivf_search_impl(state, torch.from_numpy(q), None, cfg=cfg, k=K,
                                   nprobe=nprobe)
        wd, wi = (np.asarray(a) for a in want)
        gd, gi = (a.numpy() for a in got)
        fin = np.isfinite(wd)
        assert_knn_match(wd, np.where(fin, wi, -1), gd, gi)
        # the dedup leaves no id twice in a row
        for row in gi:
            ids = row[row >= 0]
            assert len(set(ids.tolist())) == len(ids)
