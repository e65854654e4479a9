"""The mesh in the port (turdb_tpu_torch/parallel/) against the JAX
reference (turdb_tpu/parallel/): the cases of tests/test_sharded.py on a
mesh of eight CPU devices, the same answers on the reference's exported
stacked states, a 1-shard mesh against the plain index, and the kernel
launch's device."""

import numpy as np
import pytest
import torch
from torch_parity import assert_knn_match, export_sharded_hnsw, export_sharded_ivf

from turdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from turdb_tpu.parallel.sharded import ShardedHnswIndex as JaxShardedHnsw
from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex as JaxShardedIvf
from turdb_tpu_torch import kernels
from turdb_tpu_torch.convert import sharded_hnsw_from_numpy, sharded_ivf_from_numpy
from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.ivf import IvfIndex
from turdb_tpu_torch.parallel import (
    ShardedHnswIndex,
    ShardedIvfIndex,
    make_mesh,
    make_multihost_mesh,
)
from turdb_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPUS = [torch.device("cpu")] * 8


def recall_at_k(pred, true):
    return sum(len(set(p[p >= 0]) & set(t)) for p, t in zip(pred, true)) / true.size


def _pred(gids, gi):
    lut = {int(g): i for i, g in enumerate(gids)}
    return np.array([[lut.get(int(g), -1) for g in row] for row in gi])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(99)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    flat = FlatIndex(dim=32, capacity=3000, device="cpu")
    flat.add(x)
    _, true_ids = flat.search(q, k=10)
    return x, q, true_ids


@pytest.fixture(scope="module")
def hnsw4(data):
    """A 4-shard (data 2) graph index built by waves, shared by the
    read-only cases."""
    x, _, _ = data
    idx = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=4, n_data=2, devices=CPUS),
                           ef_construction=64)
    return idx, idx.add(x)


def test_sharded_recall_4shards(data, hnsw4):
    x, q, true_ids = data
    idx, gids = hnsw4
    assert len(idx) == 3000
    d, gi = idx.search(q, k=10, ef=64)
    assert gi.dtype == np.int64
    assert recall_at_k(_pred(gids, gi), true_ids) >= 0.93
    assert (d[:, 0] <= d[:, -1]).all()


def test_sharded_serve_pack(data, hnsw4):
    """The serving packs and the merge; then deletes and an add (this case
    runs after the read-only ones on the shared index)."""
    x, q, true_ids = data
    idx, gids = hnsw4
    idx.pack_serving()
    d, gi = idx.search_serve(q, k=10, ef=48)
    assert recall_at_k(_pred(gids, gi), true_ids) >= 0.9
    assert (d[:, 0] <= d[:, -1]).all()
    # tombstoned rows never surface through the filtered serve path
    idx.delete(gids[:1500])
    _, gi2 = idx.search_serve(q, k=10, ef=48)
    assert not np.isin(gi2, gids[:1500]).any()
    # graph mutation invalidates the pack
    idx.add(x[:8])
    assert idx._serve is None


def test_sharded_balances(data):
    x, _, _ = data
    idx = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=8, n_data=1, devices=CPUS),
                           ef_construction=32)
    idx.add(x[:1000])
    assert idx.sizes.sum() == 1000
    assert idx.sizes.max() - idx.sizes.min() <= 1


def test_sharded_delete(data):
    x, _, _ = data
    idx = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=2, n_data=1, devices=CPUS),
                           ef_construction=32)
    gids = idx.add(x[:500])
    _, gi = idx.search(x[:3], k=1)
    assert gi[:, 0].tolist() == gids[:3].tolist()
    idx.delete(gids[:3])
    _, gi2 = idx.search(x[:3], k=1)
    assert not np.isin(gi2[:, 0], gids[:3]).any()


def test_sharded_ivf(data):
    x, q, true_ids = data
    idx = ShardedIvfIndex(dim=32, mesh=make_mesh(n_db=4, n_data=2, devices=CPUS), nprobe=16)
    gids = idx.add(x)
    idx.train()
    assert len(idx) == 3000
    d, gi = idx.search(q, k=10)
    assert recall_at_k(_pred(gids, gi), true_ids) >= 0.9
    assert (d[:, 0] <= d[:, -1]).all()


def test_sharded_ivf_compact_store(data):
    x, q, true_ids = data
    idx = ShardedIvfIndex(dim=32, mesh=make_mesh(n_db=4, n_data=2, devices=CPUS), nprobe=16,
                          sq8=True, keep_f32=False)
    gids = idx.add(x)
    idx.train()
    assert all(s.state.pvecs.dtype == torch.int16 for s in idx.shards)   # SQ16 bits
    _, gi = idx.search(q, k=10)
    assert recall_at_k(_pred(gids, gi), true_ids) >= 0.9


def test_gid_stability_across_growth(data):
    x, _, _ = data
    rng = np.random.default_rng(7)
    idx = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=2, n_data=1, devices=CPUS),
                           ef_construction=32, capacity_per_shard=1024)
    gids = idx.add(x[:600])
    cap0 = idx.capacity
    more = np.repeat(x[:300], 8, axis=0) + rng.standard_normal((2400, 32)).astype(np.float32)
    idx.add(more)
    assert idx.capacity > cap0
    assert len({s.capacity for s in idx.shards}) == 1
    _, gi = idx.search(x[:5], k=1)
    assert gi[:, 0].tolist() == gids[:5].tolist(), "stored gid no longer matches"


def test_multihost_two_level_merge(data):
    x, q, true_ids = data
    mesh = make_multihost_mesh(n_host=2, n_db=2, n_data=2, devices=CPUS)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=64)
    assert idx.n_shards == 4
    gids = idx.add(x)
    _, gi = idx.search(q, k=10, ef=64)
    assert recall_at_k(_pred(gids, gi), true_ids) >= 0.93
    ivf = ShardedIvfIndex(dim=32, mesh=mesh, nprobe=16)
    g2 = ivf.add(x)
    ivf.train()
    _, gi2 = ivf.search(q, k=10)
    assert recall_at_k(_pred(g2, gi2), true_ids) >= 0.9


def test_mesh_parallel_train_recall(data, monkeypatch):
    """The mesh build (`_train_mesh`: shared geometry, seeds from one
    default_rng(0), each shard's k-means on its device, then
    `IvfIndex.train(_pre=...)`). Shards large enough train themselves as
    rows arrive, so the rows are staged untrained here, as small adds
    leave them."""
    x, q, truth_pos = data
    real_train, real_mesh = IvfIndex.train, ShardedIvfIndex._train_mesh
    monkeypatch.setattr(IvfIndex, "train", lambda self, *a, **kw: None)
    idx = ShardedIvfIndex(dim=32, mesh=make_mesh(n_db=4, n_data=2, devices=CPUS), nprobe=16)
    gids = idx.add(x)
    assert all(s.state is None for s in idx.shards)
    monkeypatch.setattr(IvfIndex, "train", real_train)
    calls = []
    monkeypatch.setattr(ShardedIvfIndex, "_train_mesh",
                        lambda self: (calls.append(1), real_mesh(self)))
    idx.train()
    assert calls and all(s.state is not None for s in idx.shards)
    assert len({(s.cfg.n_clusters, s.cfg.cluster_cap) for s in idx.shards}) == 1
    _, g = idx.search(q, k=10)
    truth_g = gids[truth_pos]
    rec = np.mean([len(set(g[i].tolist()) & set(truth_g[i].tolist())) / 10
                   for i in range(len(q))])
    assert rec >= 0.9, rec


def test_sharded_bulk_build_recall(monkeypatch):
    """The bulk route per shard at n >= S * 8192 rows (here S = 2, with
    the bulk build's exact route lowered so that the self-probe runs)."""
    from turdb_tpu_torch.models import hnsw as thnsw

    monkeypatch.setattr(thnsw, "_BULK_EXACT", 4096)
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 4.0
    n = 2 * 8192
    x = (centers[rng.integers(0, 64, n)] + rng.standard_normal((n, 32)).astype(np.float32))
    q = (centers[rng.integers(0, 64, 48)] + rng.standard_normal((48, 32)).astype(np.float32))
    flat = FlatIndex(dim=32, capacity=n, device="cpu")
    flat.add(x)
    _, truth = flat.search(q, k=10)
    idx = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=2, n_data=2, devices=CPUS),
                           capacity_per_shard=8192 + 16)
    gids = idx.add(x)
    assert idx._descent_ef == 32            # the bulk path ran
    _, g = idx.search(q, k=10, ef=96)
    truth_g = gids[truth]
    rec = np.mean([len(set(g[i].tolist()) & set(truth_g[i].tolist())) / 10
                   for i in range(len(q))])
    assert rec >= 0.9, rec


# --- the same states as the reference --------------------------------------

@pytest.mark.parametrize("sq8", [False, True])
def test_sharded_ivf_search_on_the_reference_state(data, sq8):
    """The reference's stacked shards, split into the port's list: the
    merged answers are the reference's (ids equal but at ties, distances
    within 1e-4 relative / 1e-3 absolute)."""
    x, q, _ = data
    ref = JaxShardedIvf(dim=32, mesh=jax_make_mesh(n_db=4, n_data=2), nprobe=16, sq8=sq8,
                        keep_f32=not sq8)
    ref.add(x)
    arrays, conf, sizes = export_sharded_ivf(ref)
    port = sharded_ivf_from_numpy(arrays, conf, make_mesh(n_db=4, n_data=2, devices=CPUS),
                                  sizes)
    assert port.id_stride == ref.id_stride and len(port) == len(ref)
    d_ref, i_ref = ref.search(q[:30], k=10)       # 30 queries: the data axis pads them
    d, i = port.search(q[:30], k=10)
    assert_knn_match(d_ref, i_ref, d, i)


@pytest.fixture(scope="module")
def ref_hnsw(data):
    x, _, _ = data
    ref = JaxShardedHnsw(dim=32, mesh=jax_make_mesh(n_db=4, n_data=2), ef_construction=48)
    gids = ref.add(x[:2000])
    return ref, gids


def test_sharded_hnsw_search_on_the_reference_state(data, ref_hnsw):
    _, q, _ = data
    ref, gids = ref_hnsw
    arrays, conf, _ = export_sharded_hnsw(ref)
    mesh = make_mesh(n_db=4, n_data=2, devices=CPUS)
    port = sharded_hnsw_from_numpy(arrays, conf, ref.sizes, mesh, alive=ref._alive)
    assert port.id_stride == ref.id_stride
    for allowed in (None, np.random.default_rng(4).random(ref._alive.shape) < 0.7):
        d_ref, i_ref = ref.search(q, k=10, ef=64, allowed=allowed)
        d, i = port.search(q, k=10, ef=64, allowed=allowed)
        assert_knn_match(d_ref, i_ref, d, i)


def test_sharded_serve_on_the_reference_pack(data, ref_hnsw):
    _, q, _ = data
    ref, gids = ref_hnsw
    ref.pack_serving()
    arrays, conf, serve = export_sharded_hnsw(ref)
    port = sharded_hnsw_from_numpy(arrays, conf, ref.sizes,
                                   make_mesh(n_db=4, n_data=2, devices=CPUS),
                                   alive=ref._alive, serve=serve)
    d_ref, i_ref = ref.search_serve(q, k=10, ef=48)
    d, i = port.search_serve(q, k=10, ef=48)
    assert_knn_match(d_ref, i_ref, d, i)


def test_sharded_builds_agree_with_the_reference(data, ref_hnsw):
    """Builds are held on quality: the port's own 4-shard wave build
    reaches the reference's recall (within 0.02) on the same rows."""
    x, q, _ = data
    ref, rgids = ref_hnsw
    port = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=4, n_data=2, devices=CPUS),
                            ef_construction=48)
    pgids = port.add(x[:2000])
    np.testing.assert_array_equal(pgids, rgids)    # the same routing and packing
    np.testing.assert_array_equal(port.sizes, ref.sizes)
    flat = FlatIndex(dim=32, capacity=2000, device="cpu")
    flat.add(x[:2000])
    _, truth = flat.search(q, k=10)
    r_ref = recall_at_k(_pred(rgids, ref.search(q, k=10, ef=64)[1]), truth)
    r_port = recall_at_k(_pred(pgids, port.search(q, k=10, ef=64)[1]), truth)
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)


# --- one shard, the merge, the mesh, the launch device ---------------------

def test_one_shard_mesh_answers_as_the_plain_index(data):
    x, q, _ = data
    mesh = make_mesh(n_db=1, devices=CPUS[:1])
    sharded = ShardedIvfIndex(dim=32, mesh=mesh, nprobe=8)
    gids = sharded.add(x)
    plain = IvfIndex(dim=32, nprobe=8, device="cpu")
    plain.add(x)
    np.testing.assert_array_equal(gids, np.arange(3000))
    d_s, i_s = sharded.search(q, k=10)
    d_p, i_p = plain.search(q, k=10)
    np.testing.assert_array_equal(i_s, i_p)
    np.testing.assert_array_equal(d_s, d_p)


def test_two_level_merge_is_a_topk_of_the_gathered_rows():
    from turdb_tpu_torch.parallel.sharded import _two_level_merge

    rng = np.random.default_rng(8)
    ds = [torch.from_numpy(np.sort(rng.random((6, 5)).astype(np.float32), 1)) for _ in range(4)]
    ds[2][0, :] = ds[1][0, :]                                # a tie across shards
    gis = [torch.arange(5)[None].repeat(6, 1) + 100 * s for s in range(4)]
    for n_host in (1, 2):
        d, gi = _two_level_merge(ds, gis, 5, n_host, torch.device("cpu"))
        all_d = torch.cat(ds, 1)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :5]
        np.testing.assert_array_equal(d.numpy(), torch.gather(all_d, 1, order).numpy())
        np.testing.assert_array_equal(gi.numpy(), torch.gather(torch.cat(gis, 1), 1, order))


def test_mesh_shape_and_devices():
    m = make_multihost_mesh(n_host=2, n_db=2, n_data=2, devices=CPUS)
    assert m.shape == {"host": 2, "data": 2, "db": 2}
    assert len(m.shard_devices()) == 4
    with pytest.raises(ValueError):
        make_mesh(n_db=5, n_data=2, devices=CPUS)


def test_mesh_needs_a_cuda_device_unless_given_devices(monkeypatch):
    monkeypatch.setattr(pmesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(n_db=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_multihost_mesh(n_host=1, n_db=1)
    assert make_mesh(n_db=2, devices=CPUS).shape == {"data": 1, "db": 2}


def test_launch_runs_on_the_device_of_its_tensors(monkeypatch):
    """A kernel launch selects its tensors' device and that device's
    stream, not whichever device is current (a mesh keeps shards on
    several cards); it makes the device current only when it is not, and
    looks the C entry point up once."""
    seen, lookups = [], []

    class FakeLib:
        def __getattr__(self, name):
            lookups.append(name)
            return lambda *args: seen.append(("launch", args[-1])) or 0

    class DeviceGuard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    monkeypatch.setattr(kernels.build, "library", lambda: FakeLib())
    monkeypatch.setattr(kernels, "_entry", {})
    monkeypatch.setattr(kernels.torch.cuda, "device", DeviceGuard)
    monkeypatch.setattr(kernels.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernels.torch._C, "_cuda_getCurrentRawStream",
                        lambda index: f"stream-of-cuda:{index}", raising=False)
    before = kernels.launches["topk_rows"]
    kernels._launch("topk_rows", torch.device("cuda", 3), 1, 2)
    assert seen == [("enter", 3), ("launch", "stream-of-cuda:3"), ("exit", 3)]
    seen.clear()
    kernels._launch("topk_rows", torch.device("cuda", 0), 1, 2)
    kernels._launch("topk_rows", torch.device("cuda"), 1, 2)
    assert seen == [("launch", "stream-of-cuda:0")] * 2
    assert lookups == ["topk_rows"]
    assert kernels.launches["topk_rows"] == before + 3
    kernels.launches["topk_rows"] = before
    with pytest.raises(ValueError, match="one cuda device"):
        kernels._on_cuda(FakeCuda(0), FakeCuda(1))


# --- the data axis -----------------------------------------------------------

def _spy(monkeypatch, module, name):
    """Record (state, queries) of each call of module.name."""
    calls, real = [], getattr(module, name)

    def spy(state, q, *a, **kw):
        calls.append((state, q.clone()))
        return real(state, q, *a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _one_row_twin(idx, cls, **kw):
    """The same shards behind a (data 1) mesh of the same db devices."""
    twin = cls(dim=32, mesh=make_mesh(n_db=idx.n_db, n_data=1, devices=CPUS), **kw)
    twin.shards = idx.shards
    for attr in ("_cfg", "cfg", "capacity", "_descent_ef", "_serve"):
        if hasattr(idx, attr):
            setattr(twin, attr, getattr(idx, attr))
    return twin


@pytest.mark.parametrize("copies", ["shared", "real"])
def test_data_axis_splits_the_batch_over_row_copies(data, monkeypatch, copies):
    """A (data 2, db 2) mesh: each data row holds a copy of every shard
    (the same tensors where the row's device is row 0's, as on this CPU
    list; real copies when the devices differ, forced here), row r's
    copies get slice r of the padded batch, and the answers equal those of
    the (data 1, db 2) mesh over the same shards, bit for bit. After an
    add or a delete, row 1's copies answer with the new rows."""
    from turdb_tpu_torch.parallel import sharded, sharded_ivf

    if copies == "real":
        monkeypatch.setattr(sharded, "_same_memory", lambda a, b: False)
    x, q, _ = data
    q = q[:31]                                     # odd: the data axis pads it
    two = ShardedIvfIndex(dim=32, mesh=make_mesh(n_db=2, n_data=2, devices=CPUS), nprobe=16)
    two.add(x[:2000])
    two.train()
    one = _one_row_twin(two, ShardedIvfIndex, nprobe=16)
    calls = _spy(monkeypatch, sharded_ivf, "ivf_search_impl")
    d2, g2 = two.search(q, k=10)
    padded = np.concatenate([q, np.zeros((1, 32), np.float32)])
    assert len(calls) == 4
    for c, (state, qs) in enumerate(calls):
        r, s = divmod(c, 2)
        np.testing.assert_array_equal(qs.numpy(), padded[r * 16:(r + 1) * 16])
        own = two.shards[s].state
        assert (state is own) == (r == 0 or copies == "shared")
        assert torch.equal(state.pvecs, own.pvecs)
        if copies == "real" and r == 1:
            assert state.pvecs.data_ptr() != own.pvecs.data_ptr()
    d1, g1 = one.search(q, k=10)
    np.testing.assert_array_equal(g2, g1)
    np.testing.assert_array_equal(d2, d1)
    # an append lands on row 0; row 1's copies see it before the next search
    new = two.add(q[16:31] + 1e-3)
    _, gn = two.search(q, k=1)
    np.testing.assert_array_equal(gn[16:31, 0], new)

    hn = ShardedHnswIndex(dim=32, mesh=make_mesh(n_db=2, n_data=2, devices=CPUS),
                          ef_construction=32)
    gids = hn.add(x[:1200])
    hn_one = _one_row_twin(hn, ShardedHnswIndex, ef_construction=32)
    hcalls = _spy(monkeypatch, sharded, "hnsw_search_impl")
    d2, g2 = hn.search(q, k=10, ef=48)
    assert [qs.shape[0] for _, qs in hcalls] == [16] * 4
    np.testing.assert_array_equal(hcalls[2][1].numpy(), padded[16:])
    d1, g1 = hn_one.search(q, k=10, ef=48)
    np.testing.assert_array_equal(g2, g1)
    np.testing.assert_array_equal(d2, d1)
    hn.pack_serving()
    hn_one._serve = hn._serve
    np.testing.assert_array_equal(hn.search_serve(q, k=10, ef=48)[1],
                                  hn_one.search_serve(q, k=10, ef=48)[1])
    # a delete: the deleted rows leave row 1's answers too
    _, first = hn.search(x[:32], k=1, ef=48)
    hn.delete(first[16:, 0])
    _, after = hn.search(x[:32], k=1, ef=48)
    assert not np.isin(after[16:, 0], first[16:, 0]).any()
    assert hn.add(x[1200:1210]).shape == (10,)
    _, found = hn.search(x[1200:1210], k=1, ef=48)
    assert (found[:, 0] >= 0).all()


class FakeCuda:
    """A stand-in with a CUDA device, for the device checks only."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)
