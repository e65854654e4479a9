"""K6's staged meta blocks, code rows and rerank, and K5's staged rows,
replayed in numpy on the CPU (csrc/hnsw_beam.cu, csrc/ivf_rerank.cu).

- K6 phase 1: which lane bulk-copies which node's meta block (deg x 16
  bytes) to which offset of shared memory; the region then holds the
  blocks, phase 2 reads the slot ids from them, and the mbarrier expects
  exactly the bytes the copies bring;
- K6 phase 3: which lane copies which word of which kept slot's code row
  to which offset of the warp's stage (rows of an odd count of 16-byte
  words); the stage then holds the rows, a 16-byte shared load's 8 lanes
  of a phase fall on the 32 banks once, and lane r's int32 dot and
  epilogue from the staged row and meta entry equal the plain version's
  `sq8_epilogue` bit for bit;
- K6's rerank: the chunks' copies, thread j scoring row j of a chunk,
  and the ranks (runs of 32 keys sorted, place in the run plus the keys
  below in the other runs) against the (distance, position) order;
- K5: the chunks' copies of f32 and SQ16 rows (16- or 8-byte words), the
  metadata thread to row, and each lane's elements 4m .. 4m+3 for m = lane,
  lane + 32, ... in order, the order of the kernel that read the rows from
  device memory;
- K6's shared memory at chip_smoke's shapes, for the record.
"""

import numpy as np
import pytest
import torch

from turdb_tpu_torch import kernels

torch.set_num_threads(1)

BEAM_THREADS, BEAM_WARPS = 128, 4


def _stage_words(row_bytes):
    return ((row_bytes + 15) >> 4) | 1


def _banks_once(pitch_words, off):
    """The 4 phases of a 16-byte shared load by 32 lanes, lane r at row r
    (pitch_words 16-byte words apart), byte offset `off` in its row: each
    phase's 8 lanes cover the 32 banks once."""
    for p in range(4):
        banks = [(((8 * p + k) * pitch_words * 16 + off) // 4 + i) % 32
                 for k in range(8) for i in range(4)]
        if sorted(banks) != list(range(32)):
            return False
    return True


# ---------------------------------------------------------------------------
# K6 phase 1: the meta blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg", (32, 16))
@pytest.mark.parametrize("found", (4, 3, 0))
def test_k6_meta_blocks_replay(deg, found):
    rng = np.random.default_rng(deg + found)
    cap, expand = 500, 4
    meta = rng.integers(-2**31, 2**31 - 1, (cap, deg, 4), dtype=np.int64).astype(np.int32)
    meta[..., 3] = rng.integers(-1, cap, (cap, deg))
    src = meta.view(np.uint8).reshape(-1)
    sel = np.full(expand, -1)
    sel[:found] = rng.choice(cap, found, replace=False)
    block = deg * 16
    region = np.zeros(expand * deg * 16, np.uint8)
    expect_tx = found * block          # lane 0's arrival
    brought = 0
    for lane in range(32):             # fetch_meta: lane e copies node sel[e]
        for e in range(lane, found, 32):
            s, t = int(sel[e]) * block, e * block
            assert s % 16 == 0 and t % 16 == 0 and block % 16 == 0
            region[t:t + block] = src[s:s + block]
            brought += block
    assert brought == expect_tx < 2**20
    staged = region.view(np.int32).reshape(expand, deg, 4)
    for e in range(found):
        np.testing.assert_array_equal(staged[e], meta[sel[e]])
    # phase 2: slot t reads its id from entry t of the blocks, -1 past the
    # selected nodes' slots; phase 3 its base, scale and norm
    flat = region.view(np.int32).reshape(-1, 4)
    for t in range(expand * deg):
        pid = flat[t, 3] if t < found * deg else -1
        want = meta[sel[t // deg], t % deg, 3] if t // deg < found else -1
        assert pid == want


# ---------------------------------------------------------------------------
# K6 phase 3: the kept code rows
# ---------------------------------------------------------------------------

def _code_copies(slots, sel, deg, d, wide):
    """staged_block_score's copies of a batch (lane r holds slot slots[r],
    -1: none): (lane, step, row, source byte, staged byte, bytes)."""
    sw = _stage_words(d)
    wb = 16 if wide else 4
    rw = d // wb
    total = len(slots) * rw
    out = []
    for step, e0 in enumerate(range(0, total, 32)):
        for lane in range(32):
            e = e0 + lane
            if e >= total:
                continue
            r = e >> (rw - 1).bit_count() if rw & (rw - 1) == 0 else e // rw
            t = slots[r]
            if t < 0:
                continue
            w = e - r * rw
            blk = int(sel[t // deg]) * deg + t % deg
            out.append((lane, step, r, blk * d + w * wb, r * sw * 16 + w * wb, wb))
    return out


def _dp4a_dot(row_bytes, q_bytes, wide):
    """Lane r's dot: 16-byte words four __dp4a at a time, then 4-byte words."""
    x = row_bytes.view(np.int8).astype(np.int64)
    y = q_bytes.view(np.int8).astype(np.int64)
    d = len(x)
    dot, j = 0, 0
    if wide:
        for j in range(d // 16):
            dot += int((x[16 * j:16 * j + 16] * y[16 * j:16 * j + 16]).sum())
        j = 4 * (d // 16)
    for w in range(j, d // 4):
        dot += int((x[4 * w:4 * w + 4] * y[4 * w:4 * w + 4]).sum())
    return dot


@pytest.mark.parametrize("d", (128, 36, 64))
@pytest.mark.parametrize("srows", (32, 16))
def test_k6_code_rows_replay(d, srows):
    rng = np.random.default_rng(d * srows)
    cap, deg, expand = 400, 32, 4
    codes = rng.integers(-128, 128, (cap, deg, d)).astype(np.int8)
    src = codes.view(np.uint8).reshape(-1)
    meta = np.zeros((cap, deg, 4), np.int32)
    fmeta = meta.view(np.float32)
    fmeta[..., 0] = rng.standard_normal((cap, deg)).astype(np.float32)       # base
    fmeta[..., 1] = rng.uniform(0.001, 0.05, (cap, deg)).astype(np.float32)  # scale
    fmeta[..., 2] = rng.uniform(1, 50, (cap, deg)).astype(np.float32)        # norm
    sel = rng.choice(cap, expand, replace=False)
    qc = rng.integers(-127, 128, d).astype(np.int8)
    qs, qsum, qn = np.float32(0.0213), np.float32(-1.75), np.float32(31.5)
    wide = d % 16 == 0        # the launch's rule (16-byte aligned codes)
    sw = _stage_words(d)
    assert sw % 2 == 1 and 16 * sw >= d
    # a warp's kept slots (its 32 slots of phase 2, compacted), in batches
    kept = np.flatnonzero(rng.random(deg) < 0.7) + deg * rng.integers(0, expand)
    for base in range(0, len(kept), srows):
        n = min(srows, len(kept) - base)
        slots = np.full(32, -1)
        slots[:n] = kept[base:base + n]
        stage = np.zeros(32 * sw * 16, np.uint8)
        for lane, step, r, s, t, wb in _code_copies(slots, sel, deg, d, wide):
            assert s % wb == 0 and t % wb == 0 and t + wb <= r * sw * 16 + d
            stage[t:t + wb] = src[s:s + wb]
        for r in range(n):
            t = slots[r]
            row = stage[r * sw * 16:r * sw * 16 + d]
            np.testing.assert_array_equal(row.view(np.int8), codes[sel[t // deg], t % deg])
            dot = _dp4a_dot(row, qc.view(np.uint8), wide)
            want_dot = int((codes[sel[t // deg], t % deg].astype(np.int64) * qc).sum())
            assert dot == want_dot
            m = fmeta[sel[t // deg], t % deg]
            # the kernel's epilogue, each operation rounded to f32
            qdx = np.float32(np.float32(m[0] * qsum)
                             + np.float32(m[1] * np.float32(qs * np.float32(dot))))
            l2 = np.float32(np.float32(qn - np.float32(2.0 * qdx)) + m[2])
            for metric, got in ((0, l2), (1, np.float32(1.0 - qdx)), (2, -qdx)):
                want = kernels.sq8_epilogue(
                    torch.tensor([float(dot)]), torch.tensor(m[0]), torch.tensor(m[1]),
                    torch.tensor(qn), torch.tensor(qsum), torch.tensor(qs), torch.tensor(m[2]),
                    metric)
                assert np.float32(got).view(np.int32) == want.numpy().view(np.int32)[0], metric
        if wide:
            assert all(_banks_once(sw, 16 * j) for j in range(d // 16))


# ---------------------------------------------------------------------------
# K6's rerank: staged rows, thread to row, ranks
# ---------------------------------------------------------------------------

def _f2key(v):
    """select.cuh f2key: the float order as uint32, -0.0 folded into +0.0."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000).astype(np.uint64)


def _ranks(td, k):
    """The kernel's ranks: runs of 32 keys (distance, position) sorted by a
    warp each, a key's rank its place in its run plus the keys below it in
    every other run; {rank: position} for rank < k."""
    r = len(td)
    keys = (_f2key(td) << np.uint64(32)) | np.arange(r, dtype=np.uint64)
    runs = [np.sort(keys[o:o + 32]) for o in range(0, r, 32)]
    out = {}
    for ri, run in enumerate(runs):
        for place, key in enumerate(run):
            rank = place + sum(int(np.searchsorted(o, key)) for oi, o in enumerate(runs)
                               if oi != ri)
            if rank < k:
                assert rank not in out
                out[rank] = int(key & np.uint64(0xFFFFFFFF))
    return out


@pytest.mark.parametrize("r,k", ((32, 10), (192, 10), (40, 40), (70, 33)))
def test_k6_rerank_ranks_are_the_position_order(r, k):
    rng = np.random.default_rng(r + k)
    td = rng.standard_normal(r).astype(np.float32)
    td[rng.random(r) < 0.2] = np.inf                 # outside `allowed`, or id -1
    td[5::9] = td[3]                                  # exact ties
    td[7] = np.float32(-0.0)
    td[8] = np.float32(0.0)
    got = _ranks(td, k)
    assert sorted(got) == list(range(k))
    vals, pos = kernels.topk_rows_plain(torch.from_numpy(td)[None], k)
    np.testing.assert_array_equal([got[i] for i in range(k)], pos[0].numpy())
    np.testing.assert_array_equal(td[[got[i] for i in range(k)]], vals[0].numpy())


@pytest.mark.parametrize("d", (128, 36, 256))
@pytest.mark.parametrize("r", (32, 192))
def test_k6_rerank_stage_replay(d, r):
    """pick_serve_stage's chunk of rc rows (at most 32, at most
    RERANK_STAGE_BYTES) and the kernel's copies: every thread's 16-byte
    copies (word w of row e / words by thread e % 128), thread j scoring
    row j of the chunk from its padded row."""
    rng = np.random.default_rng(d + r)
    cap = 800
    vec = rng.standard_normal((cap, d)).astype(np.float32)
    src = vec.view(np.uint8).reshape(-1)
    best = rng.choice(cap, r, replace=False)
    best[rng.random(r) < 0.1] = -1
    rw = _stage_words(4 * d)
    rc = max(1, min(32, r, (32 * 33 * 16) // (rw * 16)))
    assert rc == (32 if d <= 128 else 16)
    words = d // 4
    scored = []
    for c0 in range(0, r, rc):
        n = min(rc, r - c0)
        stage = np.zeros(rc * rw * 16, np.uint8)
        for tid in range(BEAM_THREADS):
            for e in range(tid, n * words, BEAM_THREADS):
                row, w = divmod(e, words)
                i = best[c0 + row]
                if i >= 0:
                    s, t = (i * d + 4 * w) * 4, row * rw * 16 + w * 16
                    stage[t:t + 16] = src[s:s + 16]
        for j in range(n):           # thread j: row c0 + j
            scored.append(c0 + j)
            if best[c0 + j] >= 0:
                np.testing.assert_array_equal(
                    stage[j * rw * 16:j * rw * 16 + 4 * d].view(np.float32), vec[best[c0 + j]])
        assert all(_banks_once(rw, 16 * j) for j in range(words))
    assert scored == list(range(r))


# ---------------------------------------------------------------------------
# K5: staged rows, metadata, each lane's elements
# ---------------------------------------------------------------------------

K5_STAGE_BYTES, K5_THREADS = 24576, 128


@pytest.mark.parametrize("store", ("f32", "sq16"))
@pytest.mark.parametrize("d", (128, 36, 32))
@pytest.mark.parametrize("r", (40, 300))
def test_k5_stage_and_lane_order_replay(store, d, r):
    rng = np.random.default_rng(d * r + (store == "f32"))
    n_rows = 2000
    row_bytes = 4 * d if store == "f32" else 2 * d
    src = rng.integers(0, 256, n_rows * row_bytes, dtype=np.uint8)
    pnorms = rng.uniform(1, 9, n_rows).astype(np.float32)
    cand_d = rng.standard_normal(r).astype(np.float32)
    cand_d[rng.random(r) < 0.15] = np.inf
    cand_pos = rng.integers(0, n_rows, r)
    s_row = np.where(np.isinf(cand_d), -1, cand_pos)
    wb = 16 if row_bytes % 16 == 0 else 8
    assert store == "f32" or wb == (16 if d % 8 == 0 else 8)
    chunk = max(1, min(r, K5_THREADS, K5_STAGE_BYTES // row_bytes))
    words = row_bytes // wb
    seen = []
    for c0 in range(0, r, chunk):
        n = min(chunk, r - c0)
        stage = np.zeros(chunk * row_bytes, np.uint8)
        for tid in range(K5_THREADS):
            for e in range(tid, n * words, K5_THREADS):
                i, w = divmod(e, words)
                pos = s_row[c0 + i]
                if pos >= 0:
                    s, t = pos * row_bytes + w * wb, i * row_bytes + w * wb
                    assert s % wb == 0 and t % wb == 0
                    stage[t:t + wb] = src[s:s + wb]
        # thread tid < n loads row c0 + tid's norm into s_meta[tid]
        s_meta = np.array([pnorms[s_row[c0 + t]] if s_row[c0 + t] >= 0 else 0.0
                           for t in range(n)], np.float32)
        for i in range(n):            # warp i % 4 scores candidate c0 + i
            seen.append(c0 + i)
            pos = s_row[c0 + i]
            if pos < 0:
                continue
            assert s_meta[i] == pnorms[pos]
            row = stage[i * row_bytes:(i + 1) * row_bytes]
            np.testing.assert_array_equal(row, src[pos * row_bytes:(pos + 1) * row_bytes])
            # lane j's loads: 4-element words m = j, j + 32, ... of the
            # staged row, each read in element order: the sequence of the
            # kernel that read the row from device memory
            esize = row_bytes // d
            for lane in range(32):
                order = [4 * m + e for m in range(lane, d // 4, 32) for e in range(4)]
                offs = [o * esize for o in order]
                assert offs == sorted(offs)
                assert all(4 * m * esize < row_bytes for m in range(lane, d // 4, 32))
            # neighbouring lanes read neighbouring words: no bank conflict
            assert 4 * esize * 32 % 128 == 0
    assert seen == list(range(r))


# ---------------------------------------------------------------------------
# K6's shared memory at chip_smoke's shapes
# ---------------------------------------------------------------------------

def _table_bits(members):
    b = 1
    while (1 << b) < 2 * members:
        b += 1
    return b


def _serve_smem(ef, iters, expand, deg, d, srows, r):
    """hnsw_beam.cu's serve_smem for a stage of `srows` code rows a warp."""
    loops = -(-iters // expand)
    exp_cap, slots = loops * expand, expand * deg
    hbits = _table_bits(ef + exp_cap + slots)
    wcap = 32 * (-(-slots // BEAM_THREADS))
    qb = d * 4 + d + 8
    rw = _stage_words(4 * d)
    rc = max(1, min(32, r, (32 * 33 * 16) // (rw * 16)))
    stage = max(BEAM_WARPS * srows * _stage_words(d) * 16, rc * rw * 16 - 16 * BEAM_WARPS * wcap)
    table = max(8 << hbits, stage)
    beam = (-(-qb // 16) * 16 + table + 8 * (2 * BEAM_WARPS * wcap)
            + 4 * (6 * ef + 2 * BEAM_WARPS * wcap + 2 * slots + 2 * expand + exp_cap + 16))
    return -(-beam // 16) * 16 + slots * 16 + 16


def test_k6_shared_memory_leaves_one_wave():
    """At chip_smoke's shapes (d 128, deg 32, expand 4, B = 1024 on 132
    SMs: eight blocks an SM for one wave) the gate takes 32 code rows a
    warp and still fits eight blocks in an SM's 228 KB (1 KB reserved a
    block); ef 192 fits eight only at 16 rows."""
    sm_bytes, reserve = 233472, 1024
    gate32 = _serve_smem(32, 24, 4, 32, 128, 32, 32)
    wide16 = _serve_smem(192, 160, 4, 32, 128, 16, 192)
    wide32 = _serve_smem(192, 160, 4, 32, 128, 32, 192)
    assert sm_bytes // (gate32 + reserve) >= 8
    assert sm_bytes // (wide16 + reserve) >= 8 > sm_bytes // (wide32 + reserve)
