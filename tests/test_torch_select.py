"""K2's and K3's redesigned arithmetic on the CPU.

K2 (`kernels/csrc/topk_rows.cu`) cuts a long row into equal segments, takes
each segment's k smallest (key, position) pairs by a radix select on the
keys (and on the positions where the last key ties), and merges the row's
segments x k candidates the same way; a short row is one sort of its
(key, position) pairs. `_k2_emulated` replays
that order step by step in numpy, and must equal `topk_rows_plain` bit for
bit; the JAX reference's `topk_smallest` / `topk_smallest_wide` must give
the same values, and the same positions away from ties. K3 takes its rows
rounded to bf16 once by the caller: the plain version gives the same
answer from either input.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turdb_tpu.ops import topk as jtopk
from turdb_tpu_torch import kernels
from turdb_tpu_torch.models import ivf as tivf

torch.set_num_threads(1)

INF_KEY = 0xFF800000
EPIS = {"none": kernels.EPI_NONE, "l2": kernels.EPI_L2, "cos": kernels.EPI_COS,
        "ip": kernels.EPI_IP}


def _f2key(v: np.ndarray) -> np.ndarray:
    """select.cuh f2key: -0.0 folded into +0.0, then the order-preserving
    bit flip."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def _key2f(k: np.ndarray) -> np.ndarray:
    k = k.astype(np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _narrow(v: np.ndarray, span: int, want: int):
    """topk_rows.cu radix_narrow over the set's values v in [0, span]:
    8-bit digits from the top bit of span down. Returns (whole bin won,
    prefix, rem, want left)."""
    rem, prefix = span.bit_length(), 0
    while rem > 0:
        w = min(8, rem)
        shift = rem - w
        digits = (v[(v >> rem) == prefix] >> shift) & ((1 << w) - 1)
        hist = np.bincount(digits, minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, want))
        want -= int(cum[b] - hist[b])
        prefix = (prefix << w) | b
        rem = shift
        if hist[b] == want:
            return True, prefix, rem, want
    return False, prefix, 0, want


def _radix_select(keys: np.ndarray, pos: np.ndarray, want: int) -> np.ndarray:
    """topk_rows.cu radix_select + Threshold::win: the mask of the `want`
    smallest (key, position) pairs (distinct positions)."""
    keys, pos = keys.astype(np.int64), pos.astype(np.int64)
    fin = keys < INF_KEY
    fset = int(fin.sum()) >= want
    if not fset:
        want -= int(fin.sum())
    in_set = fin == fset
    lo = int(keys[in_set].min())
    rel = keys - lo
    done, prefix, rem, want = _narrow(rel[in_set], int(rel[in_set].max()), want)
    r = rel >> rem
    win = in_set & (r < prefix)
    last = in_set & (r == prefix)
    if not done:                     # the last key ties: its lowest positions
        plo = int(pos[last].min())
        prel = pos - plo
        _, pprefix, prem, _ = _narrow(prel[last], int(prel[last].max()), want)
        last &= (prel >> prem) <= pprefix
    return win | last | (fin & (not fset))


def _k2_emulated(vals: np.ndarray, k: int):
    """K2's order of work on the epilogue's values [B, N]: ([B, k] values,
    [B, k] positions)."""
    b, n = vals.shape
    keys = _f2key(vals)
    pos = np.arange(n, dtype=np.uint64)
    out_v = np.empty((b, k), np.float32)
    out_p = np.empty((b, k), np.int64)
    nseg = kernels.topk_segments(n)
    segw = -(-n // nseg)
    for r in range(b):
        if n <= kernels.TOPK_SHORT_MAX:      # the warp path: one sort
            cand = np.sort((keys[r] << np.uint64(32)) | pos)
        else:
            parts = []
            for c0 in range(0, n, segw):
                sk, sp = keys[r, c0:c0 + segw], pos[c0:c0 + segw]
                win = _radix_select(sk, sp - np.uint64(c0), min(k, len(sk)))
                assert win.sum() == min(k, len(sk))
                parts.append((sk[win] << np.uint64(32)) | sp[win])
            cand = np.concatenate(parts)
            if nseg > 1:                     # the row's last block: the merge
                win = _radix_select(cand >> np.uint64(32), cand & np.uint64(0xFFFFFFFF), k)
                assert win.sum() == k
                cand = cand[win]
            cand = np.sort(cand)
        out_v[r] = _key2f(cand[:k] >> np.uint64(32))
        out_p[r] = (cand[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return out_v, out_p


def _tied_rows(rng, b, n):
    """Values on a coarse grid (many exact ties), with the first 64 columns
    of each of K2's segments copying the 64 before them."""
    x = (np.round(rng.standard_normal((b, n)) * 8) / 8).astype(np.float32)
    w = -(-n // kernels.topk_segments(n))
    for s in range(w, n, w):
        x[:, s:s + 64] = x[:, s - 64:s]
    return x


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(21)
    n = 2 * kernels.TOPK_SEG_W + 3001          # three uneven segments
    x = _tied_rows(rng, 3, n)
    rown = rng.random(3).astype(np.float32) * 4
    coln = rng.random(n).astype(np.float32) * 4
    coln[n // 3: n // 3 + 64] = coln[n // 3 - 64: n // 3]
    valid = rng.random(n) < 0.85
    return x, rown, coln, valid


@pytest.mark.parametrize("epi", list(EPIS))
@pytest.mark.parametrize("clamp,masked", [(False, False), (True, True)])
def test_segmented_order_equals_plain(rows, epi, clamp, masked):
    """Segments then merge, with ties across segment boundaries, under every
    epilogue, clamp and colvalid: bit-equal to `topk_rows_plain`."""
    x, rown, coln, valid = rows
    kw = dict(rown=torch.from_numpy(rown), coln=torch.from_numpy(coln),
              colvalid=torch.from_numpy(valid) if masked else None,
              epilogue=EPIS[epi], clamp=clamp)
    vals = kernels._row_values(torch.from_numpy(x), kw["rown"], kw["coln"], kw["colvalid"],
                               EPIS[epi], clamp).numpy()
    for k in (1, 7, 64):
        ev, ep = _k2_emulated(vals, k)
        pv, pp = kernels.topk_rows_plain(torch.from_numpy(x), k, **kw)
        np.testing.assert_array_equal(ev, pv.numpy())
        np.testing.assert_array_equal(ep, pp.numpy())


@pytest.mark.parametrize("n", [2, 20, 40, 2048, 4000])
def test_short_and_single_segment_rows_equal_plain(n):
    """The warp path (n <= 2048, k up to n) and a single-segment row, on
    rows merged with themselves (every value tied twice), plus rows with
    fewer finite values than k and rows of one value."""
    rng = np.random.default_rng(n)
    half = (np.round(rng.standard_normal((4, -(-n // 2))) * 4) / 4).astype(np.float32)
    x = np.concatenate([half, half], 1)[:, :n]
    x[1, 1::2] = np.inf
    x[2] = 3.0
    for k in sorted({1, min(10, n), n if n <= kernels.SEL_MAX else 300}):
        ev, ep = _k2_emulated(x, k)
        pv, pp = kernels.topk_rows_plain(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ev, pv.numpy())
        np.testing.assert_array_equal(ep, pp.numpy())


@pytest.mark.parametrize("epi", ["l2", "ip"])
def test_reference_selections_agree(rows, epi):
    """The same distances through the reference's `topk_smallest` (wide
    rows route to `topk_smallest_wide`) on JAX's CPU: the same values, and
    the same positions wherever the value is not tied in its row."""
    x, rown, coln, valid = rows
    vals = kernels._row_values(torch.from_numpy(x), torch.from_numpy(rown),
                               torch.from_numpy(coln), torch.from_numpy(valid),
                               EPIS[epi], True).numpy()
    ids = np.broadcast_to(np.arange(vals.shape[1], dtype=np.int32), vals.shape)
    for k in (10, 64):
        jv, ji = jtopk.topk_smallest(jnp.asarray(vals), jnp.asarray(ids), k)
        wv, wi = jtopk.topk_smallest_wide(jnp.asarray(vals), k)
        pv, pp = kernels.topk_rows_plain(torch.from_numpy(x), k, rown=torch.from_numpy(rown),
                                         coln=torch.from_numpy(coln),
                                         colvalid=torch.from_numpy(valid),
                                         epilogue=EPIS[epi], clamp=True)
        pv, pp = pv.numpy(), pp.numpy()
        for ref_v, ref_i in ((jv, ji), (wv, wi)):
            np.testing.assert_array_equal(np.asarray(ref_v), pv)
            once = np.array([[np.count_nonzero(vals[r] == v) == 1 for v in pv[r]]
                             for r in range(len(pv))])
            np.testing.assert_array_equal(np.asarray(ref_i)[once], pp[once])


def test_kmeans_assign_takes_prerounded_rows():
    """K3's plain version from rows already rounded to bf16 (as a k-means
    run passes them) equals the call on the f32 rows, for r = 1..4, and the
    index build's helpers give the same ids with and without the copy."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3000, 40)).astype(np.float32) * 3)
    cents = torch.from_numpy(rng.standard_normal((90, 40)).astype(np.float32) * 3)
    xn, cn = (x * x).sum(1), (cents * cents).sum(1)
    cn[::9] = float("inf")
    xb = x.to(torch.bfloat16)
    for r in (1, 2, 3, 4):
        i32, d32 = kernels.kmeans_assign(x, cents, xn, cn, r)
        i16, d16 = kernels.kmeans_assign(xb, cents, xn, cn, r)
        assert torch.equal(i32, i16) and torch.equal(d32, d16)
    assert torch.equal(tivf._assign_all(x, cents), tivf._assign_all(x, cents, xb=xb))
    a, b = tivf._assign_topk_all(x, cents, k=3), tivf._assign_topk_all(x, cents, k=3, xb=xb)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(tivf._kmeans(x, cents, 3), tivf._kmeans(x, cents, 3, xb=xb))
