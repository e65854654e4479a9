"""The port's dataset module against the reference's on the same
generator state and files: `emb_pool` at 384 and 768 dims, the TexMex
loaders (`load_fvecs`, `load_ivecs`, `sift_dataset`) on files written
here, and `pix_pool` on an image written with PIL. Every array equals the
reference's exactly (both are numpy, in the same order)."""

import numpy as np
import pytest
from PIL import Image

from turdb_tpu.utils import datasets as ref
from turdb_tpu_torch.utils import datasets as port


@pytest.mark.parametrize("dim", [384, 768])
def test_emb_pool_equals_the_reference(dim):
    want = ref.emb_pool(np.random.default_rng(0), 3000, n_queries=64, dim=dim)
    got = port.emb_pool(np.random.default_rng(0), 3000, n_queries=64, dim=dim)
    for w, g in zip(want, got):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), 1.0, rtol=1e-5)


def _write_vecs(path, rows, dtype):
    d = rows.shape[1]
    out = np.empty((rows.shape[0], d + 1), np.int32)
    out[:, 0] = d
    out[:, 1:] = rows.astype(dtype).view(np.int32)
    out.tofile(path)


def test_texmex_loaders_equal_the_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((50, 12)).astype(np.float32)
    queries = rng.standard_normal((7, 12)).astype(np.float32)
    truth = rng.integers(0, 50, (7, 5)).astype(np.int32)
    _write_vecs(tmp_path / "sift_base.fvecs", base, np.float32)
    _write_vecs(tmp_path / "sift_query.fvecs", queries, np.float32)
    _write_vecs(tmp_path / "sift_groundtruth.ivecs", truth, np.int32)
    for max_n in (None, 20):
        got = port.load_fvecs(str(tmp_path / "sift_base.fvecs"), max_n)
        np.testing.assert_array_equal(got, ref.load_fvecs(str(tmp_path / "sift_base.fvecs"), max_n))
        np.testing.assert_array_equal(got, base[:max_n])
        np.testing.assert_array_equal(
            port.load_ivecs(str(tmp_path / "sift_groundtruth.ivecs"), max_n),
            ref.load_ivecs(str(tmp_path / "sift_groundtruth.ivecs"), max_n))
    monkeypatch.setenv("TURDB_SIFT_PATH", str(tmp_path))
    for max_n in (None, 20):
        want, got = ref.sift_dataset(max_n), port.sift_dataset(max_n)
        for w, g in zip(want, got):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("TURDB_SIFT_PATH", str(tmp_path / "absent"))
    assert port.sift_dataset() is None


def test_pix_pool_equals_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    img = (rng.random((200, 216)) * 255).astype(np.uint8)
    path = str(tmp_path / "patches.png")
    Image.fromarray(img).save(path)
    want = ref.pix_pool(n=4000, n_queries=1500, path=path)
    got = port.pix_pool(n=4000, n_queries=1500, path=path)
    assert got[0].shape == (4000, 128) and got[1].shape[0] >= 1024
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert port.pix_pool(path=str(tmp_path / "absent.png")) is None
