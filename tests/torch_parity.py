"""Test helpers shared by tests/test_torch_*.py: export the JAX
reference's state to numpy (only tests may import both packages) and
compare k-NN results of the reference and the port."""

from __future__ import annotations

import dataclasses

import numpy as np

IVF_FIELDS = ("centroids", "cnorms", "members", "pvecs", "pnorms", "alive",
              "codes", "mins", "scales")


def export_ivf(state, cfg) -> tuple[dict, dict]:
    """A reference IvfState + IvfConfig -> (numpy arrays, config dict); a
    dense state also exports its `cell_block`."""
    arrays = {f: np.asarray(getattr(state, f)) for f in IVF_FIELDS}
    if getattr(state, "cell_block", None) is not None:
        arrays["cell_block"] = np.asarray(state.cell_block)
    conf = dataclasses.asdict(cfg)
    conf["metric"] = cfg.metric.value
    return arrays, conf


def export_flat(index) -> tuple[np.ndarray, np.ndarray, int]:
    """A reference FlatIndex -> (vectors [size, d], valid [size], metric value)."""
    n = index.size
    return (np.asarray(index._vectors)[:n], np.asarray(index._valid)[:n],
            index.metric.value)


def assert_knn_match(d_ref, i_ref, d_port, i_port, rtol=1e-4, atol=1e-3):
    """Same +inf pattern; finite distances within rtol/atol; where the ids
    differ on a finite entry, the two distances must tie within the same
    tolerance (summation order may swap near-equal neighbours)."""
    d_ref, d_port = np.asarray(d_ref), np.asarray(d_port)
    i_ref, i_port = np.asarray(i_ref), np.asarray(i_port)
    assert d_ref.shape == d_port.shape and i_ref.shape == i_port.shape
    fin = np.isfinite(d_ref)
    np.testing.assert_array_equal(fin, np.isfinite(d_port))
    np.testing.assert_allclose(d_port[fin], d_ref[fin], rtol=rtol, atol=atol)
    diff = fin & (i_ref != i_port)
    with np.errstate(invalid="ignore"):   # inf - inf off the finite entries
        close = np.abs(d_ref - d_port) <= atol + rtol * np.abs(d_ref)
    assert np.all(close[diff]), "ids differ away from a tie"
    assert diff.mean() <= 0.01, f"{diff.mean():.4f} of the ids differ"


def export_hnsw(state, cfg, size) -> tuple[dict, dict]:
    """A reference HnswState + HnswConfig -> (numpy arrays, config dict);
    the upper levels' adjacency is stacked [levels - 1, cap, M]. An SQ8 /
    SQ16 store (`Sq8Rows`) is exported as `codes` (uint8 / uint16),
    `mins` and `scales` in place of `vectors`."""
    arrays = {f: np.asarray(getattr(state, f))
              for f in ("norms", "adj0", "levels", "entry", "max_level")}
    rows = state.vectors
    if hasattr(rows, "codes"):
        arrays.update(codes=np.asarray(rows.codes), mins=np.asarray(rows.mins),
                      scales=np.asarray(rows.scales))
    else:
        arrays["vectors"] = np.asarray(rows)
    arrays["adj_hi"] = np.stack([np.asarray(a) for a in state.adj_hi])
    conf = dataclasses.asdict(cfg)
    conf["metric"] = cfg.metric.value
    return arrays, conf


def export_hnsw_serve(serve) -> dict:
    """A reference HnswServeState -> its arrays as numpy."""
    return {f: np.asarray(getattr(serve, f)) for f in serve._fields}


def export_sharded_ivf(index) -> tuple[dict, dict, np.ndarray]:
    """A trained reference ShardedIvfIndex -> (its stacked [S, ...] state
    as numpy, the shared config dict, the shard sizes)."""
    if index._stacked is None:
        index.train()
    arrays = {f: np.asarray(getattr(index._stacked, f)) for f in IVF_FIELDS}
    conf = dataclasses.asdict(index._cfg)
    conf["metric"] = index._cfg.metric.value
    return arrays, conf, np.asarray([s.size for s in index.shards])


def export_sharded_hnsw(index) -> tuple[dict, dict, dict | None]:
    """A reference ShardedHnswIndex -> (its stacked graph as numpy with
    `adj_hi` [S, levels - 1, cap, M], the config dict, its stacked serving
    pack as numpy or None)."""
    st = index.state
    arrays = {f: np.asarray(getattr(st, f))
              for f in ("vectors", "norms", "adj0", "levels", "entry", "max_level")}
    arrays["adj_hi"] = np.stack([np.asarray(a) for a in st.adj_hi], axis=1)
    conf = dataclasses.asdict(index.cfg)
    conf["metric"] = index.cfg.metric.value
    serve = None if index._serve is None else export_hnsw_serve(index._serve)
    return arrays, conf, serve
