"""The port's graft entry points (turdb_tpu_torch/graft_entry.py) against
the repository's `__graft_entry__.py` on the CPU.

`entry(device="cpu")` synthesizes the reference's graph and queries from
the same seed in the same draw order: its search step must give the
reference `entry()`'s ids up to exact-tie order and its distances within
the HNSW parity tests' tolerance (`assert_knn_match`). The mesh dry run
over four copies of the CPU device clears the reference's recall floor.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import assert_knn_match

from turdb_tpu_torch import graft_entry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location("reference_graft_entry",
                                                  ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_reference():
    fn, (state, q) = graft_entry.entry(device="cpu")
    ref_fn, (ref_state, ref_q) = _reference().entry()
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(state.adj0.numpy(), np.asarray(ref_state.adj0))
    for a, b in zip(state.adj_hi, ref_state.adj_hi):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert state.entry == int(ref_state.entry) and state.max_level == int(ref_state.max_level)
    d, i = fn(state, q)
    want_d, want_i = ref_fn(ref_state, jnp.asarray(ref_q))
    assert tuple(d.shape) == tuple(i.shape) == (64, 10)
    assert_knn_match(np.asarray(want_d), np.asarray(want_i), d.numpy(), i.numpy())


def test_dryrun_multichip_clears_the_recall_floor():
    out = graft_entry.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "db": 2}
    assert out["multihost_mesh"] == {"host": 2, "data": 1, "db": 2}
    assert out["ivf_recall"] >= graft_entry.RECALL_FLOOR
