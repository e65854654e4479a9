"""Carry state from the JAX reference (exported as numpy) into the port.

The reference's arrays reach this module as plain numpy: the port never
imports jax, so the export side (`np.asarray` of each field) lives with
the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.ivf import IvfConfig, IvfState
from turdb_tpu_torch.ops.distance import Metric

_IVF_FIELDS = ("centroids", "cnorms", "members", "pvecs", "pnorms", "alive")
_IVF_TYPES = (np.float32, np.float32, np.int32, np.float32, np.float32, bool)


def _metric(m) -> Metric:
    """A port Metric, or the reference's `.value` (the same ints)."""
    return m if isinstance(m, Metric) else Metric(int(m))


def ivf_state_from_numpy(arrays: dict, cfg: dict, device) -> tuple[IvfState, IvfConfig]:
    """A reference `IvfState` (f32 store, block == cell) and its `IvfConfig`
    as numpy arrays and a dict of fields -> the port's (IvfState, IvfConfig).
    Pad cells (cnorms +inf, members all -1) are kept as they are."""
    cfg = dict(cfg)
    cfg["metric"] = _metric(cfg.get("metric", Metric.L2))
    config = IvfConfig(**{f.name: cfg[f.name] for f in
                          IvfConfig.__dataclass_fields__.values() if f.name in cfg})
    if config.sq8 or config.rerank or config.dense:
        raise NotImplementedError("only the f32 IVF store (no sq8, rerank or dense) ports")
    tensors = {
        name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
        for name, dtype in zip(_IVF_FIELDS, _IVF_TYPES)
    }
    state = IvfState(**tensors)
    c, cap = state.members.shape
    if state.pvecs.shape != (c, cap, config.dim) or state.centroids.shape != (c, config.dim):
        raise ValueError("IVF arrays do not match the config's dim / block shape")
    return state, config


def flat_from_numpy(vectors, valid, metric, device) -> FlatIndex:
    """Rows [N, d] (already normalised for cosine, as the reference
    stores them) and their valid mask [N] -> a port FlatIndex of size N."""
    vectors = np.array(vectors, np.float32)
    n, d = vectors.shape
    idx = FlatIndex(dim=d, metric=_metric(metric), capacity=n, device=device)
    v = torch.as_tensor(vectors, device=idx.device)
    idx._vectors[:n] = v
    idx._norms[:n] = torch.sum(v * v, dim=-1)
    idx._valid[:n] = torch.as_tensor(np.array(valid, bool), device=idx.device)
    idx.size = n
    return idx
