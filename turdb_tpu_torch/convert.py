"""Carry state from the JAX reference (exported as numpy) into the port.

The reference's arrays reach this module as plain numpy: the port never
imports jax, so the export side (`np.asarray` of each field) lives with
the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.ivf import IvfConfig, IvfState, sq8_placeholders
from turdb_tpu_torch.ops.distance import Metric

_IVF_FIELDS = ("centroids", "cnorms", "members", "pnorms", "alive")
_IVF_TYPES = (np.float32, np.float32, np.int32, np.float32, bool)
_SQ8_FIELDS = ("codes", "mins", "scales")
_SQ8_TYPES = (np.int8, np.float32, np.float32)


def _metric(m) -> Metric:
    """A port Metric, or the reference's `.value` (the same ints)."""
    return m if isinstance(m, Metric) else Metric(int(m))


def _pvecs(a) -> np.ndarray:
    """The row store: f32 rows, or SQ16 uint16 codes as int16 with the
    same bits (torch has few uint16 operators)."""
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.int16):
        return np.array(a).view(np.int16)
    return np.array(a, np.float32)


def ivf_state_from_numpy(arrays: dict, cfg: dict,
                         device="cuda") -> tuple[IvfState, IvfConfig]:
    """A reference `IvfState` (block == cell) and its `IvfConfig` as numpy
    arrays and a dict of fields -> the port's (IvfState, IvfConfig). The
    row store may be f32, SQ16 (uint16) or the probe-only (1, 1, 1)
    placeholder; `codes`, `mins`, `scales` may be absent for a state
    without sq8 (small placeholders are made). Pad cells (cnorms +inf,
    members all -1) are kept as they are. Dense block packing is refused."""
    cfg = dict(cfg)
    cfg["metric"] = _metric(cfg.get("metric", Metric.L2))
    config = IvfConfig(**{f.name: cfg[f.name] for f in
                          IvfConfig.__dataclass_fields__.values() if f.name in cfg})
    if config.dense:
        raise NotImplementedError(
            "not ported yet: dense block packing (ROADMAP queue 1 item 7; "
            "queue 2, still to port, item 1)")
    tensors = {
        name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
        for name, dtype in zip(_IVF_FIELDS, _IVF_TYPES)
    }
    tensors["pvecs"] = torch.as_tensor(_pvecs(arrays["pvecs"]), device=device)
    if all(f in arrays for f in _SQ8_FIELDS):
        tensors.update({name: torch.as_tensor(np.array(arrays[name], dtype), device=device)
                        for name, dtype in zip(_SQ8_FIELDS, _SQ8_TYPES)})
    else:
        tensors.update(zip(_SQ8_FIELDS, sq8_placeholders(device)))
    state = IvfState(**tensors)
    c, cap = state.members.shape
    block = (c, cap, config.dim)
    probe_only = config.sq8 and not config.rerank
    if state.centroids.shape != (c, config.dim) or not (
            state.pvecs.shape == block or probe_only and state.pvecs.shape == (1, 1, 1)):
        raise ValueError("IVF arrays do not match the config's dim / block shape")
    if config.sq8 and (state.codes.shape != block or state.mins.shape != (c, cap)
                       or state.scales.shape != (c, cap)):
        raise ValueError("an sq8 IVF state needs codes [C, L, d], mins and scales [C, L]")
    return state, config


def flat_from_numpy(vectors, valid, metric, device="cuda") -> FlatIndex:
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
