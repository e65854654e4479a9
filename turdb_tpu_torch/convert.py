"""Carry state from the JAX reference (exported as numpy) into the port.

The reference's arrays reach this module as plain numpy: the port never
imports jax, so the export side (`np.asarray` of each field) lives with
the caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from turdb_tpu_torch.models.flat import FlatIndex
from turdb_tpu_torch.models.hnsw import HnswIndex, HnswState
from turdb_tpu_torch.models.hnsw_serve import HnswServeState
from turdb_tpu_torch.models.ivf import IvfConfig, IvfState, cell_lanes, sq8_placeholders
from turdb_tpu_torch.ops.distance import Metric
from turdb_tpu_torch.ops.quantize import Sq8Rows

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
    """A reference `IvfState` and its `IvfConfig` as numpy arrays and a
    dict of fields -> the port's (IvfState, IvfConfig). The row store may
    be f32, SQ16 (uint16) or the probe-only (1, 1, 1) placeholder; `codes`,
    `mins`, `scales` may be absent for a state without sq8 (small
    placeholders are made). Pad cells (cnorms +inf, members all -1; under
    dense packing mapped to block 0) and pad blocks are kept as they are.
    A dense state (`cfg["dense"]`) brings `cell_block` [C]; its storage
    arrays are [NB, L, ...] blocks."""
    cfg = dict(cfg)
    cfg["metric"] = _metric(cfg.get("metric", Metric.L2))
    config = IvfConfig(**{f.name: cfg[f.name] for f in
                          IvfConfig.__dataclass_fields__.values() if f.name in cfg})
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
    if config.dense:
        tensors["cell_block"] = torch.as_tensor(np.array(arrays["cell_block"], np.int32),
                                                device=device)
    state = IvfState(**tensors, lanes=cell_lanes(tensors["alive"]))
    c, cap = state.members.shape
    block = (c, cap, config.dim)
    probe_only = config.sq8 and not config.rerank
    n_cells = state.centroids.shape[0] if config.dense else c
    if config.dense and (state.cell_block.shape != (n_cells,)
                         or int(state.cell_block.max()) >= c):
        raise ValueError("a dense IVF state needs cell_block [C] of block ids < NB")
    if state.centroids.shape != (n_cells, config.dim) or not (
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


def hnsw_index_from_numpy(arrays: dict, cfg: dict, size: int, *, alive=None,
                          descent_ef: int = 1, device="cuda") -> HnswIndex:
    """A reference `HnswState` as numpy (vectors, norms, adj0, adj_hi
    stacked [levels - 1, cap, M], levels, entry, max_level), its
    `HnswConfig` fields as a dict, and the index's size, tombstones
    (`alive` [>= size] bool, default all alive) and descent_ef (32 after
    a bulk build, else 1) -> a port HnswIndex holding the same graph. An
    SQ8 / SQ16 store comes as `codes` [cap, d] (uint8 or uint16), `mins`
    and `scales` [cap] in place of `vectors`, and stays quantized."""
    metric = _metric(cfg.get("metric", Metric.L2))
    sq = "codes" in arrays
    if sq:
        codes = np.asarray(arrays["codes"])
        if codes.dtype not in (np.uint8, np.uint16):
            raise ValueError(f"SQ codes must be uint8 or uint16, got {codes.dtype}")
        cap, dim = codes.shape
    else:
        vectors = np.array(arrays["vectors"], np.float32)
        cap, dim = vectors.shape
    if cfg["m0"] != 2 * cfg["m"] or cap & (cap - 1) or cap < 1024:
        raise ValueError("an HNSW state needs m0 = 2m and a power-of-two capacity >= 1024")
    idx = HnswIndex(dim=dim, metric=metric, m=cfg["m"],
                    ef_construction=cfg.get("ef_construction", 100),
                    ef_search=cfg.get("ef_search", 64), capacity=cap, device=device)
    dev = idx.device
    adj_hi = np.asarray(arrays["adj_hi"], np.int32)
    # the state's own level count (a reference config may set max_levels)
    idx.cfg = dataclasses.replace(idx.cfg, max_levels=len(adj_hi) + 1)
    if sq:
        codes = np.array(codes)     # the uint16 codes are kept as int16 bits
        rows = Sq8Rows(
            torch.as_tensor(codes if codes.dtype == np.uint8 else codes.view(np.int16), device=dev),
            torch.as_tensor(np.array(arrays["mins"], np.float32), device=dev),
            torch.as_tensor(np.array(arrays["scales"], np.float32), device=dev))
    else:
        rows = torch.as_tensor(vectors, device=dev)
    idx.state = HnswState(
        vectors=rows,
        norms=torch.as_tensor(np.array(arrays["norms"], np.float32), device=dev),
        adj0=torch.as_tensor(np.array(arrays["adj0"], np.int32), device=dev),
        adj_hi=tuple(torch.as_tensor(np.array(a), device=dev) for a in adj_hi),
        levels=torch.as_tensor(np.array(arrays["levels"], np.int32), device=dev),
        entry=int(arrays["entry"]),
        max_level=int(arrays["max_level"]),
    )
    idx.size = int(size)
    idx._alive[:size] = True if alive is None else np.asarray(alive, bool)[:size]
    idx._descent_ef = descent_ef
    return idx


def hnsw_serve_state_from_numpy(arrays: dict, device="cuda") -> HnswServeState:
    """A reference `HnswServeState` as numpy -> the port's. The neighbour
    meta keeps its [cap, M0, 4] int32 records; the cell meta is unpacked
    into the [C, L] arrays K4 reads (base, scale, norm bits; ids)."""
    t = {name: torch.as_tensor(np.array(arrays[name]), device=device)
         for name in ("nbr_codes", "nbr_meta", "centroids", "cnorms", "cell_codes",
                      "vectors", "norms")}
    cell_meta = np.asarray(arrays["cell_meta"], np.int32)
    fields = np.ascontiguousarray(cell_meta[..., :3]).view(np.float32)
    return HnswServeState(
        nbr_codes=t["nbr_codes"].to(torch.int8),
        nbr_meta=t["nbr_meta"].to(torch.int32),
        centroids=t["centroids"].float(),
        cnorms=t["cnorms"].float(),
        cell_codes=t["cell_codes"].to(torch.int8),
        cell_mins=torch.as_tensor(np.ascontiguousarray(fields[..., 0]), device=device),
        cell_scales=torch.as_tensor(np.ascontiguousarray(fields[..., 1]), device=device),
        cell_norms=torch.as_tensor(np.ascontiguousarray(fields[..., 2]), device=device),
        cell_members=torch.as_tensor(np.ascontiguousarray(cell_meta[..., 3]), device=device),
        cell_alive=torch.ones(cell_meta.shape[:2], dtype=torch.bool, device=device),
        vectors=t["vectors"].float(),
        norms=t["norms"].float(),
    )


def _shard(arrays: dict, s: int) -> dict:
    """Shard s of a stacked [S, ...] state."""
    return {name: np.asarray(a)[s] for name, a in arrays.items()}


def sharded_ivf_from_numpy(arrays: dict, cfg: dict, mesh, sizes=None):
    """A reference `ShardedIvfIndex`'s stacked state (`_stack_states`: every
    `IvfState` field as one [S, ...] array; `cell_block` unused) and its
    shared `IvfConfig` -> a port `ShardedIvfIndex` on `mesh` whose shard s
    holds slice s on its device. `sizes` [S] (rows per shard) sets each
    shard's size; the loaded index searches and does not train."""
    from turdb_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

    conf = dict(cfg)
    idx = ShardedIvfIndex(dim=conf["dim"], mesh=mesh, metric=_metric(conf.get("metric", 0)),
                          nprobe=conf.get("nprobe", 8), sq8=conf.get("sq8", False),
                          rerank=conf.get("rerank", 0))
    for s, (shard, dev) in enumerate(zip(idx.shards, idx.devices)):
        shard.state, shard.cfg = ivf_state_from_numpy(_shard(arrays, s), conf, device=dev)
        shard.size = 0 if sizes is None else int(sizes[s])
    idx._cfg = idx.shards[0].cfg
    return idx


def sharded_hnsw_from_numpy(arrays: dict, cfg: dict, sizes, mesh, *, alive=None,
                            descent_ef: int = 1, serve: dict | None = None):
    """A reference `ShardedHnswIndex`'s stacked graph (`_init_stacked`:
    every `HnswState` field [S, ...], the upper levels' adjacency as
    `adj_hi` [S, levels - 1, cap, M], `entry` / `max_level` [S]), its
    `HnswConfig` as a dict, the shard sizes [S], the tombstones `alive`
    [S, cap] and its descent_ef -> a port `ShardedHnswIndex` on `mesh`
    whose shard s holds graph s on its device. `serve`, a stacked
    `HnswServeState` as numpy, becomes the per-shard serving packs."""
    from turdb_tpu_torch.parallel.sharded import ShardedHnswIndex

    idx = ShardedHnswIndex(dim=np.asarray(arrays["vectors"]).shape[-1], mesh=mesh,
                           metric=_metric(cfg.get("metric", 0)), m=cfg["m"],
                           ef_construction=cfg.get("ef_construction", 100),
                           ef_search=cfg.get("ef_search", 64))
    idx.shards = [
        hnsw_index_from_numpy(_shard(arrays, s), cfg, int(sizes[s]),
                              alive=None if alive is None else np.asarray(alive)[s],
                              descent_ef=descent_ef, device=dev)
        for s, dev in enumerate(idx.devices)
    ]
    idx.capacity = idx.shards[0].capacity
    idx._descent_ef = descent_ef
    if serve is not None:
        idx._serve = [hnsw_serve_state_from_numpy(_shard(serve, s), device=dev)
                      for s, dev in enumerate(idx.devices)]
    return idx
