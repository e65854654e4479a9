from turdb_tpu_torch.models.flat import FlatIndex, flat_search
from turdb_tpu_torch.models.hnsw import HnswConfig, HnswIndex, HnswState, hnsw_search_impl
from turdb_tpu_torch.models.hnsw_serve import HnswServeState, pack_serving, serve_search_impl
from turdb_tpu_torch.models.ivf import IvfConfig, IvfIndex, IvfState, ivf_search_impl

__all__ = ["FlatIndex", "flat_search", "HnswConfig", "HnswIndex", "HnswState",
           "hnsw_search_impl", "HnswServeState", "pack_serving", "serve_search_impl",
           "IvfConfig", "IvfIndex", "IvfState", "ivf_search_impl"]
