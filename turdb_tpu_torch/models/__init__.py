from turdb_tpu_torch.models.flat import FlatIndex, flat_search
from turdb_tpu_torch.models.ivf import IvfConfig, IvfIndex, IvfState, ivf_search_impl

__all__ = ["FlatIndex", "flat_search", "IvfConfig", "IvfIndex", "IvfState",
           "ivf_search_impl"]
