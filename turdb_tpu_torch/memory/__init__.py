"""Memory budget (reference src/memory/, SURVEY.md §2.8): hard-limit
budget with reserved pools. On the TPU side the analogous budget is HBM
capacity for device arrays (tracked by the vector engine's capacity
planning); this module covers the host side."""

from turdb_tpu_torch.memory.budget import MemoryBudget  # noqa: F401
