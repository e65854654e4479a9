"""Native (C++) runtime components, loaded via ctypes with pure-Python
fallbacks. The reference's entire runtime is native Rust; here the TPU
compute path is JAX/XLA and the host hot paths (WAL checksumming) are C++.
"""

from turdb_tpu_torch.native.build import crc64  # noqa: F401
