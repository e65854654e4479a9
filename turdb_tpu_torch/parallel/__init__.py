"""The mesh: one logical index over several shards (port of
turdb_tpu/parallel/). A `Mesh` is a grid of torch devices with the
reference's axis names (host, data, db); the sharded indexes keep one
state per shard on its device, search every shard and merge their top-k
with K2. One process drives every shard, as the reference's single
controller drives every device of its `jax.sharding.Mesh`."""

from turdb_tpu_torch.parallel.mesh import Mesh, make_mesh, make_multihost_mesh  # noqa: F401
from turdb_tpu_torch.parallel.sharded import ShardedHnswIndex  # noqa: F401
from turdb_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex  # noqa: F401
