"""The device mesh (port of turdb_tpu/parallel/mesh.py).

The reference is single-controller: one process drives every device of a
`jax.sharding.Mesh`. The port is too: a `Mesh` is a numpy grid of
`torch.device`s with the reference's axis names. The sharded indexes
(parallel/sharded.py, parallel/sharded_ivf.py) keep each shard's state on
its device of the first row of the `data` axis, where writes land, and a
copy of it on every other row; a query batch is split over the rows, and
each row's shards answer its slice and merge their top-k on that row's
first device. A device may appear more than once: `[torch.device("cpu")]
* 8` stands in for the reference tests' eight virtual CPU devices,
`[cuda:0] * 4` for a 4-shard mesh on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH_AXIS_DB = "db"      # vector-store shard axis
MESH_AXIS_DATA = "data"  # query-batch data-parallel axis
MESH_AXIS_HOST = "host"  # cross-host shard axis, outermost


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices (numpy object array) and its axis names."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    def data_rows(self) -> list[list[torch.device]]:
        """[r][s]: the device of store shard s (host-major, then db) on row
        r of the data axis, `grid[host, r, db]`. Each row holds a copy of
        every shard and answers its slice of a query batch."""
        shape = self.shape
        grid = self.devices.reshape(shape.get(MESH_AXIS_HOST, 1), shape.get(MESH_AXIS_DATA, 1),
                                    shape[MESH_AXIS_DB])
        return [list(grid[:, r, :].reshape(-1)) for r in range(grid.shape[1])]

    def shard_devices(self) -> list[torch.device]:
        """The device of each store shard on the first row of the data axis,
        where the shard's state is written."""
        return self.data_rows()[0]


def _devices(devices) -> list[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8) to build a mesh elsewhere")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_db: int | None = None, n_data: int = 1, devices=None) -> Mesh:
    """A (data, db) mesh. `db` shards the vector store / graph; `data`
    splits query batches. Defaults to every visible CUDA device on the db
    axis; raises when none is visible and `devices` is not given."""
    devices = _devices(devices)
    if n_db is None:
        n_db = len(devices) // n_data
    if n_db < 1 or n_db * n_data > len(devices):
        raise ValueError(f"need {n_db * n_data} devices, have {len(devices)}")
    grid = np.empty(n_db * n_data, dtype=object)
    grid[:] = devices[: n_db * n_data]
    return Mesh(grid.reshape(n_data, n_db), (MESH_AXIS_DATA, MESH_AXIS_DB))


def make_multihost_mesh(n_host: int, n_db: int, n_data: int = 1, devices=None) -> Mesh:
    """A (host, data, db) mesh: the store shards over host x db, and the
    sharded indexes merge twice, over db within a host and then over host,
    so only [B, k] per host crosses the host axis."""
    devices = _devices(devices)
    need = n_host * n_db * n_data
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_host, n_data, n_db),
                (MESH_AXIS_HOST, MESH_AXIS_DATA, MESH_AXIS_DB))
