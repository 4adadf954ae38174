"""Device-mesh helpers for multi-chip runs.

The reference's only parallelism is OpenMP threads over particles
(SURVEY.md §2); the device-native equivalent is a 1-D `jax.sharding.Mesh`
over the Hilbert-sorted particle axis.  The production sharded WVT
iteration (block-sparse neighbour engine + SPH density solve +
displacement under `shard_map`, with all_gather/psum/pmax collectives)
lives in `parallel.wvt_shard`.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, ("parts",))
