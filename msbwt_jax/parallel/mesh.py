"""Device mesh helpers.

One logical axis ``"shard"`` carries both the BWT-position sharding (query
side) and the read-batch sharding (build side). On multi-card hosts the axis
spans the cards; tests force an 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

AXIS = "shard"


def default_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (AXIS,))
