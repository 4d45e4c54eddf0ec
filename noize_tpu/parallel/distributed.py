"""Multi-host initialization and meshes.

The reference is single-process shared memory (SURVEY.md §2.7); its
"distributed communication backend" row maps to JAX's runtime: device
collectives inside one host (parallel.halo), ``jax.distributed`` across
hosts over the network.  This module is the multi-host entry point:
initialize the runtime, build meshes whose *inner* axes stay inside a host
(halo exchange, tile groups) while only the outer tile-batch axis crosses
hosts — tiles are independent, so cross-host traffic stays at
orchestration scale.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """jax.distributed.initialize wrapper; no-op when single-process (env
    unset).  Call before any jax usage on every host."""
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def multihost_tile_mesh() -> Mesh:
    """('host', 'batch') mesh: the host axis crosses hosts (independent
    tiles only), the batch axis = intra-host devices."""
    n_local = jax.local_device_count()
    devices = np.array(jax.devices()).reshape(-1, n_local)
    return Mesh(devices, axis_names=("host", "batch"))


def multihost_spatial_mesh() -> Mesh:
    """('host', 'x', 'y'): one spatial field per host group; halo exchange
    stays among a host's devices, hosts own independent fields."""
    n_local = jax.local_device_count()
    nx = int(np.floor(np.sqrt(n_local)))
    while n_local % nx:
        nx -= 1
    devices = np.array(jax.devices()).reshape(-1, nx, n_local // nx)
    return Mesh(devices, axis_names=("host", "x", "y"))


def is_primary() -> bool:
    return jax.process_index() == 0
