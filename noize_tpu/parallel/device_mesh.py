"""Device mesh construction for tile-batch (dp) and spatial (sp) sharding.

The reference is a single-process shared-memory engine (SURVEY.md §2.7);
its two parallel dimensions map to a JAX mesh as:

  * multi-tile parallelism (one LiveErosion per tile, sequential queue)
      → a ``batch`` mesh axis: tiles sharded across devices, each device
        running whole independent tiles (the reference's no-communication
        tile model, preserved);
  * one large grid split spatially (the margin-overlap decomposition)
      → ``x``/``y`` mesh axes: a single field sharded 2-D with halo
        exchange between devices replacing redundant margin recompute
        (BASELINE config #5).  The mesh follows the algorithm alone: on
        GPUs the collectives go through NCCL, and the cards of one host are
        joined all to all (NVLink).

tp/pp/ep have no analog in this domain — there are no weight tensors,
layer pipelines, or experts to shard; dp + sp are the real axes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _split2(n: int) -> Tuple[int, int]:
    """Most-square factorization of n (prefers wide x)."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def spatial_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """2-D ('x', 'y') mesh over all (or given) devices for sp sharding."""
    devices = list(devices if devices is not None else jax.devices())
    nx, ny = _split2(len(devices))
    return Mesh(np.array(devices).reshape(nx, ny), axis_names=("x", "y"))


def batch_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D ('batch',) mesh for dp tile sharding."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), axis_names=("batch",))


def hybrid_mesh(batch: int, devices: Optional[Sequence] = None) -> Mesh:
    """('batch', 'x', 'y') mesh: tile groups × spatial split within group."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    nx, ny = _split2(n // batch)
    return Mesh(
        np.array(devices).reshape(batch, nx, ny), axis_names=("batch", "x", "y")
    )


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a single (H, W) field over a spatial mesh."""
    return NamedSharding(mesh, P("x", "y"))


def tile_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a (T, H, W) tile stack over a batch mesh."""
    return NamedSharding(mesh, P("batch", None, None))
