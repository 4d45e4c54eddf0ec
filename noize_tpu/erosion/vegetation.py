"""Vegetation layer — plant spawning/survival over the erosion world.

Reference: ``PlantType``/``Plant`` (/root/reference/Geologic/ParticleErosion/
Vegetation.cs:27-90).  The reference marks this WIP: ``Grow`` is empty and
only the ``plants`` density map feeds back into the sim (as a friction
modifier).  We implement the full spawn-survival surface, vectorized:
instead of per-plant rejection-sampling loops, survival is evaluated for a
whole batch of candidate positions at once, and a density splat mirrors
``ChangeVegetationDensity`` (LiveErosionDataTypes.cs:888-936: +1 at the
cell, +0.6 on the 4 axes, +0.4 on the diagonals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..ops.flow import shift_clamped
from .world import WorldState, normal_map

_F32 = jnp.float32


@dataclass(frozen=True)
class PlantType:
    """Vegetation.cs:27-35 — survival thresholds."""

    type_idx: int = 0
    density_modifier: float = 1.0
    max_angle: float = 1.0          # max normal.y (un-normalized 4-cross sum)
    spawn_range: float = 1.0
    max_density: float = 1.0
    max_pool_survival: float = 1e-4
    max_stream_survival: float = 0.5
    max_spawn_attempts: int = 8


class Plants(NamedTuple):
    """SoA Plant records (Vegetation.cs:83-90)."""

    type_idx: Any   # i32[N]
    growth: Any     # i32[N] of 100
    row: Any        # i32[N]
    col: Any        # i32[N]
    height: Any     # f32[N] cached for change detection
    alive: Any      # bool[N]


def can_survive(ptype: PlantType, state: WorldState, height_scale, patch_res):
    """CanSurvive (Vegetation.cs:65-78) for every cell at once: density,
    pool, stream and slope gates."""
    n = normal_map(state, height_scale, patch_res)
    ok = state.plants <= ptype.max_density
    ok &= state.pool <= ptype.max_pool_survival
    ok &= state.flow <= ptype.max_stream_survival
    ok &= n[..., 1] <= ptype.max_angle
    return ok


def root_plants(key, ptype: PlantType, state: WorldState, n: int,
                height_scale, patch_res):
    """Root (Vegetation.cs:37-59) vectorized: sample max_spawn_attempts
    candidate positions per plant, keep the first survivable one."""
    res = state.height.shape[0]
    attempts = ptype.max_spawn_attempts
    kr, kc = jax.random.split(key)
    rows = jax.random.randint(kr, (n, attempts), 0, res)
    cols = jax.random.randint(kc, (n, attempts), 0, res)
    ok_map = can_survive(ptype, state, height_scale, patch_res)
    ok = ok_map[rows, cols]                       # [n, attempts]
    first = jnp.argmax(ok, axis=1)                 # first True (0 if none)
    any_ok = jnp.any(ok, axis=1)
    row = jnp.take_along_axis(rows, first[:, None], 1)[:, 0]
    col = jnp.take_along_axis(cols, first[:, None], 1)[:, 0]
    return Plants(
        type_idx=jnp.full((n,), ptype.type_idx, jnp.int32),
        growth=jnp.full((n,), 20, jnp.int32),
        row=row,
        col=col,
        height=state.height[row, col],
        alive=any_ok,
    )


def splat_density(plants_map, plants: Plants, magnitude=1.0):
    """ChangeVegetationDensity (LiveErosionDataTypes.cs:888-936): +1·mag at
    the plant cell, +0.6·mag on the 4-neighborhood, +0.4·mag diagonals —
    with the reference's clamped border indexing."""
    res = plants_map.shape[0]
    stamp = jnp.zeros_like(plants_map)
    m = jnp.where(plants.alive, magnitude, 0.0).astype(_F32)
    stamp = stamp.at[plants.row, plants.col].add(m)
    out = plants_map + stamp
    for w, offs in (
        (0.6, ((1, 0), (0, 1), (-1, 0), (0, -1))),
        (0.4, ((1, 1), (-1, 1), (1, -1), (-1, -1))),
    ):
        for dr, dc in offs:
            r = jnp.clip(plants.row + dr, 0, res - 1)
            c = jnp.clip(plants.col + dc, 0, res - 1)
            out = out.at[r, c].add(m * w)
    return out


def grow(plants: Plants, state: WorldState) -> Plants:
    """Grow is a no-op in the reference (Vegetation.cs:61-63) — kept for
    surface parity; kills plants whose ground moved (the cached-height
    change-detection hook the Plant struct carries)."""
    current = state.height[plants.row, plants.col]
    still = plants.alive & (jnp.abs(current - plants.height) < 1e-3)
    return plants._replace(alive=still)


def grow_cycle(key, plants: Plants, state: WorldState, ptype: PlantType,
               height_scale, patch_res, *,
               moisture_gain: int = 10, drought_loss: int = 4,
               erosion_shock: int = 10, mature_at: int = 80) -> Plants:
    """Beyond-parity growth/decay cycle (the reference's Grow is an empty
    stub — Vegetation.cs:61-63; this is this framework's extension of
    the surface the Plant struct clearly reaches for).

    Per cycle, vectorized over all plant slots:
      * environment cull — plants drown in pools, wash out in streams,
        slide off slopes (the same gates CanSurvive applies at rooting);
      * moisture — growth rises by ``moisture_gain`` (of 100) on cells
        where water trafficked this cycle (track > 0), falls by
        ``drought_loss`` otherwise; reaching 0 kills the plant;
      * erosion shock — ground moving under a plant (cached height
        mismatch) costs ``erosion_shock`` growth instead of outright death;
      * reproduction — dead slots re-root as seedlings (growth 20) next to
        a random mature donor (growth ≥ ``mature_at``), jittered within
        ``spawn_range``, subject to CanSurvive incl. the density cap.

    Returns the updated Plants; rebuild the density map from it with
    ``density_map``."""
    res = state.height.shape[0]
    nslots = plants.row.shape[0]
    n = normal_map(state, height_scale, patch_res)
    env_ok = (
        (state.pool <= ptype.max_pool_survival)
        & (state.flow <= ptype.max_stream_survival)
        & (n[..., 1] <= ptype.max_angle)
    )

    cur_height = state.height[plants.row, plants.col]
    alive = plants.alive & env_ok[plants.row, plants.col]
    moist = state.track[plants.row, plants.col] > 0.0
    growth = plants.growth + jnp.where(moist, moisture_gain, -drought_loss)
    growth = growth - jnp.where(
        jnp.abs(cur_height - plants.height) >= 1e-3, erosion_shock, 0
    )
    growth = jnp.clip(growth, 0, 100)
    alive = alive & (growth > 0)

    # reproduction into freed slots
    kd, kr, kc = jax.random.split(key, 3)
    spawn = max(1, int(ptype.spawn_range))
    donor = jax.random.randint(kd, (nslots,), 0, nslots)
    d_mature = alive[donor] & (growth[donor] >= mature_at)
    cand_r = jnp.clip(
        plants.row[donor] + jax.random.randint(kr, (nslots,), -spawn, spawn + 1),
        0, res - 1,
    )
    cand_c = jnp.clip(
        plants.col[donor] + jax.random.randint(kc, (nslots,), -spawn, spawn + 1),
        0, res - 1,
    )
    root_ok = (
        d_mature
        & env_ok[cand_r, cand_c]
        & (state.plants[cand_r, cand_c] <= ptype.max_density)
    )
    seeded = ~alive & root_ok
    row = jnp.where(seeded, cand_r, plants.row)
    col = jnp.where(seeded, cand_c, plants.col)
    growth = jnp.where(seeded, 20, growth)
    alive = alive | seeded
    return Plants(
        type_idx=plants.type_idx,
        growth=growth,
        row=row,
        col=col,
        height=state.height[row, col],
        alive=alive,
    )


def density_map(shape, plants: Plants, ptype: PlantType):
    """Rebuild the world's plant-density map from the plant set: each
    plant splats ChangeVegetationDensity's stamp scaled by its growth
    fraction and the type's density modifier."""
    mag = (plants.growth.astype(_F32) / 100.0) * ptype.density_modifier
    return splat_density(jnp.zeros(shape, _F32), plants, magnitude=mag)
