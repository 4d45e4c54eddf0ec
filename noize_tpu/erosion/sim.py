"""Live erosion simulation — the per-tile interactive erosion loop.

Reference: ``LiveErosion`` (/root/reference/Geologic/ParticleErosion/
Component/LiveErosion.cs:29-543), cycle DAG ``TriggerQueuedBeyerMT``
(:378-436); see SURVEY.md §3.3 for the full call stack.

One ``erosion_cycle`` call is the reference's CYCLES-loop body, fully fused
in one jit:

  thermal erosion (4·THERMAL_CYCLES checkerboard passes)
  → spawn particles into free slots (random + queued pool-drain particles)
  → simultaneous masked descent over MAXAGE steps (scatter-add events)
  → per-cell event reduce: pool/track placement multipliers
  → sediment write-back (gaussian disperse / pile deposit + [0,1] breaker)
  → track→flow decay + pool surface evaporation
  → pool automata (WATER_STEPS × 4 phases), emitting drain water

Drain-particle respawn divergence (bounded-memory design): the reference
enqueues one particle per drain event into an unbounded queue consumed next
cycle; here drain water accumulates in a map and the next cycle's spawn
converts the top-K wettest drain cells into particles (K = particle slots),
filling remaining slots with fresh random particles.  Mass in dropped
drains beyond K re-enters as pool water instead of vanishing.

The ``ErosionSim`` host driver mirrors the LiveErosion component surface:
reset land/water, single/continuous stepping, save/restore via the state
store, map views for visualization.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp

from functools import lru_cache

from ..core.tiles import TileSetMeta
from ..ops.thermal import thermal_erosion
from .params import ErosionMode, ErosionSettings
from .particles import Particles, descend_all, spawn
from .pool import MIN_WATER, pool_automata
from .sediment import write_sediment_map
from .world import WorldState, update_flow_from_track, curvature_map

_F32 = jnp.float32


@lru_cache(maxsize=None)
def _gated_pool(iterations: int, drain_particles: bool):
    """Pool automata with a BATCH-level wetness gate.

    Unbatched, this is ``pool.pool_automata``, whose internal call-level
    gates already skip below-gate-dry grids bit-exactly (see
    pool.MIN_WATER).  Under ``vmap`` (the tile_batch serving path) those
    internal ``lax.cond`` gates degrade to ``select`` — both branches
    execute — so every batched cold-start tile would pay the full automata
    the solo flagship skips.  The ``custom_vmap`` rule restores a SCALAR
    any-tile-at-gate predicate around the mapped automata: an all-dry batch
    skips entirely (bit-exact — each below-gate tile is a fixed point of
    the automata, returning (pool, 0) exactly as the unbatched gate does);
    a mixed batch runs the automata for all tiles, which is what vmap would
    have done anyway.  Reference parity for the gate threshold:
    SpreadPool's per-cell ``hWater < 1E-3f continue``
    (LiveErosionDataTypes.cs:972)."""

    def raw(height, pool):
        return pool_automata(
            height, pool, iterations=iterations,
            drain_particles=drain_particles,
        )

    vf = jax.custom_batching.custom_vmap(raw)

    @vf.def_vmap
    def _rule(axis_size, in_batched, height, pool):
        h_b, p_b = in_batched

        def wet(hp):
            h, p = hp
            out = jax.vmap(
                raw, in_axes=(0 if h_b else None, 0 if p_b else None)
            )(h, p)
            return out

        def dry(hp):
            _, p = hp
            if not p_b:
                p = jnp.broadcast_to(p[None], (axis_size,) + p.shape)
            return p, jnp.zeros_like(p)

        out = jax.lax.cond(
            jnp.any(pool >= MIN_WATER), wet, dry, (height, pool)
        )
        return out, (True, True)

    return vf


@jax.tree_util.register_dataclass
@dataclass
class SimState:
    """Device-side sim state carried across cycles."""

    world: WorldState
    drain_water: Any   # f32[R,R] — queued drain emissions for next cycle
    key: Any           # PRNG key


def init_state(height, key=None) -> SimState:
    if key is None:
        key = jax.random.PRNGKey(0)
    return SimState(
        world=WorldState.create(height),
        drain_water=jnp.zeros_like(height),
        key=key,
    )


def _spawn_with_drains(key, n, res, drain_water):
    """Fill the particle buffer: drain particles first (top-K wettest drain
    cells), fresh random particles in the remaining slots.  The top-k
    search runs only when drains exist (lax.cond) — the common dry case is
    a pure random spawn."""
    k1, k2 = jax.random.split(key)
    flat = drain_water.reshape(-1)
    # spawn() leaves that are trace-time constants (water/sediment/age/…)
    # must carry drain_water's manual-mesh varying axes for the cond below
    # to type-check inside shard_map (tile_batch dp path); match_vma is a
    # numerical no-op and a complete no-op outside shard_map
    from ..utils.helpers import match_vma

    fresh = match_vma(spawn(k1, n, res), flat)

    def with_drains(flat):
        vals, idxs = jax.lax.top_k(flat, n)
        has_drain = vals > 0.0
        rows = (idxs // res).astype(_F32)
        cols = (idxs % res).astype(_F32)
        parts = Particles(
            row=jnp.where(has_drain, rows, fresh.row),
            col=jnp.where(has_drain, cols, fresh.col),
            heading=fresh.heading,
            vel=fresh.vel,
            water=jnp.where(has_drain, vals, fresh.water),
            sediment=fresh.sediment,
            age=fresh.age,
            alive=fresh.alive,
        )
        # water not converted to particles returns to the pool map
        taken = jnp.zeros_like(flat).at[idxs].add(
            jnp.where(has_drain, vals, 0.0))
        return parts, jnp.maximum(flat - taken, 0.0)

    def without_drains(flat):
        return fresh, flat

    parts, leftover = jax.lax.cond(
        jnp.any(flat > 0.0), with_drains, without_drains, flat
    )
    return parts, leftover.reshape(drain_water.shape), k2


@partial(
    jax.jit,
    static_argnames=("settings", "meta"),
)
def erosion_cycle(state: SimState, settings: ErosionSettings, meta: TileSetMeta,
                  tuned: Optional[dict] = None):
    """One full cycle of TriggerQueuedBeyerMT's inner loop
    (LiveErosion.cs:383-415).

    ``tuned``: optional dict of TUNABLE_FIELDS values passed as TRACED
    scalars (see params.py).  Callers who tune erosion live should pass
    ``settings.canonical()`` as the static settings and
    ``settings.tunable_values()`` here — slider tweaks then reuse the
    compiled cycle (ErosionSim does this).  With ``tuned=None`` every
    value is a trace-time constant (bit-identical compiled graph to the
    pre-split behavior)."""
    params = settings.as_parameters()
    if tuned is not None:
        params = replace(params, **{
            k: jnp.float32(v) for k, v in tuned.items()
        })
    res = meta.generator_res
    height_scale = float(meta.height)
    patch_res = meta.patch_res
    world = state.world
    behavior = settings.BEHAVIOR

    # 1. thermal (LiveErosion.cs:384-386)
    if settings.ENABLE_THERMAL and behavior != ErosionMode.ONLY_FLOW_WATER:
        world = replace(world, height=thermal_erosion(
            world.height, settings.TALUS, settings.THERMAL_STEP,
            float(meta.tile_size) / float(meta.height),
            iterations=settings.THERMAL_CYCLES,
        ))

    drain_water = state.drain_water
    key = state.key

    if behavior != ErosionMode.ONLY_FLOW_WATER:
        # 2. spawn (FillBeyerQueueJob) — drains first, then fresh particles
        parts, drain_water, key = _spawn_with_drains(
            key, settings.PARTICLES_PER_CYCLE, res, drain_water
        )
        # unconverted drain water re-enters the pool map (see module note)
        world = replace(world, pool=world.pool + drain_water)
        drain_water = jnp.zeros_like(drain_water)

        # 3. descent (QueuedBeyerCycleMultiThreadJob)
        _, track_acc, pool_acc, sed_acc = descend_all(
            parts, world, params, height_scale, patch_res, res
        )

        # 4. event reduce (ProcessBeyerErosiveEventsJob → HandleBeyerEvent)
        world = replace(
            world,
            pool=world.pool + pool_acc * params.POOL_PLACEMENT_MULTIPLIER,
            track=world.track + track_acc * params.TRACK_PLACEMENT_MULTIPLIER,
        )

        # 5. sediment write-back (ErodeHeightMaps)
        world = replace(
            world,
            height=write_sediment_map(world.height, sed_acc, params, height_scale),
        )

    # 6. track → flow decay + surface evaporation (UpdateFlowFromTrackJob)
    world = update_flow_from_track(world, params, height_scale)

    # 7. pool automata (PoolAutomataJob); the _gated_pool wrapper adds a
    # batch-level wetness gate so the vmapped tile_batch path skips
    # all-dry batches the way the solo path does
    pool, drains = _gated_pool(
        settings.WATER_STEPS,
        behavior != ErosionMode.ONLY_FLOW_WATER,
    )(world.height, world.pool)
    world = replace(world, pool=pool)
    drain_water = drain_water + drains

    return SimState(world=world, drain_water=drain_water, key=key)


class ErosionSim:
    """Host driver with the LiveErosion component surface
    (Setup/Update/reset/save — LiveErosion.cs:203-372)."""

    def __init__(
        self,
        height,
        settings: Optional[ErosionSettings] = None,
        meta: Optional[TileSetMeta] = None,
        state_manager=None,
        tile_pos=(0, 0),
        seed: int = 0,
    ):
        self.settings = settings or ErosionSettings()
        res = int(height.shape[0])
        self.meta = meta or TileSetMeta(
            tile_res=res, tile_size=res, generator_res=res, height=1000, margin=0
        )
        self.state_manager = state_manager
        self.tile_pos = tuple(tile_pos)
        self.original_height = jnp.asarray(height, _F32)
        self.state = init_state(self.original_height, jax.random.PRNGKey(seed))
        self.cycle_count = 0

    # --- map views (LiveErosion MapType, :118-154) --------------------------

    @property
    def height_map(self):
        return self.state.world.height

    @property
    def pool_map(self):
        return self.state.world.pool

    @property
    def stream_map(self):
        return self.state.world.flow

    @property
    def plant_map(self):
        return self.state.world.plants

    def curvature(self):
        return curvature_map(
            self.state.world.height, float(self.meta.height), self.meta.patch_res
        )

    # --- stepping (LiveErosion.Update / TriggerQueuedBeyerMT) ---------------

    def _run_cycle(self):
        """Advance one erosion cycle — the single point subclasses (the
        spatially-sharded sim) swap for their cycle kernel; every driver
        method (step/trigger/update) routes through here.

        The static/traced split: the compiled cycle is keyed on
        ``settings.canonical()`` (structure only) while the tunable floats
        ride in as traced scalars — live-retuning ErosionSettings between
        steps (the reference's inspector-slider workflow,
        LiveErosion.cs:203-236) reuses the compiled graph."""
        self.state = erosion_cycle(
            self.state, self.settings.canonical(), self.meta,
            tuned=self.settings.tunable_values())
        self.cycle_count += 1

    def step(self, cycles: Optional[int] = None):
        """Run CYCLES erosion cycles (the reference schedules all CYCLES in
        one DAG per trigger)."""
        n = self.settings.CYCLES if cycles is None else cycles
        for _ in range(n):
            self._run_cycle()
        return self.state

    # --- continuous mode (LiveErosion.updateContinuous, :363-370) -----------

    def trigger(self):
        """Dispatch one CYCLES batch asynchronously; returns immediately.
        The JAX analog of TriggerQueuedBeyerMT + erosionJobCtl.TrackJob:
        dispatch is async, the tracker polls array readiness."""
        from ..utils.tracking import StandAloneJobHandler

        if not hasattr(self, "_job") or self._job is None:
            self._job = StandAloneJobHandler()
        if self._job.is_running:
            return False
        for _ in range(self.settings.CYCLES):
            self._run_cycle()
        self._job.track_job(self.state)
        return True

    def update(self, continuous: bool = True):
        """One frame tick: complete a finished batch and (in continuous
        mode) trigger the next — the LiveErosion.Update state machine."""
        job = getattr(self, "_job", None)
        if job is not None and job.is_running:
            if not job.job_complete():
                return "running"
            job.close_job()
            return "completed"
        if continuous:
            self.trigger()
            return "triggered"
        return "idle"

    # --- resets (LiveErosion.cs:267-294) ------------------------------------

    def reset_land(self):
        self.state = init_state(self.original_height, self.state.key)

    def reset_water(self):
        w = self.state.world
        z = jnp.zeros_like(w.pool)
        self.state = replace(
            self.state,
            world=replace(w, pool=z, flow=z, track=z),
            drain_water=jnp.zeros_like(self.state.drain_water),
        )

    # --- persistence (SaveErosionState, LiveErosion.cs:111-116) -------------

    def _buffer_name(self, alias: str) -> str:
        return self.meta.buffer_name(self.tile_pos, alias)

    def save_erosion_state(self):
        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        self.original_height = self.state.world.height
        sm = self.state_manager
        sm.set_buffer(self._buffer_name("TERRAIN_HEIGHT"), self.state.world.height)
        sm.set_buffer(self._buffer_name("PARTERO_WATERMAP_STREAM"), self.state.world.flow)
        sm.set_buffer(self._buffer_name("PARTERO_WATERMAP_POOL"), self.state.world.pool)
        for alias in ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL"):
            sm.save_buffer_to_disk(self._buffer_name(alias))
