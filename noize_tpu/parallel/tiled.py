"""Multi-tile generation — the MeshTileGenerator workload at device scale.

Reference model (SURVEY.md §2.7): tiles are fully independent; the only
"communication" is margin overlap so neighbors agree.  Device mapping:

  * ``tile_batch``: a (T,) stack of tile requests batched on one chip or
    sharded P('batch') across the mesh — each device runs whole tiles
    (noise → filter chain → flow → erosion cycles → mesh heights).  This is
    the dp axis; tiles agree at seams for free because noise is world-
    position based (seam test in tests/test_parallel.py).
  * for the sp axis (one big field sharded spatially with halo exchange)
    see noize_tpu.parallel.sharded_ops.

Batching strategy: the stages want DIFFERENT batch lowerings.  Noise and
blur batch cleanly under ``vmap``, but vmapped particle descent makes the
all-dead early exit global (every tile runs to the slowest tile's trip
count).  So ``tile_batch`` vmaps the field stages and ``lax.map``s the
erosion stage; the unbatched erosion body also keeps the pool automata's
scalar wetness gate (no cond→select degradation).  Whether vmapped
descent wins on a GPU, where one tile's particles cannot fill the card,
is not measured yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.tiles import TileSetMeta
from ..erosion.params import ErosionSettings
from ..erosion.sim import erosion_cycle, init_state
from ..ops.fractal import fractal


@dataclass(frozen=True)
class TilePipelineConfig:
    """Static per-run config for the fused tile pipeline."""

    meta: TileSetMeta
    noise_type: str = "Simplex"
    hurst: float = 0.4
    octaves: int = 13
    stepdown: float = 2.0
    detune_rate: float = 0.0
    noise_size: float = 1700.0
    blur_width: int = 5
    blur_sigma: float = 1.0
    blur_iterations: int = 17
    flow_iterations: int = 0          # 0 = keep heights (flow overwrites them)
    erosion: Optional[ErosionSettings] = None
    erosion_cycles: int = 0
    emit_mesh: bool = False           # also emit per-tile vertex planes


def _tile_height(cfg: TilePipelineConfig, xpos, zpos):
    """Field stages of one tile: noise → blur chain → optional flow map."""
    from ..ops import blur as _b
    from ..ops import flow as _f

    res = cfg.meta.generator_res
    h = fractal(
        res, xpos, zpos,
        noise_type=cfg.noise_type, hurst=cfg.hurst, octaves=cfg.octaves,
        stepdown=cfg.stepdown, detune_rate=cfg.detune_rate,
        noise_size=cfg.noise_size,
    )
    for _ in range(cfg.blur_iterations):
        h = _b.gauss_blur(h, cfg.blur_width, cfg.blur_sigma)
    if cfg.flow_iterations:
        h = _f.flow_map(h, iterations=cfg.flow_iterations)
    return h


def _tile_erode(cfg: TilePipelineConfig, h, key):
    """Erosion stage of one tile: cfg.erosion_cycles particle cycles."""
    state = init_state(h, key)
    for _ in range(cfg.erosion_cycles):
        state = erosion_cycle(state, cfg.erosion, cfg.meta)
    return state.world.height


def _tile_mesh_planes(cfg: TilePipelineConfig, h):
    """Mesh stage of one tile: component-major vertex planes."""
    from ..ops import mesh as _m

    res = cfg.meta.generator_res
    planes = _m.heightmap_mesh_overshoot_planes(
        h, cfg.meta.tile_res, res, float(cfg.meta.height),
        float(cfg.meta.tile_size))
    return planes.planes


def generate_tile(cfg: TilePipelineConfig, xpos, zpos, key):
    """One tile end-to-end on device: noise → blur chain → (flow | erosion)
    → mesh-ready heights.  Pure function of (origin, key).

    With ``cfg.emit_mesh`` returns ``{"height": f32[R, R], "mesh_planes":
    f32[12, tile_res+1, tile_res+1]}`` — the component-major vertex streams
    (ops.mesh.MeshPlanes planes; batching adds the batch axis in FRONT, so
    the vertex grid stays on the minor dims).  Triangle indices
    are identical for every tile: take them once from
    ``ops.mesh.grid_indices(cfg.meta.tile_res)``."""
    h = _tile_height(cfg, xpos, zpos)
    if cfg.erosion is not None and cfg.erosion_cycles > 0:
        h = _tile_erode(cfg, h, key)
    if cfg.emit_mesh:
        return {"height": h, "mesh_planes": _tile_mesh_planes(cfg, h)}
    return h


def _local_batch(cfg: TilePipelineConfig, xs, zs, keys):
    """Batch of whole tiles on ONE device: vmap the field stages,
    ``lax.map`` the erosion stage (see module docstring for the measured
    rationale), vmap the mesh emission."""
    h = jax.vmap(lambda x, z: _tile_height(cfg, x, z))(xs, zs)
    if cfg.erosion is not None and cfg.erosion_cycles > 0:
        if h.shape[0] == 1:
            # a 1-tile batch needs no lax.map scan wrapper — run the
            # erosion body directly
            h = _tile_erode(cfg, h[0], keys[0])[None]
        else:
            h = jax.lax.map(
                lambda hk: _tile_erode(cfg, hk[0], hk[1]), (h, keys))
    if cfg.emit_mesh:
        planes = jax.vmap(lambda v: _tile_mesh_planes(cfg, v))(h)
        return {"height": h, "mesh_planes": planes}
    return h


@lru_cache(maxsize=None)
def _batched_fn(cfg: TilePipelineConfig, mesh: Optional[Mesh]):
    """Jitted batched-tile executable for (cfg, mesh) — cached so repeated
    serving calls (app.server.TileServer) reuse the trace instead of
    re-tracing a fresh lambda per request."""
    if mesh is None:
        return jax.jit(partial(_local_batch, cfg))

    # one shard_map program: each device runs the hybrid local batch on its
    # own whole tiles — dp scaling stays a data split, never a partitioned
    # scan (lax.map over a sharded axis would serialize globally)
    fn = shard_map(
        partial(_local_batch, cfg),
        mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch", None)),
        out_specs=(
            {"height": P("batch", None, None),
             "mesh_planes": P("batch", None, None, None)}
            if cfg.emit_mesh else P("batch", None, None)
        ),
    )
    return jax.jit(fn)


def tile_batch(cfg: TilePipelineConfig, origins: np.ndarray,
               mesh: Optional[Mesh] = None, seed: int = 0):
    """Generate a stack of tiles; batched on one device, or sharded
    P('batch') over a mesh when given (whole tiles per device).

    ``origins``: int array [T, 2] of (xpos, zpos) tile origins.  On the
    sharded path T must divide evenly over ``mesh.shape['batch']`` (each
    device runs whole tiles).
    Returns f32[T, R, R] heightmaps, or (with ``cfg.emit_mesh``) a dict
    {"height": f32[T, R, R], "mesh_planes": f32[T, 12, tr+1, tr+1]}.

    Per-tile PRNG keys are derived from the tile's WORLD POSITION
    (``fold_in(fold_in(key(seed), xpos), zpos)``), not its batch slot, so a
    tile's content is a pure function of (origin, seed) — the same tile
    re-requested later, or landing in a different batch, reproduces
    bit-identically on the CPU (generate_tile's purity contract).  On a
    GPU the particle-descent scatter-adds accumulate duplicate cells in a
    run-dependent order, so a re-requested tile agrees only to float32
    rounding (one H100: a few cells in a million differ, by about an ulp).
    """
    base = jax.random.PRNGKey(seed)
    oi = jnp.asarray(origins, jnp.int32)
    keys = jax.vmap(
        lambda o: jax.random.fold_in(jax.random.fold_in(base, o[0]), o[1])
    )(oi)
    xs = jnp.asarray(origins[:, 0], jnp.float32)
    zs = jnp.asarray(origins[:, 1], jnp.float32)

    if mesh is None:
        return _batched_fn(cfg, None)(xs, zs, keys)

    nb = mesh.shape["batch"]
    if len(origins) % nb != 0:
        raise ValueError(
            f"tile_batch: {len(origins)} tiles do not divide over the "
            f"{nb}-device 'batch' mesh axis — pad the request to a "
            f"multiple of {nb} (whole tiles per device)")
    sharding = NamedSharding(mesh, P("batch"))
    xs = jax.device_put(xs, sharding)
    zs = jax.device_put(zs, sharding)
    keys = jax.device_put(keys, NamedSharding(mesh, P("batch", None)))
    return _batched_fn(cfg, mesh)(xs, zs, keys)


def grid_origins(meta: TileSetMeta, nx: int, nz: int) -> np.ndarray:
    """Tile origins for an nx × nz tile grid (DemoTileGenerator enqueue
    pattern — BasicDemo~/DemoTileGenerator.cs:12-19)."""
    out = []
    for z in range(nz):
        for x in range(nx):
            out.append(meta.tile_origin((x, z)))
    return np.asarray(out, np.int32)
