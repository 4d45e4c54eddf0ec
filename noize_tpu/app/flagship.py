"""Flagship pipeline — the full tile step used by bench.py and
__graft_entry__.py.

This is the BASELINE.md headline workload: fused noise (Simplex fBm,
Hurst .4, 13 octaves) → Gauss-5 ×17 → flow map → erosion cycles → mesh
emission for one generator tile, all inside a single jit.  The reference
runs the same chain as a frame-spread JobHandle DAG
(SURVEY.md §3.2/§3.3); here it is one XLA program.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.tiles import TileSetMeta
from ..erosion.params import ErosionSettings
from ..erosion.sim import erosion_cycle, init_state
from ..ops import blur as _blur
from ..ops import flow as _flow
from ..ops import kernels as _kernels
from ..ops import mesh as _mesh
from ..ops.fractal import fractal


def default_meta(generator_res: int = 2048, margin: int = 16) -> TileSetMeta:
    tile = generator_res - 2 * margin
    return TileSetMeta(
        tile_res=tile, tile_size=tile, generator_res=generator_res,
        height=1000, margin=margin,
    ).validate()


def default_settings() -> ErosionSettings:
    """Reference default scale: 1000 particles/cycle, MAXAGE 100
    (ErosionSettings.cs:62-90)."""
    return ErosionSettings()


def _blur_chain(h, width: int, sigma: float, iterations: int):
    taps = jnp.asarray(_kernels.gaussian_taps(sigma, width))

    def body(_, a):
        return _kernels.separable_series(a, taps, taps, 1.0)

    return jax.lax.fori_loop(0, iterations, body, h)


def make_tile_step(
    meta: Optional[TileSetMeta] = None,
    settings: Optional[ErosionSettings] = None,
    *,
    octaves: int = 13,
    hurst: float = 0.4,
    noise_size: float = 1700.0,
    noise_type: str = "Simplex",
    blur_iterations: int = 17,
    flow_iterations: int = 8,
    erosion_cycles: int = 1,
    emit_mesh: bool = True,
    mesh_layout: str = "arrays",
):
    """Build the jittable flagship step: (xpos, zpos, key) → outputs dict."""
    meta = meta or default_meta()
    settings = settings or default_settings()
    if mesh_layout not in ("arrays", "planes"):
        raise ValueError(f"unknown mesh layout {mesh_layout!r}")
    res = meta.generator_res

    def step(xpos, zpos, key):
        h = fractal(
            res, xpos, zpos,
            noise_type=noise_type, hurst=hurst, octaves=octaves,
            noise_size=noise_size,
        )
        h = _blur_chain(h, 5, 1.0, blur_iterations)
        flow_v = _flow.flow_map(h, iterations=flow_iterations)
        state = init_state(h, key)
        for _ in range(erosion_cycles):
            state = erosion_cycle(state, settings, meta)
        out = {
            "height": state.world.height,
            "flow_velocity": flow_v,
            "pool": state.world.pool,
            "stream": state.world.flow,
        }
        if emit_mesh:
            # LiveErosion.ScheduleMeshUpdate parity: Resolution = TILE_RES,
            # margin samples read from the generator grid (LiveErosion.cs:302-315).
            # "planes" emits the component-major MeshPlanes layout (see
            # ops.mesh.MeshPlanes); "arrays" the (N, 3/4/2) MeshArrays SoA.
            mesher = (_mesh.heightmap_mesh_overshoot_planes
                      if mesh_layout == "planes"
                      else _mesh.heightmap_mesh_overshoot)
            out["mesh"] = mesher(
                state.world.height, meta.tile_res, res,
                float(meta.height), float(meta.tile_size),
            )
        return out

    return jax.jit(step), meta, settings
