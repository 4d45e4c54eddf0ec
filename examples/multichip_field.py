"""Multi-device terrain field: one large grid sharded over a 2-D device
mesh with halo exchange (sp), plus a tile batch sharded over devices
(dp).

Run on N virtual devices:
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/multichip_field.py
"""

import os
import time

import jax
import numpy as np

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# Persistent compile cache (noize_tpu.utils.compile_cache): without it
# every example invocation re-pays its compiles
from noize_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.parallel import device_mesh as DM
from noize_tpu.parallel import sharded_ops as SO
from noize_tpu.parallel import tiled as TL


def main(ckpt_dir="out/sharded_ckpt"):
    print("devices:", jax.devices())
    mesh = DM.spatial_mesh()
    res = 256 if FAST else 1024
    octaves, blur_iters, flow_iters = (4, 3, 4) if FAST else (13, 17, 8)

    t0 = time.perf_counter()
    h = SO.sharded_fractal(mesh, res, 0, 0, noise_type="Simplex",
                           octaves=octaves, hurst=0.4, noise_size=1700.0)
    h = SO.sharded_gauss_blur(mesh, h, 5, 1.0, iterations=blur_iters)
    h = SO.sharded_thermal_erosion(mesh, h, 45.0, 0.5, 1.0, iterations=2)
    v = SO.sharded_flow_map(mesh, h, iterations=flow_iters)
    v.block_until_ready()
    print(f"sp path: {res}² field over {mesh.shape} mesh "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms; "
          f"velocity range [{float(v.min()):.3f}, {float(v.max()):.3f}]")


    # full sharded erosion: the COMPLETE cycle (particles, pools, sediment)
    # on the sharded field — parallel.sharded_erosion
    from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

    t0 = time.perf_counter()
    sim = ShardedErosionSim(
        mesh, np.asarray(h),
        settings=ErosionSettings(
            PARTICLES_PER_CYCLE=64 if FAST else 256,
            MAXAGE=8 if FAST else 24,
            WATER_STEPS=2 if FAST else 4, CYCLES=1,
            PILING_RADIUS=4 if FAST else 8),
        meta=TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                         height=1000, margin=0),
    )
    sim.step(2)
    sim.height_map.block_until_ready()
    print(f"sp erosion: 2 full cycles on the sharded {res}\u00b2 field "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    # per-shard mesh emission off the eroded sharded world (round 3):
    # each shard computes its own renderable vertex block; triangles come
    # in global or block-local uint32 ids
    from noize_tpu.parallel.sharded_mesh import (mesh_arrays_from_fields,
                                                 shard_mesh_indices)

    t0 = time.perf_counter()
    fields = sim.mesh_fields()
    fields["positions"].block_until_ready()
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    marr = mesh_arrays_from_fields(fields, res, res, (nx, ny))
    tris = shard_mesh_indices(res, res, (nx, ny), local=True)
    print(f"sp mesh: {marr.vertex_count} verts emitted per-shard in "
          f"{(time.perf_counter()-t0)*1e3:.0f}ms; "
          f"shard (0,0) renders {tris[(0, 0)].size // 3} triangles locally")

    # sharded checkpoint/resume (round 3): persists the full sim state
    from noize_tpu.core.store import PipelineStateManager

    sim.state_manager = PipelineStateManager(ckpt_dir)
    sim.save_erosion_state()
    sim2 = ShardedErosionSim(
        mesh, np.zeros((res, res), np.float32), settings=sim.settings,
        meta=sim.meta, state_manager=PipelineStateManager(ckpt_dir))
    sim2.restore_erosion_state()
    same = bool(np.array_equal(np.asarray(sim2.height_map),
                               np.asarray(sim.height_map)))
    print(f"sp checkpoint: saved + restored bit-equal: {same}")
    assert same, "sharded checkpoint restore mismatch"

    bmesh = DM.batch_mesh()
    n = len(jax.devices())
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8)
        cfg_es = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                                 CYCLES=1, WATER_STEPS=2, PILING_RADIUS=4)
        octaves, blur_iters = 4, 2
    else:
        meta = TileSetMeta(tile_res=96, tile_size=96, generator_res=128,
                           height=1000, margin=16)
        cfg_es = ErosionSettings(PARTICLES_PER_CYCLE=200, MAXAGE=24,
                                 CYCLES=1, WATER_STEPS=4)
        octaves, blur_iters = 8, 5
    cfg = TL.TilePipelineConfig(
        meta=meta, octaves=octaves, noise_size=900.0,
        blur_iterations=blur_iters, erosion=cfg_es,
        erosion_cycles=1,
    )
    origins = TL.grid_origins(meta, n, 1)
    t0 = time.perf_counter()
    tiles = TL.tile_batch(cfg, origins, mesh=bmesh)
    tiles.block_until_ready()
    print(f"dp path: {n} full tiles (noise+blur+erosion) sharded over "
          f"{n} devices in {(time.perf_counter()-t0)*1e3:.0f}ms; "
          f"shape {tiles.shape}")


if __name__ == "__main__":
    main()
