"""End-to-end tile workflow — the MeshTileGenerator user journey.

Generates a 2x2 tile grid (noise → blur → context store), live-erodes each
tile for a few cycles, re-meshes, exports PNGs and a checkpoint, then
restores the checkpoint in a fresh store and renders it with TileDrawer.

Run:  python examples/full_tile_workflow.py [outdir]
(CPU: prefix with  JAX_PLATFORMS=cpu)
"""

import os
import sys
import time

import numpy as np

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# Persistent compile cache (noize_tpu.utils.compile_cache): without it
# every example invocation re-pays its compiles
from noize_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from noize_tpu.app.drawers import StreamDrawer, TileDrawer
from noize_tpu.app.tile_generator import MeshTileGenerator
from noize_tpu.core.store import PipelineStateManager
from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.pipeline.driver import Pipeline
from noize_tpu.pipeline.stages import (
    NoiseStage, StageGaussianBlur, WriteGeneratorContextStage,
)


def main(outdir="out/full_tile"):
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8).validate()
        settings = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                                   CYCLES=1, WATER_STEPS=2, PILING_RADIUS=4)
        octaves, blur_iters = 4, 3
    else:
        meta = TileSetMeta(tile_res=192, tile_size=192, generator_res=256,
                           height=1000, margin=32).validate()
        settings = ErosionSettings(PARTICLES_PER_CYCLE=500, MAXAGE=48,
                                   CYCLES=2, WATER_STEPS=6)
        octaves, blur_iters = 13, 17
    sm = PipelineStateManager(outdir + "/saves", "island", "v1")
    source = Pipeline([
        NoiseStage(noiseType="Simplex", hurst=0.4, octaves=octaves,
                   noiseSize=1700),
        StageGaussianBlur(sigma="s1d00", width=5, iterations=blur_iters),
        WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
    ], state_manager=sm, name="generator")

    gen = MeshTileGenerator(source, meta=meta, state_manager=sm,
                            erosion_settings=settings)
    t0 = time.perf_counter()
    for z in range(2):
        for x in range(2):
            gen.enqueue(f"t{x}{z}", (x, z))
    gen.drain()
    print(f"generated {len(gen.children)} tiles "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    t0 = time.perf_counter()
    gen.step_erosion()
    print(f"eroded {len(gen.children)} tiles "
          f"({settings.CYCLES} cycles each) "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    for key, child in gen.children.items():
        child.erosion.save_erosion_state()
        StreamDrawer(child.erosion, meta).export(outdir, prefix=f"tile{child.request.pos}")
        print(f"{key}: mesh {child.mesh.vertex_count} verts, "
              f"streams {float(np.asarray(child.erosion.stream_map).sum()):.1f}")

    # restore in a fresh store and draw from disk only
    sm2 = PipelineStateManager(outdir + "/saves", "island", "v1")
    paths = TileDrawer(sm2, meta, tile_pos=(0, 0)).draw(outdir, "restored_00")
    print("restored + drew from checkpoint:", paths)


if __name__ == "__main__":
    main(*sys.argv[1:])
